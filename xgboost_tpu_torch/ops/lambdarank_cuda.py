"""LambdaMART top-k pair gradients: the query-group layout, the plain
version, and the wrapper of K5 (csrc/lambdarank.cu).

The reference computes rank:ndcg/pairwise/map gradients with the default
``lambdarank_pair_method="topk"`` in a native CPU kernel
(``native/xtb_kernels.h:997-1068``, ``xtb_lambdarank_topk_impl``): per
query group, a stable descending sort of the scores; each of the top
min(k, n) docs paired with every doc ranked below it; per pair the
LambdaGrad weights (glibc's ``expf``, ``|delta ndcg| / idcg``, the
score-difference norm, the 1e-16 floor, the doubled hessian); sequential
f32 sums in loop order; the per-group ``log2(1 + sum_lambda) /
sum_lambda`` rescale.  ``lambdarank_topk_plain`` is that algorithm in
PyTorch operations, bitwise the native kernel on any device, with
glibc's functions from ``utils/libm.py``; ``lambdarank_topk_cuda``
launches K5, which computes the same bits in one launch a call.
``lambdarank_topk`` sends a CPU tensor to the plain version and a CUDA
tensor to K5 (which raises if it cannot run).  Each launch is counted in
``hist_cuda.launches["lambdarank"]``.

The per-group sorts come from PyTorch's stable sort of one int64 key a
row: the group id above the order-preserving bits of the negated value,
with -0.0 taken as +0.0 and NaN last, as the reference's comparator sees
them (a radix sort on the card would put -0.0 first).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.libm import exp2f, expf, log2f
from .hist_cuda import launched, load_library, on_device

__all__ = ["GroupLayout", "lambdarank_topk", "lambdarank_topk_cuda",
           "lambdarank_topk_plain", "make_group_layout", "sorted_order"]

_I32_MAX = 2**31 - 1


def make_group_layout(group_ptr):
    """Host: CSR group_ptr -> padded (G, S) row-index matrix, its mask and
    the inverse map row -> flat g * S + s slot (the reference's
    objective/ranking.py:19-36, without its loop over groups)."""
    gp = np.asarray(group_ptr, np.int64)
    sizes = np.diff(gp)
    G = len(sizes)
    S = int(sizes.max()) if G else 1
    pos = np.arange(S)
    mask = pos[None, :] < sizes[:, None]
    idx = np.where(mask, gp[:-1, None] + pos[None, :], 0).astype(np.int32)
    rows = np.arange(int(gp[-1]))
    g = np.repeat(np.arange(G), sizes)
    inv = (g * S + rows - gp[:-1][g]).astype(np.int32)
    return idx, mask, inv


class GroupLayout:
    """A training matrix's query groups on one device: ``gptr`` (G + 1,)
    int32, ``sizes`` (G,), ``gid`` (r_g,) int64 the group of each grouped
    row, ``disc`` (S,) f32, 1 / log2f(2 + p) for the largest group's size
    S (made once, by utils/libm), and, for the plain version and the mean
    pair method, ``make_group_layout``'s ``pidx`` (G, S) row index (0 in
    the padding) and ``vpos`` mask, made on first use."""

    def __init__(self, group_ptr, device):
        self.group_ptr = np.asarray(group_ptr, np.int64)
        gp = self.group_ptr
        self.G = len(gp) - 1
        self.r_g = int(gp[-1]) if len(gp) else 0
        self.S = int(np.diff(gp).max()) if self.G else 1
        dev = torch.device(device)
        self.gptr = torch.from_numpy(gp.astype(np.int32)).to(dev)
        self.sizes = torch.diff(self.gptr.to(torch.int64))
        self.gid = torch.repeat_interleave(
            torch.arange(self.G, device=dev), self.sizes,
            output_size=self.r_g)
        p = torch.arange(self.S, device=dev)
        two = torch.full((self.S,), 2.0, dtype=torch.float32, device=dev)
        self.disc = torch.div(torch.ones_like(two),
                              log2f(two + p.to(torch.float32)))

    @functools.cached_property
    def _padded(self):
        idx, mask, _ = make_group_layout(self.group_ptr)
        dev = self.gptr.device
        return (torch.from_numpy(idx.astype(np.int64)).to(dev),
                torch.from_numpy(mask).to(dev))

    @property
    def pidx(self):
        return self._padded[0]

    @property
    def vpos(self):
        return self._padded[1]


def _desc_bits(v):
    """Order-preserving int64 bits of -v: -0.0 as +0.0, NaN last."""
    neg = -v.to(torch.float32)
    neg = torch.where(neg == 0, torch.zeros_like(neg), neg)
    neg = torch.where(torch.isnan(neg), torch.full_like(neg, float("nan")),
                      neg)
    b = neg.view(torch.int32).to(torch.int64)
    return torch.where(b < 0, (~b) & 0xFFFFFFFF, (b & 0xFFFFFFFF) | 2**31)


def sorted_order(v, gid):
    """The rows of each group in a stable descending sort of ``v`` (r_g,)
    f32, groups in order: (r_g,) int64 row indices."""
    key = (gid << 32) | _desc_bits(v)
    return torch.sort(key, stable=True).indices


def lambdarank_topk_plain(s, y, layout: GroupLayout, k: int,
                          ndcg_weight: bool, score_norm: bool,
                          group_norm: bool):
    """The native kernel's (grad, hess) as (R, 1, 2) f32, in PyTorch
    operations: sorted positions padded to (G, S); the pair terms of top
    position i with every j > i at once, one i at a time; each sum
    sequential in the native loop's order (j's terms as the j of a pair
    arrive row by row; i's terms as the i, and sum_lambda, over j in a
    loop of one addition a column)."""
    R = s.shape[0]
    dev = s.device
    out = torch.zeros((R, 1, 2), dtype=torch.float32, device=dev)
    G, S, r_g = layout.G, layout.S, layout.r_g
    if G == 0 or r_g == 0:
        return out
    s = s.to(torch.float32)
    y = y.to(torch.float32)
    order = sorted_order(s[:r_g], layout.gid)
    ideal = sorted_order(y[:r_g], layout.gid)
    vpos, sizes, disc = layout.vpos, layout.sizes, layout.disc
    rows = order[layout.pidx]
    s_srt = s[rows]
    gain = exp2f(y[rows]) - 1.0
    prod = torch.where(vpos, (exp2f(y[ideal[layout.pidx]]) - 1.0)
                       * disc[None, :], torch.zeros_like(s_srt))
    idcg = torch.zeros(G, dtype=torch.float32, device=dev)
    for c in range(S):
        idcg = idcg + prod[:, c]
    idcg = torch.where(idcg < 1e-10, torch.full_like(idcg, 1e-10), idcg)
    last = s_srt.gather(1, torch.clamp(sizes - 1, min=0)[:, None])[:, 0]
    spread = (s_srt[:, 0] != last)[:, None]
    kk = torch.clamp(sizes, max=k)
    lam_acc = torch.zeros((G, S), dtype=torch.float32, device=dev)
    hess_acc = torch.zeros_like(lam_acc)
    sum_lam = torch.zeros(G, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    for i in range(min(k, S - 1)):
        gi, si = gain[:, i:i + 1], s_srt[:, i:i + 1]
        gj, sj = gain[:, i + 1:], s_srt[:, i + 1:]
        valid = ((kk > i)[:, None] & vpos[:, i + 1:] & (gi != gj))
        high_is_i = gi > gj
        s_high = torch.where(high_is_i, si, sj)
        s_low = torch.where(high_is_i, sj, si)
        diff = s_high - s_low
        sig = torch.div(one, 1.0 + expf(-diff))
        delta = torch.ones_like(sig)
        if ndcg_weight:
            delta = torch.abs((gi - gj) * (disc[i] - disc[i + 1:])[None, :]) \
                / idcg[:, None]
        if score_norm:
            delta = torch.where(spread, delta / (torch.abs(diff) + 0.01),
                                delta)
        lam = (sig - 1.0) * delta
        h = torch.clamp(sig * (1.0 - sig) * delta, min=1e-16) * 2.0
        zero = torch.zeros_like(lam)
        ls = torch.where(valid, torch.where(high_is_i, lam, -lam), zero)
        hv = torch.where(valid, h, zero)
        m2 = torch.where(valid, -2.0 * lam, zero)
        # j's terms as the j of the pair (i ascending, one row at a time)
        lam_acc[:, i + 1:] = lam_acc[:, i + 1:] - ls
        hess_acc[:, i + 1:] = hess_acc[:, i + 1:] + hv
        # i's terms as the i, and sum_lambda, over j ascending
        terms = torch.stack([ls, hv, m2])
        acc = torch.stack([lam_acc[:, i], hess_acc[:, i], sum_lam])
        for c in range(terms.shape[2]):
            acc = acc + terms[:, :, c]
        lam_acc[:, i], hess_acc[:, i], sum_lam = acc[0], acc[1], acc[2]
    norm = torch.ones_like(sum_lam)
    if group_norm:
        d = torch.where(sum_lam > 1e-16, sum_lam,
                        torch.full_like(sum_lam, 1e-16))
        norm = torch.where(sum_lam > 0, log2f(1.0 + sum_lam) / d, norm)
    pairs = torch.stack([lam_acc * norm[:, None], hess_acc * norm[:, None]],
                        dim=-1)
    out[rows[vpos], 0] = pairs[vpos]
    return out


def lambdarank_topk_cuda(s, y, layout: GroupLayout, k: int,
                         ndcg_weight: bool, score_norm: bool,
                         group_norm: bool):
    """Launch K5: what ``lambdarank_topk_plain`` computes, one block a
    group, on the inputs' card.  A launch the card refuses raises."""
    if not (s.is_cuda and y.is_cuda):
        raise ValueError("the lambdarank kernel needs CUDA tensors")
    if s.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError("scores and labels must be float32")
    R = s.shape[0]
    if s.dim() != 1 or tuple(y.shape) != (R,) or y.device != s.device \
            or layout.gptr.device != s.device:
        raise ValueError("scores and labels must be (R,) on the layout's "
                         "device")
    if layout.r_g > R:
        raise ValueError(f"the groups cover {layout.r_g} rows, over {R}")
    out = torch.zeros((R, 1, 2), dtype=torch.float32, device=s.device)
    if layout.G == 0 or layout.r_g == 0:
        return out
    s, y = s.contiguous(), y.contiguous()
    r_g = layout.r_g
    order = sorted_order(s[:r_g], layout.gid).to(torch.int32)
    ideal = sorted_order(y[:r_g], layout.gid).to(torch.int32)
    scratch = torch.empty((4, r_g), dtype=torch.float32, device=s.device)
    lib = load_library("lambdarank")
    rc = on_device(s.device, lib.xtb_lambdarank, s.data_ptr(), y.data_ptr(),
                   order.data_ptr(), ideal.data_ptr(), layout.gptr.data_ptr(),
                   layout.G, layout.disc.data_ptr(), min(int(k), _I32_MAX),
                   int(bool(ndcg_weight)), int(bool(score_norm)),
                   int(bool(group_norm)), scratch.data_ptr(), r_g,
                   out.data_ptr())
    launched("lambdarank", lib, rc)
    return out


def lambdarank_topk(s, y, layout: GroupLayout, k: int, ndcg_weight: bool,
                    score_norm: bool, group_norm: bool):
    """The top-k (grad, hess) pairs (R, 1, 2): the plain version for a CPU
    tensor, K5 for a CUDA tensor."""
    fn = lambdarank_topk_cuda if s.is_cuda else lambdarank_topk_plain
    return fn(s, y, layout, k, ndcg_weight, score_norm, group_norm)
