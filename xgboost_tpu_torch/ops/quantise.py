"""Fixed-point gradient quantisation for ``deterministic_histogram=1`` (port
of xgboost_tpu/ops/quantise.py; reference src/tree/gpu_hist/quantiser.cuh).

(g, h) become 22-bit signed fixed point against a per-round scale ``rho``
(the per-channel max |gradient|), split into three signed base-256 int8
limbs.  Histograms of the limbs are exact int32 sums, so any order of
accumulation (atomics on the card included) gives the same bits; the one
rounding step is ``dequantise``, applied after every sum and subtraction.

Bitwise parity with the reference needs three things (tests/
test_torch_quantise.py holds them):
 - the scale is a true division ``_QMAX / rho``; a Python scalar on the left
   of a tensor computes ``rho.reciprocal() * _QMAX`` instead, 1 ulp off;
   a scalar divisor on a CUDA tensor does the same (PyTorch multiplies by
   its reciprocal), so every division here divides by a tensor;
 - ``torch.round`` rounds half to even, as ``jnp.round`` does;
 - ``dequantise`` is separate ops in the reference's order: a fused
   multiply-add would round differently.

``hist_accumulate_q`` is the plain version of the CUDA kernel K2
(csrc/hist_q.cu); the grower calls the dispatcher in ops/hist_cuda.py.

Across ranks (``distributed=True``) every rank quantises with one scale,
the MAX of the ranks' scales, and the limb sums cross ranks as int64
(``allreduce_limbs``): integer sums do not depend on order, so the trees
are the same bits on any number of ranks.  ``dequantise`` casts int32 and
int64 limbs to f32 alike.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["QUANT_BITS", "MAX_ROWS", "local_rho", "quantise_gpair",
           "hist_accumulate_q", "node_sums_q", "dequantise_parts",
           "dequantise", "quantised_root_state", "check_row_budget",
           "prepare_quantised", "allreduce_limbs"]

QUANT_BITS = 22
_QMAX = float((1 << QUANT_BITS) - 1)
# int32 limb-accumulator budget: rows * 128 must stay below 2**31
MAX_ROWS = 1 << 24


def _qmax(like):
    # a fill on the device: torch.tensor(..., device=cuda) would copy from
    # pageable host memory, which synchronises the stream
    return torch.full((), _QMAX, dtype=torch.float32, device=like.device)


def local_rho(gpair, valid):
    """Per-channel max |gradient| over valid rows: (C,) f32."""
    g = gpair.abs() * valid[:, None].to(gpair.dtype)
    return g.amax(dim=0)


def quantise_gpair(gpair, rho):
    """(R, C) f32 -> (R, C, 3) int8 signed base-256 limbs of the fixed-point
    gradient q = round(g / rho * (2**22 - 1))."""
    scale = torch.div(_qmax(rho), torch.clamp(rho, min=1e-30))
    q = torch.clamp(torch.round(gpair * scale[None, :]), -_QMAX, _QMAX).to(
        torch.int32)
    limbs = []
    for _ in range(2):
        low = ((q + 128) & 255) - 128  # signed low limb in [-128, 127]
        limbs.append(low)
        q = (q - low) >> 8  # exact: q - low is divisible by 256
    limbs.append(q)  # |top| <= 65
    return torch.stack(limbs, dim=-1).to(torch.int8)


def hist_accumulate_q(bins, gq, pos, node0: int, n_nodes: int, n_bin: int,
                      stride: int = 1):
    """Exact int32 limb histogram (n_nodes, F, n_bin, C, 3) for nodes
    node0 + stride*[0, n_nodes): an integer scatter-add of each (row,
    feature) limb vector into its (node, feature, bin) cell.

    bins : (R, F) uint8/int16/int32, sentinel == n_bin missing
    gq   : (R, C, 3) int8 limbs (``quantise_gpair``)
    pos  : (R,) int32 node id per row (-1 for pad rows)
    """
    R, F = bins.shape
    C, L = gq.shape[1], gq.shape[2]
    local = pos.long() - node0
    ok = (local >= 0) & (local % stride == 0) & (local // stride < n_nodes)
    node = torch.where(ok, local // stride, 0)
    b = bins.long()
    take = ok[:, None] & (b < n_bin)  # (R, F): row in level, value present
    feat = torch.arange(F, device=bins.device)
    idx = (node[:, None] * F + feat[None, :]) * n_bin + b
    vals = gq.reshape(R, C * L).to(torch.int32)[:, None, :].expand(R, F, C * L)
    flat = torch.zeros(n_nodes * F * n_bin, C * L, dtype=torch.int32,
                       device=bins.device)
    flat.index_add_(0, idx[take], vals[take])
    return flat.reshape(n_nodes, F, n_bin, C, L)


def node_sums_q(gq, pos, node0: int, n_nodes: int):
    """Per-node limb totals (n_nodes, C, 3) int32: exact."""
    R, C, L = gq.shape
    flat = gq.reshape(R, C * L).to(torch.int32)
    rows = [torch.where((pos == node0 + n)[:, None], flat, 0).sum(
        dim=0, dtype=torch.int32) for n in range(n_nodes)]
    return torch.stack(rows).reshape(n_nodes, C, L)


def dequantise_parts(hist_q, rho):
    """int32 limb sums (..., C, 3) -> (combined (..., C) f32, scale (C,)
    f32), whose product is ``dequantise``.  The scale is rho times the f32
    reciprocal of 2**22 - 1: XLA rewrites the reference's division by that
    constant so (the two differ at rho = 0.49999997, a softmax hessian's
    usual maximum)."""
    f = hist_q.to(torch.float32)
    combined = f[..., 0] + 256.0 * f[..., 1] + 65536.0 * f[..., 2]
    inv = torch.full((), 1.0 / _QMAX, dtype=torch.float32, device=rho.device)
    return combined, rho * inv


def dequantise(hist_q, rho):
    """int32 limb sums (..., C, 3) -> f32 (..., C): the one rounding step."""
    combined, scale = dequantise_parts(hist_q, rho)
    return combined * scale


def quantised_root_state(state, gq, rho, *, process_reduce: bool = False):
    """Replace the f32 root totals with the dequantised exact limb sum of
    the root (the reference's InitRoot in fixed point), in place;
    ``process_reduce``: the limb sums of every rank (GlobalSum)."""
    root = node_sums_q(gq, state.pos, 0, 1)
    if process_reduce:
        root = allreduce_limbs(root)
    state.totals[0] = dequantise(root, rho)[0]
    return state


def check_row_budget(n_rows: int) -> None:
    """Raise before an int32 limb accumulator could wrap: padded rows x 128
    must stay below 2**31."""
    if n_rows > MAX_ROWS:
        raise ValueError(
            f"deterministic_histogram supports up to {MAX_ROWS} rows per "
            f"process (int32 limb-accumulator budget); got {n_rows}.  Use "
            "the default f32 histogram for more rows.")


def prepare_quantised(gpair, valid, state, *, distributed: bool = False):
    """Row budget, scale, limbs and exact root totals: (gq, rho, state).
    ``distributed``: the scale is the MAX over the ranks and the root the
    sum over them (reference ops/quantise.py:224-247)."""
    check_row_budget(gpair.shape[0])
    rho = local_rho(gpair, valid)
    if distributed:
        from .. import collective

        rho = torch.from_numpy(collective.allreduce(
            rho.cpu().numpy(), collective.Op.MAX)).to(rho.device)
    gq = quantise_gpair(gpair, rho)
    state = quantised_root_state(state, gq, rho, process_reduce=distributed)
    return gq, rho, state


def allreduce_limbs(hist_q, exchange=None):
    """The limb sums of every rank: int32 limbs summed as int64 on the host
    in rank order (exact, so the order does not matter), returned as int64
    on the input's device (reference ops/quantise.py:249).  ``exchange``:
    a ``parallel.process.HostExchange`` that times the copies and reuses
    pinned host buffers."""
    if exchange is None:
        from .. import collective

        out = collective.allreduce(hist_q.cpu().numpy().astype(np.int64))
        return torch.from_numpy(out).to(hist_q.device)
    return exchange.allreduce(hist_q, torch.int64)
