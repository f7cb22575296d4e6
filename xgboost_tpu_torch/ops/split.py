"""Split evaluation: gain scan over histogram bins (port of the numeric path
of xgboost_tpu/ops/split.py, with feature masks and monotone constraints).

The scan runs in the order the reference sums in, so the CPU, the card and
the reference give the same bits:

- unconstrained: the reference's native scan (native/xtb_kernels.h
  ``xtb_split_scan_impl``): a sequential f32 prefix per (node, feature),
  both missing directions scored with its f32 gain arithmetic, the left
  direction kept on ties, and the first best in (feature, bin) order;
- monotone: the reference's XLA formulation, whose ``jnp.cumsum`` XLA on
  the CPU computes in blocks of 16 (``prefix_blocked``).

``split_scan_plain`` is the plain PyTorch version; the CUDA kernel K3
(csrc/split_scan.cu, ops/split_cuda.py ``split_scan_cuda``) computes the
same six outputs per node.  ``evaluate_splits`` sends a CPU tensor to the
plain version and a CUDA tensor to K3, then forms the right sums and child
weights as the reference does, outside the scan.  Gain formulae follow
src/tree/param.h (CalcGain / CalcWeight / ThresholdL1); monotone constraints
follow src/tree/constraints.cc (child weights clipped to the node's bounds,
splits that violate the direction refused).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.fp import fma_f32
from .split_cuda import split_scan_cuda

_EPS = 1e-6  # kRtEps (include/xgboost/base.h)
# XLA's CPU scan: in-block prefixes of 16 bins, the block totals scanned
# the same way (recursively), each block's exclusive prefix added last
SCAN_BLOCK = 16


class SplitParams(NamedTuple):
    """Split hyper-parameters."""

    eta: float
    gamma: float
    min_child_weight: float
    lambda_: float
    alpha: float
    max_delta_step: float
    # per-feature {-1, 0, +1}; None (or all zero) disables the constrained
    # evaluation
    monotone: Optional[Tuple[int, ...]] = None


class BestSplit(NamedTuple):
    gain: torch.Tensor  # (N,) loss_chg of best split (-inf if none valid)
    feature: torch.Tensor  # (N,) int64
    bin: torch.Tensor  # (N,) int64 — left = bins <= bin
    default_left: torch.Tensor  # (N,) bool
    left_sum: torch.Tensor  # (N, 2) (G, H) of left child
    right_sum: torch.Tensor  # (N, 2)
    left_weight: torch.Tensor  # (N,) child weights (monotone-clipped)
    right_weight: torch.Tensor  # (N,)


class ScanResult(NamedTuple):
    """The split scan's outputs per node (K3 and its plain version)."""

    gain: torch.Tensor  # (N,) f32
    feature: torch.Tensor  # (N,) int64
    bin: torch.Tensor  # (N,) int64
    default_left: torch.Tensor  # (N,) bool
    GL: torch.Tensor  # (N,) f32 left child's gradient sum
    HL: torch.Tensor  # (N,) f32 left child's hessian sum


def is_monotone(params: SplitParams) -> bool:
    return params.monotone is not None and any(c != 0 for c in params.monotone)


@functools.lru_cache(maxsize=16)
def monotone_vec(monotone: Tuple[int, ...], device: torch.device):
    """The constraint vector on ``device``, made once (a host-to-device copy
    from pageable memory would synchronise the stream at every level)."""
    return torch.tensor(monotone, dtype=torch.int32, device=device)


def _threshold_l1(g, alpha: float):
    # sign(g) * max(|g| - alpha, 0) with jnp.sign's -0.0 for -0.0
    return torch.copysign(torch.clamp(g.abs() - alpha, min=0.0), g)


def calc_weight(G, H, p: SplitParams, lower=None, upper=None):
    """Raw leaf weight -ThresholdL1(G)/(H+lambda), clipped (param.h); the
    optional [lower, upper] clamp is the monotone bound."""
    w = -_threshold_l1(G, p.alpha) / (H + p.lambda_)
    if p.max_delta_step > 0.0:
        w = w.clamp(-p.max_delta_step, p.max_delta_step)
    if lower is not None:
        w = torch.clamp(w, min=lower, max=upper)
    return torch.where(H <= 0.0, torch.zeros_like(w), w)


def gain_given_weight(G, H, w, p: SplitParams):
    """param.h CalcGainGivenWeight, -(2 t w + (H + lambda) w w), with the
    multiply-add XLA on the CPU fuses: fma(2 t, w, (H + lambda) w w)."""
    ret = -fma_f32(2.0 * _threshold_l1(G, p.alpha), w, (H + p.lambda_) * w * w)
    return torch.where(H <= 0.0, torch.zeros_like(ret), ret)


def calc_gain(G, H, p: SplitParams):
    """param.h CalcGain: ThresholdL1(G)^2/(H+lambda), or gain-given-weight
    when max_delta_step clips."""
    if p.max_delta_step == 0.0:
        ret = _threshold_l1(G, p.alpha) ** 2 / (H + p.lambda_)
        return torch.where(H <= 0.0, torch.zeros_like(ret), ret)
    return gain_given_weight(G, H, calc_weight(G, H, p), p)


# ---------------------------------------------------------------- prefixes
def prefix_sequential(x):
    """Prefix sums along the last axis, added one element at a time in f32
    from 0.0 (torch.cumsum on the CPU accumulates in f64, on the card in a
    parallel order)."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for b in range(x.shape[-1]):
        acc = acc + x[..., b]
        out[..., b] = acc
    return out


def prefix_blocked(x, block: int = SCAN_BLOCK):
    """Prefix sums along the last axis in the order of XLA's CPU scan:
    sequential within blocks of ``block`` (the axis zero-padded to a
    multiple of it), the block totals scanned the same way, and each
    block's exclusive prefix added to its elements."""
    n = x.shape[-1]
    if n <= block:
        return prefix_sequential(x)
    m = -(-n // block) * block
    xp = torch.nn.functional.pad(x, (0, m - n))
    inb = prefix_sequential(xp.reshape(*x.shape[:-1], m // block, block))
    tot = prefix_blocked(inb[..., -1], block)
    excl = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]], dim=-1)
    return (inb + excl[..., None]).reshape(*x.shape[:-1], m)[..., :n]


# ---------------------------------------------------------------- scans
def _candidate_ok(n_bins, has_miss, B: int, fmask):
    """(N, F, B) bool: bins below the top valid one, the top one when the
    feature has missing values, of the features the node may split on."""
    bin_idx = torch.arange(B, device=has_miss.device)
    nb = n_bins.to(has_miss.device).long()
    ok = (bin_idx[None, None, :] < (nb[None, :, None] - 1)) \
        | ((bin_idx[None, None, :] == (nb[None, :, None] - 1))
           & has_miss[:, :, None])
    if fmask is not None:
        ok = ok & fmask[:, :, None]
    return ok


def _pick(flat_idx, *arrs):
    N = flat_idx.shape[0]
    return [a.reshape(N, -1).gather(1, flat_idx[:, None])[:, 0] for a in arrs]


def _gain_native(G, H, p: SplitParams):
    """xtb_calc_gain, each op rounded to f32 in the reference's order."""
    a = G.abs() - p.alpha
    a = torch.where(a < 0.0, torch.zeros_like(a), a)
    t = torch.where(G < 0.0, -a, a)
    if p.max_delta_step == 0.0:
        r = t * t / (H + p.lambda_)
    else:
        w = -t / (H + p.lambda_)
        w = torch.where(w > p.max_delta_step,
                        torch.full_like(w, p.max_delta_step), w)
        w = torch.where(w < -p.max_delta_step,
                        torch.full_like(w, -p.max_delta_step), w)
        r = -(2.0 * t * w + (H + p.lambda_) * w * w)
    return torch.where(H <= 0.0, torch.zeros_like(r), r)


def _scan_native(hist, totals, n_bins, p: SplitParams, fmask) -> ScanResult:
    """xtb_split_scan_impl in PyTorch ops."""
    N, F, B, _ = hist.shape
    h = hist.permute(0, 1, 3, 2)  # (N, F, 2, B)
    cum = prefix_sequential(h)
    GLr, HLr = cum[:, :, 0], cum[:, :, 1]  # (N, F, B)
    totG, totH = totals[:, 0], totals[:, 1]
    tG, tH = totG[:, None, None], totH[:, None, None]
    missG = tG - GLr[:, :, -1:]  # gsum: the sequential sum over all B bins
    missH = tH - HLr[:, :, -1:]
    has_miss = missH[:, :, 0].abs() > _EPS
    parent = _gain_native(totG, totH, p)[:, None, None]
    mcw = p.min_child_weight

    def side(GL, HL):
        GR, HR = tG - GL, tH - HL
        valid = (HL >= mcw) & (HR >= mcw) & (HL > 0.0) & (HR > 0.0)
        return valid, _gain_native(GL, HL, p) + _gain_native(GR, HR, p) \
            - parent

    valid_r, gain_r = side(GLr, HLr)
    GLl, HLl = GLr + missG, HLr + missH
    valid_l, gain_l = side(GLl, HLl)
    ninf = torch.full_like(gain_r, -torch.inf)
    g2 = torch.where(valid_r, gain_r, ninf)
    take_left = valid_l & (gain_l >= g2)
    g2 = torch.where(take_left, gain_l, g2)
    dl = take_left | ~valid_r
    ok = _candidate_ok(n_bins, has_miss, B, fmask)
    g2 = torch.where(ok, g2, ninf)

    best = g2.reshape(N, F * B).argmax(dim=1)  # the first maximum
    gain, dleft, GLb, HLb, GRb, HRb = _pick(best, g2, dl, GLl, HLl, GLr, HLr)
    GL = torch.where(dleft, GLb, GRb)
    HL = torch.where(dleft, HLb, HRb)
    feat, sbin = best // B, best % B
    # no candidate: (feature 0, bin 0), missing left, feature 0's sums
    none = gain == -torch.inf
    zero = torch.zeros_like(gain)
    GL = torch.where(none, hist[:, 0, 0, 0] + (totG - GLr[:, 0, -1]), GL)
    HL = torch.where(none, hist[:, 0, 0, 1] + (totH - HLr[:, 0, -1]), HL)
    # a dead slot (both totals zero) takes the all-zero answer directly
    dead = (totG == 0.0) & (totH == 0.0)
    GL = torch.where(dead, zero, GL)
    HL = torch.where(dead, zero, HL)
    gain = torch.where(dead, torch.full_like(gain, -torch.inf), gain)
    none = none | dead
    return ScanResult(
        gain=gain, feature=torch.where(none, 0, feat),
        bin=torch.where(none, 0, sbin), default_left=dleft | none,
        GL=GL, HL=HL)


def _scan_monotone(hist, totals, n_bins, p: SplitParams, fmask,
                   node_bounds) -> ScanResult:
    """The reference's XLA formulation under monotone constraints, its
    cumsum in XLA's blocked order."""
    N, F, B, _ = hist.shape
    cum = prefix_blocked(hist.permute(0, 1, 3, 2))  # (N, F, 2, B)
    GL_r, HL_r = cum[:, :, 0], cum[:, :, 1]
    miss = totals[:, None, :] - cum[:, :, :, -1]  # (N, F, 2)
    GL_l = GL_r + miss[:, :, None, 0]  # missing -> left
    HL_l = HL_r + miss[:, :, None, 1]

    lo_n = hi_n = lo = hi = None  # unbounded: calc_weight skips the clamp
    if node_bounds is not None:
        lo_n, hi_n = node_bounds[:, 0], node_bounds[:, 1]
        lo, hi = lo_n[:, None, None], hi_n[:, None, None]
    cvec = monotone_vec(p.monotone, hist.device)[None, :, None]
    w_parent = calc_weight(totals[:, 0], totals[:, 1], p, lo_n, hi_n)
    parent_gain = gain_given_weight(totals[:, 0], totals[:, 1], w_parent,
                                    p)[:, None, None]

    def side_gain(GL, HL):
        GR = totals[:, None, None, 0] - GL
        HR = totals[:, None, None, 1] - HL
        wL = calc_weight(GL, HL, p, lo, hi)
        wR = calc_weight(GR, HR, p, lo, hi)
        gain = gain_given_weight(GL, HL, wL, p) \
            + gain_given_weight(GR, HR, wR, p) - parent_gain
        viol = ((cvec > 0) & (wL > wR)) | ((cvec < 0) & (wL < wR))
        gain = torch.where(viol, -torch.inf, gain)
        valid = ((HL >= p.min_child_weight) & (HR >= p.min_child_weight)
                 & (HL > 0.0) & (HR > 0.0))
        return torch.where(valid, gain, -torch.inf)

    ok = _candidate_ok(n_bins, miss[:, :, 1].abs() > _EPS, B, fmask)
    gain_r = torch.where(ok, side_gain(GL_r, HL_r), -torch.inf)
    gain_l = torch.where(ok, side_gain(GL_l, HL_l), -torch.inf)
    use_left = gain_l >= gain_r
    gain = torch.where(use_left, gain_l, gain_r)
    best = gain.reshape(N, F * B).argmax(dim=1)  # first maximum, as jnp
    g, dleft, gll, hll, glr, hlr = _pick(best, gain, use_left, GL_l, HL_l,
                                         GL_r, HL_r)
    return ScanResult(gain=g, feature=best // B, bin=best % B,
                      default_left=dleft, GL=torch.where(dleft, gll, glr),
                      HL=torch.where(dleft, hll, hlr))


def split_scan_plain(hist, totals, n_bins, params: SplitParams,
                     feature_mask=None, node_bounds=None) -> ScanResult:
    """K3's plain PyTorch version: the scan of ``evaluate_splits``."""
    fm = _node_mask(feature_mask, hist.shape[0])
    if is_monotone(params):
        return _scan_monotone(hist, totals, n_bins, params, fm, node_bounds)
    return _scan_native(hist, totals, n_bins, params, fm)


def _node_mask(feature_mask, N: int):
    if feature_mask is None:
        return None
    fm = feature_mask if feature_mask.ndim == 2 else feature_mask[None, :]
    return fm.expand(N, fm.shape[1])


def evaluate_splits(hist, totals, n_bins, params: SplitParams,
                    feature_mask=None, node_bounds=None) -> BestSplit:
    """Best split per node.

    hist   : (N, F, B, 2) f32 per-node per-feature bin (G, H) sums
    totals : (N, 2) f32 node (G, H) including missing rows
    n_bins : (F,) valid bin count per feature (pads masked out)
    feature_mask : optional (F,) or (N, F) bool, the features a node may
                   split on (column sampling, interaction constraints)
    node_bounds  : optional (N, 2) f32 [lower, upper] monotone weight bounds
    """
    if hist.is_cuda:
        mono = (monotone_vec(tuple(params.monotone), hist.device)
                if is_monotone(params) else None)
        s = ScanResult(*split_scan_cuda(hist, totals, n_bins, params,
                                        feature_mask, node_bounds, mono))
    else:
        s = split_scan_plain(hist, totals, n_bins, params, feature_mask,
                             node_bounds)
    GR = totals[:, 0] - s.GL
    HR = totals[:, 1] - s.HL
    lo = hi = None
    if is_monotone(params) and node_bounds is not None:
        lo, hi = node_bounds[:, 0], node_bounds[:, 1]
    return BestSplit(
        gain=s.gain, feature=s.feature, bin=s.bin,
        default_left=s.default_left,
        left_sum=torch.stack([s.GL, s.HL], dim=1),
        right_sum=torch.stack([GR, HR], dim=1),
        left_weight=calc_weight(s.GL, s.HL, params, lo, hi),
        right_weight=calc_weight(GR, HR, params, lo, hi))
