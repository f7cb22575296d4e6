"""Split evaluation: gain scan over histogram bins (port of the numeric path
of xgboost_tpu/ops/split.py, with feature masks and monotone constraints).

The scan runs in the order the reference sums in, so the CPU, the card and
the reference give the same bits:

- unconstrained: the reference's native scan (native/xtb_kernels.h
  ``xtb_split_scan_impl``): a sequential f32 prefix per (node, feature),
  both missing directions scored with its f32 gain arithmetic, the left
  direction kept on ties, and the first best in (feature, bin) order;
- monotone: the reference's XLA formulation, whose ``jnp.cumsum`` XLA on
  the CPU computes in blocks of 16 (``prefix_blocked``);
- categorical (a ``cat_mask`` is given): the XLA formulation for every
  feature, numeric ones too, as the reference never takes its native scan
  then: each categorical feature's bins stably sorted by G / (H + 1e-6)
  (empty bins last), the blocked prefix over the sorted bins, features of
  fewer than ``max_cat_to_onehot`` bins scored one-hot (one category
  against the rest), the gain unconstrained or monotone.  A categorical
  split sends the categories of ``cat_set`` right.

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

import numpy as np

from ..utils.fp import fma_f32, sum_f32
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
    # categorical features of fewer bins are split one-hot
    # (src/tree/param.h max_cat_to_onehot)
    max_cat_to_onehot: int = 4


class BestSplit(NamedTuple):
    gain: torch.Tensor  # (N,) loss_chg of best split (-inf if none valid)
    feature: torch.Tensor  # (N,) int64
    bin: torch.Tensor  # (N,) int64 — left = bins <= bin
    default_left: torch.Tensor  # (N,) bool
    left_sum: torch.Tensor  # (N, 2) (G, H) of left child
    right_sum: torch.Tensor  # (N, 2)
    left_weight: torch.Tensor  # (N,) child weights (monotone-clipped)
    right_weight: torch.Tensor  # (N,)
    is_cat: torch.Tensor  # (N,) bool categorical split chosen
    cat_set: torch.Tensor  # (N, B) bool categories routed right


class BestSplitMulti(NamedTuple):
    """The best split per node of a vector-leaf tree (K targets)."""

    gain: torch.Tensor  # (N,) summed per-target loss_chg (-inf if none)
    feature: torch.Tensor  # (N,) int64
    bin: torch.Tensor  # (N,) int64
    default_left: torch.Tensor  # (N,) bool
    left_sum: torch.Tensor  # (N, K, 2)
    right_sum: torch.Tensor  # (N, K, 2)
    left_weight: torch.Tensor  # (N, K)
    right_weight: torch.Tensor  # (N, K)


class ScanResult(NamedTuple):
    """The split scan's outputs per node (K3 and its plain version)."""

    gain: torch.Tensor  # (N,) f32
    feature: torch.Tensor  # (N,) int64
    bin: torch.Tensor  # (N,) int64
    default_left: torch.Tensor  # (N,) bool
    GL: torch.Tensor  # (N,) f32 left child's gradient sum
    HL: torch.Tensor  # (N,) f32 left child's hessian sum
    # the categorical scan's (N, B) bool categories routed right: the
    # chosen category of a one-hot split, the bins ranked after the chosen
    # one of a partition; all False where the best feature is numeric
    cat_set: Optional[torch.Tensor] = None


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
def _candidate_ok(n_bins, has_miss, B: int, fmask, onehot=None):
    """(N, F, B) bool: bins below the top valid one, the top one when the
    feature has missing values, every valid bin of a one-hot feature
    (``onehot`` (F,) bool), of the features the node may split on."""
    bin_idx = torch.arange(B, device=has_miss.device)
    nb = n_bins.to(has_miss.device).long()
    ok = (bin_idx[None, None, :] < (nb[None, :, None] - 1)) \
        | ((bin_idx[None, None, :] == (nb[None, :, None] - 1))
           & has_miss[:, :, None])
    if onehot is not None:
        ok = torch.where(onehot[None, :, None],
                         bin_idx[None, None, :] < nb[None, :, None], ok)
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


def _cat_order(hist, cat_mask):
    """(N, F, B) int64: each categorical feature's bins in the stable order
    of G / (H + 1e-6), bins with H <= 0 last (+inf), the identity for the
    numeric features (reference split.py:278-285)."""
    B = hist.shape[2]
    ratio = hist[..., 0] / (hist[..., 1] + _EPS)
    ratio = torch.where(hist[..., 1] > 0, ratio, torch.inf)
    iota = torch.arange(B, dtype=torch.float32, device=hist.device)
    key = torch.where(cat_mask[None, :, None], ratio, iota)
    return torch.sort(key, dim=2, stable=True).indices


def _scan_xla(hist, totals, n_bins, p: SplitParams, fmask, node_bounds,
              cat_mask=None, dq=None) -> ScanResult:
    """The reference's XLA formulation (split.py:253-417), its cumsum in
    XLA's blocked order: under monotone constraints, and for every feature
    when a ``cat_mask`` is given, with the categorical features' bins
    sorted and their ``cat_set`` formed.  ``dq``: the (comb, scale) whose
    product ``hist`` is under deterministic_histogram (ops/quantise.py
    ``dequantise_parts``), for the one-hot sums XLA computes from them."""
    N, F, B, _ = hist.shape
    mono = is_monotone(p)
    order = onehot = None
    hist_eval = hist
    if cat_mask is not None:
        # categorical features of fewer bins are split one-hot
        onehot = cat_mask & (n_bins.to(hist.device) < p.max_cat_to_onehot)
        order = _cat_order(hist, cat_mask)
        hist_eval = hist.gather(2, order[..., None].expand(N, F, B, 2))
    cum = prefix_blocked(hist_eval.permute(0, 1, 3, 2))  # (N, F, 2, B)
    GL_r, HL_r = cum[:, :, 0], cum[:, :, 1]
    feat_sum = cum[:, :, :, -1]  # (N, F, 2): the sorted bins' blocked total
    if onehot is not None:
        # one-hot: left = every category but b, by the UNSORTED bin b
        oh = onehot[None, :, None]
        if dq is not None:
            # hist = comb * scale, and XLA fuses that product into this
            # subtraction: one rounding, fma(-comb, scale, total)
            comb, scale = dq
            og = fma_f32(-comb[..., 0], scale[0], feat_sum[:, :, None, 0])
            oh_h = fma_f32(-comb[..., 1], scale[1], feat_sum[:, :, None, 1])
        else:
            og = feat_sum[:, :, None, 0] - hist[..., 0]
            oh_h = feat_sum[:, :, None, 1] - hist[..., 1]
        GL_r = torch.where(oh, og, GL_r)
        HL_r = torch.where(oh, oh_h, HL_r)
    miss = totals[:, None, :] - feat_sum  # (N, F, 2)
    GL_l = GL_r + miss[:, :, None, 0]  # missing -> left
    HL_l = HL_r + miss[:, :, None, 1]

    lo_n = hi_n = lo = hi = None  # unbounded: calc_weight skips the clamp
    if mono:
        if node_bounds is not None:
            lo_n, hi_n = node_bounds[:, 0], node_bounds[:, 1]
            lo, hi = lo_n[:, None, None], hi_n[:, None, None]
        cvec = monotone_vec(p.monotone, hist.device)[None, :, None]
        w_parent = calc_weight(totals[:, 0], totals[:, 1], p, lo_n, hi_n)
        parent_gain = gain_given_weight(totals[:, 0], totals[:, 1],
                                        w_parent, p)[:, None, None]
    else:
        parent_gain = calc_gain(totals[:, 0], totals[:, 1], p)[:, None, None]

    def side_gain(GL, HL):
        GR = totals[:, None, None, 0] - GL
        HR = totals[:, None, None, 1] - HL
        if mono:
            wL = calc_weight(GL, HL, p, lo, hi)
            wR = calc_weight(GR, HR, p, lo, hi)
            gain = gain_given_weight(GL, HL, wL, p) \
                + gain_given_weight(GR, HR, wR, p) - parent_gain
            viol = ((cvec > 0) & (wL > wR)) | ((cvec < 0) & (wL < wR))
            gain = torch.where(viol, -torch.inf, gain)
        else:
            gain = calc_gain(GL, HL, p) + calc_gain(GR, HR, p) - parent_gain
        valid = ((HL >= p.min_child_weight) & (HR >= p.min_child_weight)
                 & (HL > 0.0) & (HR > 0.0))
        return torch.where(valid, gain, -torch.inf)

    ok = _candidate_ok(n_bins, miss[:, :, 1].abs() > _EPS, B, fmask, onehot)
    gain_r = torch.where(ok, side_gain(GL_r, HL_r), -torch.inf)
    gain_l = torch.where(ok, side_gain(GL_l, HL_l), -torch.inf)
    use_left = gain_l >= gain_r
    gain = torch.where(use_left, gain_l, gain_r)
    best = gain.reshape(N, F * B).argmax(dim=1)  # first maximum, as jnp
    g, dleft, gll, hll, glr, hlr = _pick(best, gain, use_left, GL_l, HL_l,
                                         GL_r, HL_r)
    feat, sbin = best // B, best % B
    cat_set = None
    if cat_mask is not None:
        # categories routed right: one-hot the chosen bin, partition the
        # bins ranked after the chosen position (reference :384-402)
        rank = torch.empty_like(order)
        rank.scatter_(2, order, torch.arange(B, device=hist.device)
                      .expand(N, F, B).contiguous())
        rank_at = rank[torch.arange(N, device=hist.device), feat]  # (N, B)
        bb = torch.arange(B, device=hist.device)[None, :]
        in_range = bb < n_bins.to(hist.device).long()[feat][:, None]
        cat_set = torch.where(onehot[feat][:, None], bb == sbin[:, None],
                              rank_at > sbin[:, None])
        cat_set = cat_set & in_range & cat_mask[feat][:, None]
    return ScanResult(gain=g, feature=feat, bin=sbin, default_left=dleft,
                      GL=torch.where(dleft, gll, glr),
                      HL=torch.where(dleft, hll, hlr), cat_set=cat_set)


def split_scan_plain(hist, totals, n_bins, params: SplitParams,
                     feature_mask=None, node_bounds=None,
                     cat_mask=None, dq=None) -> ScanResult:
    """K3's plain PyTorch version: the scan of ``evaluate_splits``;
    ``cat_mask`` (F,) bool on hist's device selects the categorical scan,
    and ``dq`` is its (comb, scale) under deterministic_histogram."""
    if dq is not None and cat_mask is None:
        raise ValueError("dq is read by the categorical scan only")
    fm = _node_mask(feature_mask, hist.shape[0])
    if cat_mask is not None or is_monotone(params):
        return _scan_xla(hist, totals, n_bins, params, fm, node_bounds,
                         cat_mask, dq)
    return _scan_native(hist, totals, n_bins, params, fm)


def _node_mask(feature_mask, N: int):
    if feature_mask is None:
        return None
    fm = feature_mask if feature_mask.ndim == 2 else feature_mask[None, :]
    return fm.expand(N, fm.shape[1])


def evaluate_splits(hist, totals, n_bins, params: SplitParams,
                    feature_mask=None, node_bounds=None,
                    cat_mask=None, dq=None) -> BestSplit:
    """Best split per node.

    hist   : (N, F, B, 2) f32 per-node per-feature bin (G, H) sums
    totals : (N, 2) f32 node (G, H) including missing rows
    n_bins : (F,) valid bin count per feature (pads masked out)
    feature_mask : optional (F,) or (N, F) bool, the features a node may
                   split on (column sampling, interaction constraints)
    node_bounds  : optional (N, 2) f32 [lower, upper] monotone weight bounds
    cat_mask     : optional (F,) bool on hist's device, the categorical
                   features; given, every feature takes the categorical scan
    dq           : optional (comb (N, F, B, 2) f32, scale (2,) f32) with
                   hist = comb * scale, under deterministic_histogram: the
                   categorical scan's one-hot sums are formed from them
    """
    if hist.is_cuda:
        mono = (monotone_vec(tuple(params.monotone), hist.device)
                if is_monotone(params) else None)
        s = ScanResult(*split_scan_cuda(hist, totals, n_bins, params,
                                        feature_mask, node_bounds, mono,
                                        cat_mask, dq))
    else:
        s = split_scan_plain(hist, totals, n_bins, params, feature_mask,
                             node_bounds, cat_mask, dq)
    lo = hi = None
    if is_monotone(params) and node_bounds is not None:
        lo, hi = node_bounds[:, 0], node_bounds[:, 1]
    # both children at once: (2, N, 2) sums, (2, N) weights
    left = torch.stack([s.GL, s.HL], dim=1)
    sums = torch.stack([left, totals - left])
    w = calc_weight(sums[..., 0], sums[..., 1], params, lo, hi)
    return BestSplit(
        gain=s.gain, feature=s.feature, bin=s.bin,
        default_left=s.default_left, left_sum=sums[0], right_sum=sums[1],
        left_weight=w[0], right_weight=w[1],
        is_cat=(torch.zeros_like(s.default_left) if cat_mask is None
                else cat_mask[s.feature]),
        cat_set=(torch.zeros((hist.shape[0], hist.shape[2]), dtype=torch.bool,
                             device=hist.device)
                 if s.cat_set is None else s.cat_set))



def mean_last_f32(x):
    """``x.mean(-1)`` of f32 values as XLA computes it on the CPU: the
    sequential sum times f32(1 / n), a product and not a division."""
    return sum_f32(x, dim=-1) * float(np.float32(1.0 / x.shape[-1]))


def evaluate_splits_multi(hist, totals, n_bins, params: SplitParams,
                          feature_mask=None) -> BestSplitMulti:
    """Best split per node for vector-leaf trees (port of
    xgboost_tpu/ops/split.py:105-190, XLA ops there, PyTorch ops here on
    both devices).

    hist   : (N, F, B, K, 2) f32 per-target bin (G, H) sums
    totals : (N, K, 2) f32 per-target node totals (missing rows included)
    feature_mask : optional (F,) or (1|N, F) bool

    The gain of a (feature, bin) is the sum over the K targets of the
    per-target gains (multi_evaluate_splits.cu), min_child_weight applies
    to the mean per-target hessian.  The bin prefix is XLA's blocked
    ``jnp.cumsum`` order, the sum and mean over K XLA's (sequential, and
    the sum times f32(1/K)), so the scan is the reference's bits."""
    N, F, B, K, _ = hist.shape
    p = params
    # XLA's blocked prefix along the bins: (N, F, K, 2, B) -> (N, F, B, K, 2)
    cum = prefix_blocked(hist.permute(0, 1, 3, 4, 2)).permute(0, 1, 4, 2, 3)
    feat_sum = cum[:, :, -1]  # (N, F, K, 2)
    miss = totals[:, None] - feat_sum  # (N, F, K, 2)
    GL_r, HL_r = cum[..., 0], cum[..., 1]  # (N, F, B, K), missing -> right
    GL_l = GL_r + miss[:, :, None, :, 0]
    HL_l = HL_r + miss[:, :, None, :, 1]
    tG, tH = totals[:, None, None, :, 0], totals[:, None, None, :, 1]
    parent_gain = sum_f32(calc_gain(totals[..., 0], totals[..., 1], p),
                          dim=-1)[:, None, None]  # (N, 1, 1)

    def side_gain(GL, HL):
        GR, HR = tG - GL, tH - HL
        gain = sum_f32(calc_gain(GL, HL, p) + calc_gain(GR, HR, p),
                       dim=-1) - parent_gain  # (N, F, B)
        HLm, HRm = mean_last_f32(HL), mean_last_f32(HR)
        valid = ((HLm >= p.min_child_weight) & (HRm >= p.min_child_weight)
                 & (HLm > 0.0) & (HRm > 0.0))
        return torch.where(valid, gain, -torch.inf), GR, HR

    gain_r, GR_r, HR_r = side_gain(GL_r, HL_r)
    gain_l, GR_l, HR_l = side_gain(GL_l, HL_l)
    has_miss = sum_f32(miss[..., 1].abs(), dim=-1) > _EPS  # (N, F)
    ok = _candidate_ok(n_bins, has_miss, B, _node_mask(feature_mask, N))
    gain_r = torch.where(ok, gain_r, -torch.inf)
    gain_l = torch.where(ok, gain_l, -torch.inf)
    use_left = gain_l >= gain_r
    gain = torch.where(use_left, gain_l, gain_r)

    best = gain.reshape(N, F * B).argmax(dim=1)  # first maximum, as jnp
    idx = best[:, None, None].expand(N, 1, K)

    def pick(a):  # (N, F, B, K) -> (N, K) at the best (feature, bin)
        return a.reshape(N, F * B, K).gather(1, idx)[:, 0]

    g, dleft = _pick(best, gain, use_left)
    dl = dleft[:, None]
    GL = torch.where(dl, pick(GL_l), pick(GL_r))
    HL = torch.where(dl, pick(HL_l), pick(HL_r))
    GR = torch.where(dl, pick(GR_l), pick(GR_r))
    HR = torch.where(dl, pick(HR_l), pick(HR_r))
    return BestSplitMulti(
        gain=g, feature=best // B, bin=best % B, default_left=dleft,
        left_sum=torch.stack([GL, HL], dim=-1),
        right_sum=torch.stack([GR, HR], dim=-1),
        left_weight=calc_weight(GL, HL, p), right_weight=calc_weight(GR, HR, p))
