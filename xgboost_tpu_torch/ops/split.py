"""Split evaluation: gain scan over histogram bins (port of the numeric path
of xgboost_tpu/ops/split.py, with feature masks and monotone constraints).

The whole (N, F, B) gain tensor is computed at once with a cumsum over bins,
scoring both default directions for missing values, then reduced with an
argmax that takes the first maximum in (feature, bin) order.  Gain formulae
follow src/tree/param.h (CalcGain / CalcWeight / ThresholdL1); monotone
constraints follow src/tree/constraints.cc (child weights clipped to the
node's bounds, splits that violate the direction refused).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

_EPS = 1e-6  # kRtEps (include/xgboost/base.h)


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


@functools.lru_cache(maxsize=16)
def monotone_vec(monotone: Tuple[int, ...], device: torch.device):
    """The constraint vector on ``device``, made once (a host-to-device copy
    from pageable memory would synchronise the stream at every level)."""
    return torch.tensor(monotone, dtype=torch.int32, device=device)


def _threshold_l1(g, alpha: float):
    return torch.sign(g) * torch.clamp(g.abs() - alpha, min=0.0)


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
    """param.h CalcGainGivenWeight."""
    ret = -(2.0 * _threshold_l1(G, p.alpha) * w + (H + p.lambda_) * w * w)
    return torch.where(H <= 0.0, torch.zeros_like(ret), ret)


def calc_gain(G, H, p: SplitParams):
    """param.h CalcGain: ThresholdL1(G)^2/(H+lambda), or gain-given-weight
    when max_delta_step clips."""
    if p.max_delta_step == 0.0:
        ret = _threshold_l1(G, p.alpha) ** 2 / (H + p.lambda_)
        return torch.where(H <= 0.0, torch.zeros_like(ret), ret)
    return gain_given_weight(G, H, calc_weight(G, H, p), p)


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
    N, F, B, _ = hist.shape
    cum = hist.cumsum(dim=2)  # left sums, missing -> right
    feat_sum = cum[:, :, -1, :]
    miss = totals[:, None, :] - feat_sum  # (N, F, 2) missing-value stats

    GL_r, HL_r = cum[..., 0], cum[..., 1]
    GL_l = GL_r + miss[:, :, None, 0]  # missing -> left
    HL_l = HL_r + miss[:, :, None, 1]

    monotone = params.monotone is not None and any(
        c != 0 for c in params.monotone)
    if monotone:
        lo_n = hi_n = lo = hi = None  # unbounded: calc_weight skips the clamp
        if node_bounds is not None:
            lo_n, hi_n = node_bounds[:, 0], node_bounds[:, 1]
            lo, hi = lo_n[:, None, None], hi_n[:, None, None]
        cvec = monotone_vec(params.monotone, hist.device)[None, :, None]
        w_parent = calc_weight(totals[:, 0], totals[:, 1], params, lo_n, hi_n)
        parent_gain = gain_given_weight(totals[:, 0], totals[:, 1], w_parent,
                                        params)[:, None, None]
    else:
        parent_gain = calc_gain(totals[:, 0], totals[:, 1],
                                params)[:, None, None]

    def side_gain(GL, HL):
        GR = totals[:, None, None, 0] - GL
        HR = totals[:, None, None, 1] - HL
        if monotone:
            wL = calc_weight(GL, HL, params, lo, hi)
            wR = calc_weight(GR, HR, params, lo, hi)
            gain = gain_given_weight(GL, HL, wL, params) \
                + gain_given_weight(GR, HR, wR, params) - parent_gain
            viol = ((cvec > 0) & (wL > wR)) | ((cvec < 0) & (wL < wR))
            gain = torch.where(viol, -torch.inf, gain)
        else:
            wL = wR = None
            gain = calc_gain(GL, HL, params) + calc_gain(GR, HR, params) \
                - parent_gain
        valid = ((HL >= params.min_child_weight)
                 & (HR >= params.min_child_weight) & (HL > 0.0) & (HR > 0.0))
        return torch.where(valid, gain, -torch.inf), GR, HR, wL, wR

    gain_r, GR_r, HR_r, wL_r, wR_r = side_gain(GL_r, HL_r)
    gain_l, GR_l, HR_l, wL_l, wR_l = side_gain(GL_l, HL_l)

    # padded bins never split; the top valid bin only when missing values
    # exist to send right
    bin_idx = torch.arange(B, device=hist.device)
    nb = n_bins.to(hist.device).long()
    bin_ok = bin_idx[None, :] < (nb[:, None] - 1)  # (F, B)
    top_ok = (bin_idx[None, None, :] == (nb[None, :, None] - 1)) \
        & (miss[:, :, 1:2].abs() > _EPS)
    ok = bin_ok[None] | top_ok
    if feature_mask is not None:
        fm = feature_mask if feature_mask.ndim == 2 else feature_mask[None, :]
        ok = ok & fm[:, :, None]
    gain_r = torch.where(ok, gain_r, -torch.inf)
    gain_l = torch.where(ok, gain_l, -torch.inf)

    use_left = gain_l >= gain_r
    gain = torch.where(use_left, gain_l, gain_r)

    flat = gain.reshape(N, F * B)
    best = flat.argmax(dim=1)  # first maximum, as jnp.argmax
    best_gain = flat.gather(1, best[:, None])[:, 0]

    def pick(arr):  # (N, F, B) -> (N,) at best
        return arr.reshape(N, F * B).gather(1, best[:, None])[:, 0]

    dleft = pick(use_left)
    GL = torch.where(dleft, pick(GL_l), pick(GL_r))
    HL = torch.where(dleft, pick(HL_l), pick(HL_r))
    GR = torch.where(dleft, pick(GR_l), pick(GR_r))
    HR = torch.where(dleft, pick(HR_l), pick(HR_r))
    if monotone:
        lw = torch.where(dleft, pick(wL_l), pick(wL_r))
        rw = torch.where(dleft, pick(wR_l), pick(wR_r))
    else:
        lw = calc_weight(GL, HL, params)
        rw = calc_weight(GR, HR, params)
    return BestSplit(
        gain=best_gain,
        feature=best // B,
        bin=best % B,
        default_left=dleft,
        left_sum=torch.stack([GL, HL], dim=1),
        right_sum=torch.stack([GR, HR], dim=1),
        left_weight=lw,
        right_weight=rw,
    )
