"""Split evaluation: gain scan over histogram bins (port of the numeric path
of xgboost_tpu/ops/split.py).

The whole (N, F, B) gain tensor is computed at once with a cumsum over bins,
scoring both default directions for missing values, then reduced with an
argmax that takes the first maximum in (feature, bin) order.  Gain formulae
follow src/tree/param.h (CalcGain / CalcWeight / ThresholdL1).
"""
from __future__ import annotations

from typing import NamedTuple

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


class BestSplit(NamedTuple):
    gain: torch.Tensor  # (N,) loss_chg of best split (-inf if none valid)
    feature: torch.Tensor  # (N,) int64
    bin: torch.Tensor  # (N,) int64 — left = bins <= bin
    default_left: torch.Tensor  # (N,) bool
    left_sum: torch.Tensor  # (N, 2) (G, H) of left child
    right_sum: torch.Tensor  # (N, 2)


def _threshold_l1(g, alpha: float):
    return torch.sign(g) * torch.clamp(g.abs() - alpha, min=0.0)


def calc_weight(G, H, p: SplitParams):
    """Raw leaf weight -ThresholdL1(G)/(H+lambda), clipped (param.h)."""
    w = -_threshold_l1(G, p.alpha) / (H + p.lambda_)
    if p.max_delta_step > 0.0:
        w = w.clamp(-p.max_delta_step, p.max_delta_step)
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


def evaluate_splits(hist, totals, n_bins, params: SplitParams) -> BestSplit:
    """Best split per node.

    hist   : (N, F, B, 2) f32 per-node per-feature bin (G, H) sums
    totals : (N, 2) f32 node (G, H) including missing rows
    n_bins : (F,) valid bin count per feature (pads masked out)
    """
    N, F, B, _ = hist.shape
    cum = hist.cumsum(dim=2)  # left sums, missing -> right
    feat_sum = cum[:, :, -1, :]
    miss = totals[:, None, :] - feat_sum  # (N, F, 2) missing-value stats

    GL_r, HL_r = cum[..., 0], cum[..., 1]
    GL_l = GL_r + miss[:, :, None, 0]  # missing -> left
    HL_l = HL_r + miss[:, :, None, 1]
    parent_gain = calc_gain(totals[:, 0], totals[:, 1], params)[:, None, None]

    def side_gain(GL, HL):
        GR = totals[:, None, None, 0] - GL
        HR = totals[:, None, None, 1] - HL
        gain = calc_gain(GL, HL, params) + calc_gain(GR, HR, params) \
            - parent_gain
        valid = ((HL >= params.min_child_weight)
                 & (HR >= params.min_child_weight) & (HL > 0.0) & (HR > 0.0))
        return torch.where(valid, gain, -torch.inf), GR, HR

    gain_r, GR_r, HR_r = side_gain(GL_r, HL_r)
    gain_l, GR_l, HR_l = side_gain(GL_l, HL_l)

    # padded bins never split; the top valid bin only when missing values
    # exist to send right
    bin_idx = torch.arange(B, device=hist.device)
    nb = n_bins.to(hist.device).long()
    bin_ok = bin_idx[None, :] < (nb[:, None] - 1)  # (F, B)
    top_ok = (bin_idx[None, None, :] == (nb[None, :, None] - 1)) \
        & (miss[:, :, 1:2].abs() > _EPS)
    ok = bin_ok[None] | top_ok
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
    return BestSplit(
        gain=best_gain,
        feature=best // B,
        bin=best % B,
        default_left=dleft,
        left_sum=torch.stack([GL, HL], dim=1),
        right_sum=torch.stack([GR, HR], dim=1),
    )
