"""Learning-to-rank objectives: LambdaMART (port of
xgboost_tpu/objective/ranking.py; reference src/objective/lambdarank_obj.cc).

``rank:ndcg``, ``rank:pairwise`` and ``rank:map`` over the query groups of
the training matrix (``set_group_info``, called by the booster before each
gradient).  Two pair methods, as the reference's:

- ``topk`` (the default): each of the top ``lambdarank_num_pair_per_sample``
  (32) docs of the current ranking paired with every doc below it, the
  reference's native kernel's bits (``ops/lambdarank_cuda.py``: the plain
  version on the CPU, K5 on the card);
- ``mean``: ``lambdarank_num_pair_per_sample`` (1) random partners a doc
  from the threefry stream of the round (``utils/random.py``), in XLA's
  bits (``lambda_gradients_mean``): XLA's f32 ``log`` and sigmoid
  (``utils/fp.py``), ``2 ** x`` as glibc's ``exp2f`` (XLA's CPU code
  calls it), ``log2`` as ``log(x) * f32(1/ln 2)``, the ideal DCG summed
  as XLA's CPU reduction fuses it.

Weights apply only per row (a vector of one weight a group is ignored,
as the reference's objective ignores it; the metrics read it).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.lambdarank_cuda import GroupLayout, lambdarank_topk, sorted_order
from ..utils import random as xrandom
from ..utils.fp import daz, fma_f32, ftz, log_f32, sigmoid_f32, sum_f32
from ..utils.libm import exp2f
from . import ObjFunction, register_objective

# f32 of 1 / ln 2: XLA's rewrite of log(x) / log(2)
_INV_LN2 = 1.44269502162933349609375


def _true(params, key, default):
    return str(params.get(key, default)).lower() in ("1", "true")


class _LambdaRankBase(ObjFunction):
    def __init__(self, params):
        super().__init__(params)
        # reference defaults (ranking_utils.h LambdaRankParam)
        self.pair_method = str(params.get("lambdarank_pair_method", "topk"))
        if self.pair_method not in ("topk", "mean"):
            raise ValueError(
                f"lambdarank_pair_method must be 'topk' or 'mean', got "
                f"{self.pair_method!r}")
        self.num_pair = int(params.get(
            "lambdarank_num_pair_per_sample",
            32 if self.pair_method == "topk" else 1))
        self.group_norm = _true(params, "lambdarank_normalization", "1")
        if _true(params, "lambdarank_unbiased", "0"):
            raise NotImplementedError(
                "lambdarank_unbiased=True (position-bias debiasing) is not "
                "supported yet")
        self.score_norm = _true(params, "lambdarank_score_normalization", "1")
        self._group_ptr = None
        self._layouts: dict = {}

    def set_group_info(self, group_ptr) -> None:
        self._group_ptr = np.asarray(group_ptr, np.int64)
        self._layouts = {}

    def layout(self, device) -> GroupLayout:
        """The query groups on ``device`` (made once per device)."""
        if self._group_ptr is None:
            raise ValueError(f"{self.name} requires group/qid information")
        key = str(device)
        if key not in self._layouts:
            self._layouts[key] = GroupLayout(self._group_ptr, device)
        return self._layouts[key]

    def default_metric(self):
        return "ndcg"

    def _use_ndcg_weight(self) -> bool:
        return True

    def get_gradient(self, preds, labels, weights, iteration: int = 0):
        layout = self.layout(preds.device)
        pred = (preds[:, 0] if preds.dim() == 2 else preds).to(torch.float32)
        y = labels.to(torch.float32)
        if self.pair_method == "topk":
            gp = lambdarank_topk(pred.contiguous(), y.contiguous(), layout,
                                 self.num_pair, self._use_ndcg_weight(),
                                 self.score_norm, self.group_norm)
        else:
            gp = lambda_gradients_mean(pred, y, layout, iteration,
                                       self.num_pair,
                                       self._use_ndcg_weight(),
                                       self.group_norm)
        if weights is not None and weights.shape[0] == gp.shape[0]:
            gp = ftz(gp * ftz(weights.to(torch.float32))[:, None, None])
        return gp


def _log2_xla(x):
    return log_f32(x) * _INV_LN2


def _pow2_xla(x):
    """XLA's ``2.0 ** x``: a call of glibc's exp2f, in a program that runs
    with denormals flushed."""
    return ftz(exp2f(daz(x)))


def _idcg_xla(ideal, idisc):
    """max(sum(ideal * idisc, axis=1), 1e-10) as XLA's CPU code sums it:
    up to 32 values one chain of fused multiply-adds; above, the products
    rounded and summed in jnp.sum's order."""
    if ideal.shape[1] <= 32:
        acc = ideal[:, 0] * idisc[0]
        for j in range(1, ideal.shape[1]):
            acc = fma_f32(ideal[:, j], idisc[j], acc)
    else:
        acc = sum_f32(ideal * idisc[None, :], dim=1)
    return torch.clamp(acc, min=1e-10)


def lambda_gradients_mean(pred, y, layout: GroupLayout, iteration: int,
                          num_pair: int, ndcg_weight: bool,
                          group_norm: bool = True):
    """The reference's mean-method gradients (objective/ranking.py:285-349)
    in XLA's bits, as (R, 1, 2) f32: per doc, ``num_pair`` partners drawn
    uniformly in its group (threefry, key ``PRNGKey(iteration)``), the
    better doc's lambda -sig |delta ndcg| and the worse's sig_w |delta
    ndcg|, the doubled hessians; the sums over draws divided by
    ``num_pair``."""
    R = pred.shape[0]
    dev = pred.device
    G, S = layout.G, layout.S
    out = torch.zeros((R, 1, 2), dtype=torch.float32, device=dev)
    if G == 0 or layout.r_g == 0:
        return out
    gmask, gidx = layout.vpos, layout.pidx
    s = torch.where(gmask, pred[gidx], torch.full_like(pred[gidx],
                                                       float("-inf")))
    rel = torch.where(gmask, y[gidx], torch.zeros_like(s))
    # ranks by score, descending and stable (-0.0 as +0.0)
    row_gid = torch.arange(G, device=dev)[:, None].expand(G, S).reshape(-1)
    order = sorted_order(s.reshape(-1), row_gid).reshape(G, S) \
        - torch.arange(G, device=dev)[:, None] * S
    inv = torch.argsort(order, dim=1)
    ranks = (inv + 1).to(torch.float32)
    p2 = _pow2_xla(rel)
    gain = torch.where(gmask, p2 - 1.0, torch.zeros_like(s))
    ideal = torch.flip(torch.sort(gain, dim=1).values, dims=[1])
    one = torch.ones((), dtype=torch.float32, device=dev)
    idisc = torch.div(one, _log2_xla(
        torch.arange(S, dtype=torch.float32, device=dev) + 2.0))
    idcg = _idcg_xla(ideal, idisc)
    disc = torch.div(one, _log2_xla(ranks + 1.0))
    sizes = layout.sizes.to(torch.int64)
    key = xrandom.prng_key(iteration)
    grad = hess = None
    for _ in range(num_pair):
        key, sub = xrandom.split(key)
        j = xrandom.randint(sub, G * S, 0, max(S, 1), dev).reshape(G, S) \
            % torch.clamp(sizes, min=1)[:, None]
        s_j = s.gather(1, j)
        rel_j = rel.gather(1, j)
        better = rel > rel_j
        worse = rel < rel_j
        sig = sigmoid_f32(-(s - s_j))
        sig_w = sigmoid_f32(-(s_j - s))
        if ndcg_weight:
            dg = torch.abs((p2 - p2.gather(1, j))
                           * (disc - disc.gather(1, j))) / idcg[:, None]
        else:
            dg = torch.ones_like(s)
        lam_b = ftz(-sig * dg)
        lam_w = ftz(sig_w * dg)
        h_b = torch.clamp(ftz(ftz(sig * (1.0 - sig)) * dg), min=1e-16) * 2.0
        h_w = torch.clamp(ftz(ftz(sig_w * (1.0 - sig_w)) * dg),
                          min=1e-16) * 2.0
        zero = torch.zeros_like(s)
        g_b = torch.where(better & gmask, lam_b, zero)
        g_w = torch.where(worse & gmask, lam_w, zero)
        h = torch.where((better | worse) & gmask,
                        torch.where(better, h_b, h_w), zero)
        # XLA folds the first round's 0 + x into x
        grad = g_b + g_w if grad is None else (grad + g_b) + g_w
        hess = h if hess is None else hess + h
    if grad is None:  # no pairs drawn
        grad = hess = torch.zeros_like(s)
    if group_norm and num_pair != 1:
        # XLA divides by a constant as a product with its f32 reciprocal
        with np.errstate(divide="ignore"):
            inv_n = float(np.float32(1.0) / np.float32(num_pair))
        grad, hess = ftz(grad * inv_n), ftz(hess * inv_n)
    out[gidx[gmask], 0, 0] = grad[gmask]
    out[gidx[gmask], 0, 1] = hess[gmask]
    return out


@register_objective("rank:ndcg")
class LambdaRankNDCG(_LambdaRankBase):
    pass


@register_objective("rank:pairwise")
class LambdaRankPairwise(_LambdaRankBase):
    def _use_ndcg_weight(self):
        return False

    def default_metric(self):
        return "map"


@register_objective("rank:map")
class LambdaRankMAP(_LambdaRankBase):
    def _use_ndcg_weight(self):
        return False

    def default_metric(self):
        return "map"
