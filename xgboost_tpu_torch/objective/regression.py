"""Regression / binary objectives (port of the ``reg:squarederror`` and
``binary:logistic`` part of xgboost_tpu/objective/regression.py;
reference: src/objective/regression_obj.cu).

squarederror: grad = pred - y, hess = 1.  logistic: grad = sigmoid(x) - y,
hess = max(p(1-p), 1e-16), both scaled by scale_pos_weight on positive rows;
the sigmoid is XLA's and the arithmetic XLA's op by op (the plain version
ops/sigmoid_cuda.py logistic_gradient_plain on the CPU, the kernel K4 on
the card), so the gradients are the reference's bits at every round.

With ``num_target`` = K > 1 both take (R, K) margins and labels and give
(R, K, 2) pairs, elementwise (multi-output regression and multi-label
classification, reference regression.py:33-47); the row weight multiplies
every target of its row.
"""
from __future__ import annotations

import torch

from ..ops.sigmoid_cuda import logistic_gradient, sigmoid
from ..utils.fp import sum_f32
from . import ObjFunction, register_objective


def _pack(grad, hess, weights):
    """(R,) or (R, K) pairs -> (R, K, 2), weighted by row."""
    if weights is not None:
        w = weights.reshape(-1, *([1] * (grad.ndim - 1)))
        grad, hess = grad * w, hess * w
    if grad.ndim == 1:
        grad, hess = grad[:, None], hess[:, None]
    return torch.stack([grad, hess], dim=-1).to(torch.float32)


class _Elementwise(ObjFunction):
    def _grad(self, pred, y):  # -> (grad, hess), elementwise
        raise NotImplementedError

    def n_groups(self) -> int:
        # one output column per target (LearnerModelParam num_target)
        return max(int(self.params.get("num_target", 1) or 1), 1)

    def get_gradient(self, preds, labels, weights):
        if self.n_groups() > 1:
            y = labels.to(torch.float32).reshape(labels.shape[0], -1)
            return _pack(*self._grad(preds, y), weights)
        pred = preds[:, 0] if preds.ndim == 2 else preds
        g, h = self._grad(pred, labels.to(torch.float32))
        return _pack(g, h, weights)


@register_objective("reg:squarederror")
class SquaredError(_Elementwise):
    def _grad(self, pred, y):
        return pred - y, torch.ones_like(pred)

    def init_estimation(self, labels, weights):
        # the sums in jnp.sum's order, so the mean is the reference's bits
        if labels.ndim == 2:  # the per-target mean (fit_stump.cc)
            w = (torch.ones(labels.shape[0], device=labels.device)
                 if weights is None else weights).to(torch.float32)
            return sum_f32(labels * w[:, None], dim=0) / torch.clamp(
                sum_f32(w), min=1e-6)
        w = torch.ones_like(labels) if weights is None else weights
        return sum_f32(labels * w) / torch.clamp(sum_f32(w), min=1e-6)


@register_objective("binary:logistic")
class BinaryLogistic(_Elementwise):
    def get_gradient(self, preds, labels, weights):
        # one K4 launch on the card (ops/sigmoid_cuda.py); K targets go
        # through it flattened, each row's weight repeated K times
        spw = float(self.params.get("scale_pos_weight", 1.0))
        K = self.n_groups()
        if K > 1:
            R = preds.shape[0]
            w = None if weights is None else \
                weights.to(torch.float32).repeat_interleave(K)
            out = logistic_gradient(
                preds.reshape(-1).contiguous(),
                labels.to(torch.float32).reshape(-1).contiguous(), w, spw)
            return out.reshape(R, K, 2)
        pred = preds[:, 0] if preds.ndim == 2 else preds
        return logistic_gradient(pred, labels.to(torch.float32), weights,
                                 spw)

    def pred_transform(self, margin):
        return sigmoid(margin)

    def prob_to_margin(self, prob):
        p = torch.clamp(prob, 1e-7, 1 - 1e-7)
        return torch.log(p / (1 - p))

    def margin_to_prob(self, margin):
        return sigmoid(margin)

    def default_metric(self):
        return "logloss"
