"""Regression / binary objectives (port of the ``reg:squarederror`` and
``binary:logistic`` part of xgboost_tpu/objective/regression.py;
reference: src/objective/regression_obj.cu).

squarederror: grad = pred - y, hess = 1.  logistic: grad = sigmoid(x) - y,
hess = max(p(1-p), 1e-16), both scaled by scale_pos_weight on positive rows;
the sigmoid is XLA's and the arithmetic XLA's op by op (the plain version
ops/sigmoid_cuda.py logistic_gradient_plain on the CPU, the kernel K4 on
the card), so the gradients are the reference's bits at every round.
"""
from __future__ import annotations

import torch

from ..ops.sigmoid_cuda import logistic_gradient, sigmoid
from ..utils.fp import sum_f32
from . import ObjFunction, register_objective


def _pack(grad, hess, weights):
    if weights is not None:
        grad, hess = grad * weights, hess * weights
    return torch.stack([grad, hess], dim=-1)[:, None, :].to(torch.float32)


class _Elementwise(ObjFunction):
    def _grad(self, pred, y):  # -> (grad, hess), elementwise
        raise NotImplementedError

    def get_gradient(self, preds, labels, weights):
        pred = preds[:, 0] if preds.ndim == 2 else preds
        g, h = self._grad(pred, labels.to(torch.float32))
        return _pack(g, h, weights)


@register_objective("reg:squarederror")
class SquaredError(_Elementwise):
    def _grad(self, pred, y):
        return pred - y, torch.ones_like(pred)

    def init_estimation(self, labels, weights):
        w = torch.ones_like(labels) if weights is None else weights
        # the sums in jnp.sum's order, so the mean is the reference's bits
        return sum_f32(labels * w) / torch.clamp(sum_f32(w), min=1e-6)


@register_objective("binary:logistic")
class BinaryLogistic(ObjFunction):
    def get_gradient(self, preds, labels, weights):
        # one K4 launch on the card (ops/sigmoid_cuda.py)
        pred = preds[:, 0] if preds.ndim == 2 else preds
        return logistic_gradient(
            pred, labels.to(torch.float32), weights,
            float(self.params.get("scale_pos_weight", 1.0)))

    def pred_transform(self, margin):
        return sigmoid(margin)

    def prob_to_margin(self, prob):
        p = torch.clamp(prob, 1e-7, 1 - 1e-7)
        return torch.log(p / (1 - p))

    def margin_to_prob(self, margin):
        return sigmoid(margin)

    def default_metric(self):
        return "logloss"
