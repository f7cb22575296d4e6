"""Regression / binary objectives (port of the ``reg:squarederror`` and
``binary:logistic`` part of xgboost_tpu/objective/regression.py;
reference: src/objective/regression_obj.cu).

squarederror: grad = pred - y, hess = 1.  logistic: grad = sigmoid(x) - y,
hess = max(p(1-p), 1e-16), both scaled by scale_pos_weight on positive rows.
"""
from __future__ import annotations

import torch

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
        return (labels * w).sum() / torch.clamp(w.sum(), min=1e-6)


@register_objective("binary:logistic")
class BinaryLogistic(_Elementwise):
    def _grad(self, pred, y):
        p = torch.sigmoid(pred)
        spw = float(self.params.get("scale_pos_weight", 1.0))
        w = torch.where(y == 1.0, spw, 1.0)
        return (p - y) * w, torch.clamp(p * (1 - p), min=1e-16) * w

    def pred_transform(self, margin):
        return torch.sigmoid(margin)

    def prob_to_margin(self, prob):
        p = torch.clamp(prob, 1e-7, 1 - 1e-7)
        return torch.log(p / (1 - p))

    def margin_to_prob(self, margin):
        return torch.sigmoid(margin)

    def default_metric(self):
        return "logloss"
