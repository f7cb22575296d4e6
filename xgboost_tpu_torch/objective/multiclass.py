"""Multiclass objectives (port of xgboost_tpu/objective/multiclass.py;
reference src/objective/multiclass_obj.cu SoftmaxMultiClassObj).

p = softmax(margin) over the K classes, grad_k = p_k - [y == k],
hess_k = max(2 p_k (1 - p_k), 1e-16), both times the row's weight.  The
softmax is XLA's (``utils/fp.py:softmax_f32``) and every product is
flushed as XLA's CPU programs flush it, so the gradients are the
reference's bits on the CPU and on the card; the same PyTorch operations
run on both.
"""
from __future__ import annotations

import torch

from ..utils.fp import ftz, softmax_f32
from . import ObjFunction, register_objective


class _SoftmaxBase(ObjFunction):
    def __init__(self, params):
        super().__init__(params)
        self.num_class = int(params.get("num_class", 0))
        if self.num_class < 2:
            raise ValueError(f"{self.name} requires num_class >= 2")

    def n_groups(self):
        return self.num_class

    def get_gradient(self, preds, labels, weights):
        K = self.num_class
        p = softmax_f32(preds.to(torch.float32))  # (R, K)
        cls = torch.arange(K, device=preds.device)
        y = (labels.to(torch.int32)[:, None] == cls[None, :]).to(
            torch.float32)
        grad = ftz(p - y)
        hess = torch.clamp(ftz(ftz(2.0 * p) * ftz(1.0 - p)), min=1e-16)
        if weights is not None:
            w = ftz(weights.to(torch.float32))[:, None]
            grad, hess = ftz(grad * w), ftz(hess * w)
        return torch.stack([grad, hess], dim=-1)

    def init_estimation(self, labels, weights):
        return torch.zeros(self.num_class, dtype=torch.float32)

    def default_metric(self):
        return "mlogloss"


@register_objective("multi:softprob")
class SoftProb(_SoftmaxBase):
    def pred_transform(self, margin):
        return softmax_f32(margin.to(torch.float32))


@register_objective("multi:softmax")
class SoftMax(_SoftmaxBase):
    def pred_transform(self, margin):
        return torch.argmax(margin, dim=1).to(torch.float32)

    def default_metric(self):
        return "merror"
