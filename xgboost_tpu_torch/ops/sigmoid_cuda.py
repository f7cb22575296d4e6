"""XLA's f32 logistic on the card: the wrappers of K4 (csrc/sigmoid.cu) and
the dispatchers the binary:logistic objective calls.

``sigmoid`` sends a CPU tensor to the plain version, ``utils/fp.py:
sigmoid_f32`` (XLA's exponential as PyTorch operations, about 150 of them),
and a CUDA tensor to K4's sigmoid entry, which computes the same bits in
one launch.  ``logistic_gradient`` does the same for the binary:logistic
gradient pairs: ``logistic_gradient_plain`` on the CPU, K4's gradient
entry (one launch, one pass over the rows) on the card.  Each launch of
either entry is counted in ``hist_cuda.launches["sigmoid"]``.
"""
from __future__ import annotations

import torch

from ..utils.fp import ftz, sigmoid_f32
from .hist_cuda import launched, load_library, on_device

__all__ = ["logistic_gradient", "logistic_gradient_cuda",
           "logistic_gradient_plain", "sigmoid", "sigmoid_cuda"]


def sigmoid_cuda(x):
    """Launch K4: 1 / (1 + exp(-x)) of an f32 tensor on its card, as XLA
    computes jax.nn.sigmoid on the CPU.  A launch the card refuses
    raises."""
    if not x.is_cuda:
        raise ValueError("the sigmoid kernel needs a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"the sigmoid kernel takes float32, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = load_library("sigmoid")
    rc = on_device(x.device, lib.xtb_sigmoid, x.data_ptr(), out.data_ptr(),
                   x.numel())
    launched("sigmoid", lib, rc)
    return out


def sigmoid(x):
    """XLA's f32 sigmoid: the plain version for a CPU tensor, K4 for a CUDA
    tensor (which raises if it cannot run)."""
    return sigmoid_cuda(x) if x.is_cuda else sigmoid_f32(x)


def logistic_gradient_plain(margin, label, weight=None,
                            scale_pos_weight: float = 1.0):
    """K4's gradient entry as PyTorch operations: the (R, 1, 2) f32
    (grad, hess) pairs of binary:logistic for margins, labels and optional
    weights (R,), each operation rounded alone and flushed as XLA's CPU
    programs run (xgboost_tpu/objective/regression.py:115-119, _pack):
    p = sigmoid(x), w = spw where y == 1 else 1, grad = (p - y) w,
    hess = max(p (1 - p), 1e-16) w, both times the weight."""
    y = ftz(label.to(torch.float32))
    p = sigmoid_f32(margin)
    w = torch.where(y == 1.0, scale_pos_weight, 1.0)
    g = ftz(ftz(p - y) * w)
    h = ftz(torch.clamp(p * (1 - p), min=1e-16) * w)
    if weight is not None:
        wt = ftz(weight)
        g, h = ftz(g * wt), ftz(h * wt)
    return torch.stack([g, h], dim=-1)[:, None, :]


def logistic_gradient_cuda(margin, label, weight=None,
                           scale_pos_weight: float = 1.0):
    """Launch K4's gradient entry: what ``logistic_gradient_plain``
    computes, in one pass over the rows of the inputs' card.  A launch the
    card refuses raises."""
    tensors = (margin, label) + (() if weight is None else (weight,))
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the logistic gradient kernel needs CUDA tensors")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("margin, label and weight must be float32")
    R = margin.shape[0]
    if margin.dim() != 1 or any(tuple(t.shape) != (R,) for t in tensors) \
            or any(t.device != margin.device for t in tensors):
        raise ValueError("margin, label and weight must be (R,) on one "
                         "device")
    margin, label = margin.contiguous(), label.contiguous()
    if weight is not None:
        weight = weight.contiguous()
    out = torch.empty((R, 1, 2), dtype=torch.float32, device=margin.device)
    if R == 0:
        return out
    lib = load_library("sigmoid")
    rc = on_device(margin.device, lib.xtb_logistic_grad, margin.data_ptr(),
                   label.data_ptr(),
                   None if weight is None else weight.data_ptr(),
                   float(scale_pos_weight), out.data_ptr(), R)
    launched("sigmoid", lib, rc)
    return out


def logistic_gradient(margin, label, weight=None,
                      scale_pos_weight: float = 1.0):
    """The binary:logistic gradient pairs (R, 1, 2): the plain version for
    a CPU tensor, K4 for a CUDA tensor (which raises if it cannot run)."""
    fn = logistic_gradient_cuda if margin.is_cuda else logistic_gradient_plain
    return fn(margin, label, weight, scale_pos_weight)
