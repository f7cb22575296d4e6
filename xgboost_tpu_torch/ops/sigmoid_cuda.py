"""XLA's f32 logistic on the card: the wrapper of K4 (csrc/sigmoid.cu) and
the dispatcher the binary:logistic objective calls.

``sigmoid`` sends a CPU tensor to the plain version, ``utils/fp.py:
sigmoid_f32`` (XLA's exponential as PyTorch operations, about 150 of them),
and a CUDA tensor to K4, which computes the same bits in one launch.  Each
launch is counted in ``hist_cuda.launches["sigmoid"]``.
"""
from __future__ import annotations

import torch

from ..utils.fp import sigmoid_f32
from .hist_cuda import launched, load_library

__all__ = ["sigmoid", "sigmoid_cuda"]


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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.xtb_sigmoid(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    launched("sigmoid", lib, rc)
    return out


def sigmoid(x):
    """XLA's f32 sigmoid: the plain version for a CPU tensor, K4 for a CUDA
    tensor (which raises if it cannot run)."""
    return sigmoid_cuda(x) if x.is_cuda else sigmoid_f32(x)
