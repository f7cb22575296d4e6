"""f32 arithmetic in the rounding of the reference's compiled programs.

XLA on the CPU fuses some multiply-adds and computes ``exp`` with its own
polynomial, so PyTorch's operators do not give the reference's bits there.
These functions do, on any device, in plain PyTorch operations:

- ``fma_f32``: a * b + c rounded once (a fused multiply-add);
- ``exp_f32``: XLA's f32 exponential (the Cephes range reduction with the
  exponent capped at 127, and polynomial, every multiply-add fused), with
  results below the smallest normal f32 flushed to zero, as XLA's CPU
  programs run: bitwise with XLA over every f32 of [-104, -87] and
  [87, 88.8] (tests/test_torch_split_scan.py), and the clamps beyond;
- ``sum_f32``: ``jnp.sum`` of f32 values in XLA's CPU order;
- ``softmax_f32``: ``jax.nn.softmax`` over the class axis, from the two;
- ``ftz``: the flush of a result below the smallest normal f32;
- ``sqrt_f32``: the correctly rounded square root, as XLA computes it
  (PyTorch's CPU kernel is off by an ulp for some inputs).
"""
from __future__ import annotations

import torch

FLT_MIN = 1.1754943508222875e-38
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def fma_f32(a, b, c):
    """a * b + c for f32 tensors (or numbers), rounded once to f32 (musl's
    fmaf: the f64 sum is exact but for one rounding, corrected where it
    lands halfway between two f32 values)."""
    like = next(t for t in (a, b, c) if isinstance(t, torch.Tensor))
    a, b, c = (torch.as_tensor(t, dtype=torch.float32,
                               device=like.device).double()
               for t in (a, b, c))
    xy = a * b  # exact: 24 + 24 significant bits
    s = xy + c
    bits = s.view(torch.int64)
    halfway = (bits & 0x1FFFFFFF) == 0x10000000
    exact = ((s - xy) == c) & ((s - c) == xy)
    fix = halfway & ~exact & torch.isfinite(s)
    neg = bits < 0
    err = torch.where(neg == (c > xy), xy - s + c, c - s + xy)
    bumped = (bits + torch.where(neg == (err < 0), 1, -1)).view(torch.float64)
    return torch.where(fix, bumped, s).float()


def exp_f32(x):
    """exp(x) of an f32 tensor as XLA computes it on the CPU."""
    x = torch.clamp(x, -104.0, 88.8)
    n = torch.floor(fma_f32(x, 1.44269504088896341, 0.5))
    n = torch.clamp(n, max=127.0)  # XLA's cap: 2**n stays a normal f32
    r = fma_f32(n, -0.693359375, x)
    r = fma_f32(n, 2.12194440e-4, r)
    y = fma_f32(r, _EXP_POLY[0], _EXP_POLY[1])
    for k in _EXP_POLY[2:]:
        y = fma_f32(y, r, k)
    y = 1.0 + fma_f32(y, r * r, r)
    # 2**n as two factors, so that n down to -150 fits the exponent field
    ni = n.to(torch.int32)
    lo = ni // 2
    out = y * ((lo + 127) << 23).view(torch.float32) \
        * ((ni - lo + 127) << 23).view(torch.float32)
    return torch.where(out < FLT_MIN, torch.zeros_like(out), out)


def ftz(v):
    """XLA's flush of an f32 result below the smallest normal f32 to zero,
    keeping its sign (its CPU programs run with denormals flushed)."""
    return torch.where(v.abs() < FLT_MIN, v * 0.0, v)


def softmax_f32(x):
    """jax.nn.softmax(x, axis=1) of an (R, K) f32 tensor as XLA computes it
    on the CPU: the row's max subtracted, XLA's exponential, the sum in
    jnp.sum's order and one division, flushed."""
    e = exp_f32(x - x.amax(dim=1, keepdim=True))
    return ftz(e / sum_f32(e, dim=1)[:, None])


def sigmoid_f32(x):
    """1 / (1 + exp(-x)) as XLA computes jax.nn.sigmoid on the CPU: its
    exponential, and a result below the smallest normal f32 flushed to
    zero."""
    out = torch.div(torch.ones_like(x), 1.0 + exp_f32(-x))
    return torch.where(out < FLT_MIN, torch.zeros_like(out), out)


# XLA's CPU compiler rewrites a reduction over more than this many values
# into a reduce-window of this size followed by the reduction of the window
# sums (its TreeReductionRewriter)
SUM_WINDOW = 32


def _sum_windows(x):
    """Sequential f32 sums from 0.0 over the last axis."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def sum_f32(x, dim: int = 0):
    """Sum of an f32 tensor along ``dim`` in the order of ``jnp.sum`` on
    XLA's CPU: above 32 values, the axis is zero-padded to a multiple of 32
    with half the padding in front (the reduce-window's SAME padding),
    each window of 32 summed sequentially from 0.0, and the window sums
    reduced the same way, recursively; 32 values or fewer are summed
    sequentially."""
    x = x.to(torch.float32).movedim(dim, -1)
    while x.shape[-1] > SUM_WINDOW:
        n = x.shape[-1]
        pad = -n % SUM_WINDOW
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = _sum_windows(x.reshape(*x.shape[:-1], -1, SUM_WINDOW))
    return _sum_windows(x)


def sqrt_f32(x):
    """sqrt of an f32 tensor, correctly rounded: taken in f64 and rounded
    once to f32, which is exact for a square root (53 >= 2 * 24 + 2
    bits)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)
