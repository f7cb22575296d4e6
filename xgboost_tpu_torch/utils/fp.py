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
  (PyTorch's CPU kernel is off by an ulp for some inputs);
- ``log_f32``, ``log1p_f32``, ``erf_f32``: XLA's CPU ``log`` (the Cephes
  range reduction and polynomial), ``log1p`` (a rational polynomial below
  sqrt(2) - 1, else the log of 1 + x) and ``erf`` (a clamped rational
  polynomial), each with the multiply-adds that XLA's CPU code fuses;
- ``cumsum_f32``: ``jnp.cumsum`` of f32 values in XLA's CPU order.

XLA's CPU programs also treat an input below the smallest normal f32 as
zero (``daz``), and these functions do the same.
"""
from __future__ import annotations

import torch

FLT_MIN = 1.1754943508222875e-38
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _f64(v):
    """An f32 tensor, or a number rounded to f32, in f64: numbers stay
    Python floats, so no constant is copied to the device."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).double()
    return float(torch.tensor(v, dtype=torch.float32))


def fma_f32(a, b, c):
    """a * b + c for f32 tensors (or numbers), rounded once to f32 (musl's
    fmaf: the f64 sum is exact but for one rounding, corrected where it
    lands halfway between two f32 values)."""
    like = next(t for t in (a, b, c) if isinstance(t, torch.Tensor))
    a, b, c = _f64(a), _f64(b), _f64(c)
    xy = a * b  # exact: 24 + 24 significant bits
    s = xy + c
    if not isinstance(s, torch.Tensor):
        s = torch.full_like(like, s, dtype=torch.float64)
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


def true_div(x, c):
    """x / c for an f32 tensor x and a number c, rounded as a division on
    every device: for a number divisor PyTorch's CUDA kernel multiplies by
    its reciprocal instead, which can round the quotient differently."""
    return x / x.new_full((), c)


def sqrt_f32(x):
    """sqrt of an f32 tensor, correctly rounded: taken in f64 and rounded
    once to f32, which is exact for a square root (53 >= 2 * 24 + 2
    bits)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def daz(x):
    """XLA's CPU treatment of an f32 input below the smallest normal f32:
    a zero of its sign (its programs run with denormal inputs as zero)."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


_LOG_P = (0.070376836, -0.1151461, 0.116769984, -0.12420141, 0.14249323,
          -0.16668057, 0.20000714, -0.24999994, 0.3333333)
_SQRT_HALF = 0.70710677


def _log_core(x):
    """XLA's f32 log of x > 0 before its special cases: x below the
    smallest normal is taken as it; the mantissa in [0.5, 1), moved to
    [sqrt(1/2), sqrt(2)) with the exponent, and Cephes' polynomial of
    degree 9, its multiply-adds fused as XLA's CPU code fuses them."""
    x = torch.where(x > FLT_MIN, x, torch.full_like(x, FLT_MIN))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)
    low = m < _SQRT_HALF
    xm = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(torch.float32)
    x2 = xm * xm
    x3 = x2 * xm
    p = _LOG_P
    y = fma_f32(xm, p[0], p[1])
    y1 = fma_f32(xm, p[3], p[4])
    y2 = fma_f32(xm, p[6], p[7])
    y = fma_f32(y, xm, p[2])
    y1 = fma_f32(y1, xm, p[5])
    y2 = fma_f32(y2, xm, p[8])
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, e * -0.00021219444)
    r = (xm - 0.5 * x2) + y
    return fma_f32(e, 0.6933594, r)


def _log_specials(x, core):
    """log's special cases: -inf at zero, +inf at +inf, NaN below zero
    and at NaN."""
    out = torch.where(x > 0, core, torch.full_like(core, float("nan")))
    out = torch.where(x == 0, torch.full_like(core, float("-inf")), out)
    return torch.where(x == float("inf"), x, out)


def log_f32(x):
    """log(x) of an f32 tensor as XLA computes it on the CPU."""
    x = daz(x)
    return _log_specials(x, _log_core(x))


_LOG1P_P = (15.062909, 83.04757, 221.7624, 309.09872, 216.42789, 60.11866)
_LOG1P_Q = (4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967,
            57.112965, 20.039553)


def log1p_f32(x):
    """log(1 + x) of an f32 tensor as XLA computes it on the CPU: for
    |x| < sqrt(2) - 1, x - x^2/2 + x^3 Q(x)/P(x) (Horner, fused), else
    XLA's log of the rounded 1 + x."""
    x = daz(x)
    xp1 = x + 1.0
    big = _log_specials(xp1, _log_core(xp1))
    p = x + _LOG1P_P[0]
    for c in _LOG1P_P[1:]:
        p = fma_f32(p, x, c)
    q = fma_f32(x, _LOG1P_Q[0], _LOG1P_Q[1])
    for c in _LOG1P_Q[2:]:
        q = fma_f32(q, x, c)
    x2 = x * x
    small = x + fma_f32(x2, -0.5, (x * x2) * (q / p))
    return torch.where(x.abs() < 0.41421357, small, big)


_ERF_CLAMP = 3.7439213
_ERF_P = (0.00022905065, 0.003408291, 0.050955694, 0.18520832, 1.1283791)
_ERF_Q = (-1.1791603e-07, 2.3547966e-05, 0.0010179626, 0.01407047,
          0.11098505, 0.49746925, 1.0)


def erf_f32(x):
    """erf(x) of an f32 tensor as XLA computes jax.lax.erf on the CPU:
    x clamped to +-3.7439213, x P(x^2) / Q(x^2) with fused multiply-adds,
    the quotient flushed."""
    x = torch.clamp(daz(x), -_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    p = fma_f32(x2, _ERF_P[0], _ERF_P[1])
    for c in _ERF_P[2:]:
        p = fma_f32(p, x2, c)
    q = fma_f32(x2, _ERF_Q[0], _ERF_Q[1])
    for c in _ERF_Q[2:]:
        q = fma_f32(q, x2, c)
    return ftz((x * p) / q)


# XLA's CPU compiler rewrites a cumulative sum over more than this many
# values into prefix sums of blocks of this size, and adds to each block
# the cumulative sum of the blocks before it (its ReduceWindowRewriter)
SCAN_BLOCK = 16


def _prefix_seq(x):
    """Sequential f32 prefix sums from 0.0 over the last axis."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def cumsum_f32(x):
    """``jnp.cumsum`` of a 1-D f32 tensor in the order of XLA's CPU: up to
    16 values a sequential prefix from 0.0; above, the values zero-padded
    at the end to blocks of 16, each block's sequential prefix, plus the
    cumulative sum of the earlier blocks' totals (recursively, the
    same way)."""
    x = x.to(torch.float32)
    n = x.shape[0]
    if n <= SCAN_BLOCK:
        return _prefix_seq(x)
    blocks = torch.nn.functional.pad(x, (0, -n % SCAN_BLOCK)).reshape(
        -1, SCAN_BLOCK)
    pre = _prefix_seq(blocks)
    tot = cumsum_f32(pre[:, -1])
    before = torch.cat([tot.new_zeros(1), tot[:-1]])
    return (pre + before[:, None]).reshape(-1)[:n]
