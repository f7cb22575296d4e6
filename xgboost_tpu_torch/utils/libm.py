"""glibc's ``expf``, ``exp2f`` and ``log2f`` in PyTorch operations, so that
the same bits come out on the CPU and on the card.

The reference's native ranking kernel (``native/xtb_kernels.h``,
``xtb_lambdarank_topk_impl``) calls these three functions of the host's
glibc (2.36), and XLA's CPU code lowers ``2.0 ** x`` to a call of
``exp2f``.  On an x86-64 CPU with FMA, glibc resolves each to its FMA
variant (``sysdeps/x86_64/fpu/multiarch/e_expf-fma.c`` and the like): a
table and a polynomial evaluated in double, rounded once to float.  The
constants below are read from ``libm.so.6``'s read-only data, and the
multiply-adds that its machine code fuses are fused here (``fma64``); the
other operations are single double operations.  The special cases follow
the same code: overflow to +inf, underflow to 0 or (just above
2^-150) to the least subnormal, NaN quieted, and x86's default NaN
(0xFFC00000) for the log of a negative number.

``fma64`` rounds a * b + c once: the exact product as two doubles
(Veltkamp's split and Dekker's product), the exact sum with c (TwoSum),
and the two low parts added with rounding to odd before the last
rounding to nearest (Boldo and Melquiond, "Emulation of FMA and
correctly rounded sums", IEEE TC 2008).  ``scripts/libm_exhaustive.py``
compares the three functions with glibc's over every f32 input.

``csrc/lambdarank.cu`` (K5) writes the same arithmetic in CUDA doubles
with ``__fma_rn``.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_SPLIT = 134217729.0  # 2**27 + 1: Veltkamp's splitter for doubles

# __exp2f_data: 2^(i/32) with i << 47 taken off its bits
EXP2F_TAB = (
    0x3FF0000000000000, 0x3FEFD9B0D3158574, 0x3FEFB5586CF9890F,
    0x3FEF9301D0125B51, 0x3FEF72B83C7D517B, 0x3FEF54873168B9AA,
    0x3FEF387A6E756238, 0x3FEF1E9DF51FDEE1, 0x3FEF06FE0A31B715,
    0x3FEEF1A7373AA9CB, 0x3FEEDEA64C123422, 0x3FEECE086061892D,
    0x3FEEBFDAD5362A27, 0x3FEEB42B569D4F82, 0x3FEEAB07DD485429,
    0x3FEEA47EB03A5585, 0x3FEEA09E667F3BCD, 0x3FEE9F75E8EC5F74,
    0x3FEEA11473EB0187, 0x3FEEA589994CCE13, 0x3FEEACE5422AA0DB,
    0x3FEEB737B0CDC5E5, 0x3FEEC49182A3F090, 0x3FEED503B23E255D,
    0x3FEEE89F995AD3AD, 0x3FEEFF76F2FB5E47, 0x3FEF199BDD85529C,
    0x3FEF3720DCEF9069, 0x3FEF5818DCFBA487, 0x3FEF7C97337B9B5F,
    0x3FEFA4AFA2A490DA, 0x3FEFD0765B6E4540)
EXP2F_SHIFT = float.fromhex("0x1.8p+47")   # 0x1.8p52 / 32
EXP2F_POLY = (float.fromhex("0x1.c6af84b912394p-5"),
              float.fromhex("0x1.ebfce50fac4f3p-3"),
              float.fromhex("0x1.62e42ff0c52d6p-1"))
EXPF_SHIFT = float.fromhex("0x1.8p+52")
EXPF_INVLN2N = float.fromhex("0x1.71547652b82fep+5")  # 32 / ln 2
EXPF_POLY = (float.fromhex("0x1.c6af84b912394p-20"),
             float.fromhex("0x1.ebfce50fac4f3p-13"),
             float.fromhex("0x1.62e42ff0c52d6p-6"))
EXPF_OFLOW = float.fromhex("0x1.62e42ep+6")     # above: +inf
EXPF_UFLOW = float.fromhex("-0x1.9fe368p+6")    # below: 0
EXPF_MAY_UFLOW = float.fromhex("-0x1.9d1d9ep+6")  # below: 2^-149

# __log2f_data: (1/c, log2(c)) for 16 subintervals, and the polynomial
LOG2F_TAB = tuple(
    (float.fromhex(a), float.fromhex(b)) for a, b in (
        ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
        ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
        ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
        ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
        ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
        ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
        ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
        ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
        ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
        ("0x1.0000000000000p+0", "0x0.0p+0"),
        ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
        ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
        ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
        ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
        ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
        ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")))
LOG2F_POLY = (float.fromhex("-0x1.712b6f70a7e4dp-2"),
              float.fromhex("0x1.ecabf496832e0p-2"),
              float.fromhex("-0x1.715479ffae3dep-1"),
              float.fromhex("0x1.715475f35c8b8p+0"))
LOG2F_OFF = 0x3F330000

_NAN_X86 = -4194304  # 0xFFC00000 as int32: x86's default NaN
_QUIET = 0x00400000


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def _add_odd(a, b):
    """a + b rounded to odd: where the sum is inexact, the neighbour of
    the rounded-to-nearest sum with an odd last bit."""
    s, e = _two_sum(a, b)
    bits = s.view(torch.int64)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    fix = (e != 0) & ((bits & 1) == 0)
    return torch.where(fix, (bits + step).view(torch.float64), s)


def fma64(a, b, c):
    """a * b + c of f64 tensors (or numbers, one at least a tensor),
    rounded once, for finite operands whose product neither overflows nor
    underflows."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pl = (((ah * bh - p) + ah * bl) + al * bh) + al * bl
    sh, sl = _two_sum(c, p)
    return sh + _add_odd(sl, pl)


def _bits(x):
    return x.view(torch.int32).to(torch.int64) & _M32


def _f32_of_bits(b):
    b = torch.where(b >= 2**31, b - 2**32, b)
    return b.to(torch.int32).view(torch.float32)


def _quiet(x):
    return _f32_of_bits(_bits(x) | _QUIET)


def _table(values, idx, dtype):
    return torch.tensor(values, dtype=dtype, device=idx.device)[idx]


def _exp_tail(kd_raw, kd, r, poly):
    """The shared tail of expf/exp2f: s = 2^(k/32) from the table, the
    cubic in r, rounded to float."""
    ki = kd_raw.view(torch.int64)
    t = _table(EXP2F_TAB, ki & 31, torch.int64) + (ki << 47)
    s = t.view(torch.float64)
    z = fma64(r, poly[0], poly[1])
    r2 = r * r
    y = fma64(r, poly[2], 1.0)
    y = fma64(z, r2, y)
    return (y * s).to(torch.float32)


def _exp_specials(x, main, abstop_min: int, oflow, uflow, may_uflow,
                  uflow_inclusive: bool):
    abstop = (_bits(x) >> 20) & 0x7FF
    big = abstop >= abstop_min
    out = main
    tiny = torch.full_like(x, 2.0**-149)
    zero = torch.zeros_like(x)
    out = torch.where(big & (x < may_uflow), tiny, out)
    under = (x <= uflow) if uflow_inclusive else (x < uflow)
    out = torch.where(big & under, zero, out)
    out = torch.where(big & (x > oflow), torch.full_like(x, float("inf")), out)
    out = torch.where(torch.isnan(x), _quiet(x), out)
    out = torch.where(x == float("inf"), x, out)
    return torch.where(x == float("-inf"), zero, out)


def expf(x: torch.Tensor) -> torch.Tensor:
    """glibc's expf of an f32 tensor (the FMA variant)."""
    x = x.to(torch.float32)
    safe = torch.clamp(torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0),
                       -110.0, 110.0)
    xd = safe.double()
    kd_raw = fma64(xd, EXPF_INVLN2N, EXPF_SHIFT)
    kd = kd_raw - EXPF_SHIFT
    r = fma64(xd, EXPF_INVLN2N, -kd)
    main = _exp_tail(kd_raw, kd, r, EXPF_POLY)
    return _exp_specials(x, main, 0x42B, EXPF_OFLOW, EXPF_UFLOW,
                         EXPF_MAY_UFLOW, uflow_inclusive=False)


def exp2f(x: torch.Tensor) -> torch.Tensor:
    """glibc's exp2f of an f32 tensor (the FMA variant)."""
    x = x.to(torch.float32)
    safe = torch.clamp(torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0),
                       -160.0, 160.0)
    xd = safe.double()
    kd_raw = xd + EXP2F_SHIFT
    kd = kd_raw - EXP2F_SHIFT
    r = xd - kd
    main = _exp_tail(kd_raw, kd, r, EXP2F_POLY)
    return _exp_specials(x, main, 0x430, 0.0, -150.0, -149.0,
                         uflow_inclusive=True)


def log2f(x: torch.Tensor) -> torch.Tensor:
    """glibc's log2f of an f32 tensor (the FMA variant)."""
    x = x.to(torch.float32)
    ix = _bits(x)
    sub = (ix > 0) & (ix < 0x00800000)
    # a subnormal x: the bits of x * 2^23, less 23 in the exponent
    m = torch.where(sub, ix, torch.ones_like(ix)).to(torch.float32)
    ix = torch.where(sub, _bits(m) - (149 << 23), ix)
    tmp = (ix - LOG2F_OFF) & _M32
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = (ix - top) & _M32
    k = torch.where(tmp >= 2**31, tmp - 2**32, tmp) >> 23
    invc = _table([c[0] for c in LOG2F_TAB], i, torch.float64)
    logc = _table([c[1] for c in LOG2F_TAB], i, torch.float64)
    z = _f32_of_bits(iz).double()
    r = fma64(z, invc, -1.0)
    y0 = k.double() + logc
    r2 = r * r
    a = LOG2F_POLY
    y = fma64(r, a[1], a[2])
    p = fma64(r, a[3], y0)
    y = fma64(r2, a[0], y)
    y = fma64(r2, y, p)
    out = y.to(torch.float32)
    ox = _bits(x)
    special = ((ox - 0x00800000) & _M32) >= 0x7F000000
    neg_or_nan = ((ox & 0x80000000) != 0) | (((ox << 1) & _M32) >= 0xFF000000)
    invalid = torch.where(torch.isnan(x), _quiet(x),
                          torch.full_like(x, 0.0).view(torch.int32)
                          .fill_(_NAN_X86).view(torch.float32))
    out = torch.where(special & ~sub & neg_or_nan, invalid, out)
    out = torch.where(ox == 0x7F800000, x, out)
    out = torch.where(((ox << 1) & _M32) == 0,
                      torch.full_like(x, float("-inf")), out)
    return torch.where(ox == 0x3F800000, torch.zeros_like(x), out)
