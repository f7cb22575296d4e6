"""The split scan's fixed summation order and arithmetic against the
reference, bitwise (xgboost_tpu_torch/ops/split.py, the plain version of
K3, csrc/split_scan.cu):

- ``prefix_blocked`` against jnp.cumsum on XLA's CPU (its blocked scan) at
  B = 2, 16, 17, 33, 256, 257 and 1024, and ``prefix_sequential`` against
  a one-at-a-time f32 sum;
- ``evaluate_splits`` against the reference's: unconstrained against its
  native scan (the FFI kernel xtb_split, which the reference takes on the
  CPU), monotone against its XLA formulation, with feature masks, bounds,
  ties, nodes without a candidate and dead slots;
- the f32 helpers: ``fma_f32`` against the C library's fmaf, ``exp_f32``
  and ``sigmoid_f32`` against XLA's exp and jax.nn.sigmoid (exp on every
  f32 of its range's edges), ``sum_f32`` against jnp.sum;
- the dispatchers of K3 and K4 (ops/split_cuda.py, ops/sigmoid_cuda.py)
  take the plain versions on CPU tensors and launch nothing;
- what K3's design relies on: its lanes' order of the blocked prefix
  (blocks of 16 from 0.0, the totals one level up, the exclusive prefixes
  added from the top down) against ``prefix_blocked`` and jnp.cumsum, and
  the answer's independence from how the features are grouped over warps
  and blocks, in all three modes."""
import ctypes
import ctypes.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_tpu.ops.split import SplitParams as RefSplitParams
from xgboost_tpu.ops.split import _native_split_ok
from xgboost_tpu.ops.split import evaluate_splits as ref_evaluate_splits
from xgboost_tpu_torch.ops.split import (SplitParams, evaluate_splits,
                                         prefix_blocked, prefix_sequential)
from xgboost_tpu_torch.utils.fp import exp_f32, fma_f32, sigmoid_f32


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("B", [2, 16, 17, 33, 256, 257, 1024])
def test_blocked_prefix_matches_jnp_cumsum(B):
    rng = np.random.default_rng(B)
    x = (rng.normal(size=(3, 5, B)) * rng.random((3, 5, B)) * 100).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=-1))(x))
    _bits_equal(prefix_blocked(torch.from_numpy(x)).numpy(), want)


def test_sequential_prefix_adds_one_at_a_time():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 300)) * 1e3).astype(np.float32)
    want = np.zeros_like(x)
    acc = np.zeros(4, np.float32)
    for b in range(x.shape[1]):
        acc = (acc + x[:, b]).astype(np.float32)
        want[:, b] = acc
    _bits_equal(prefix_sequential(torch.from_numpy(x)).numpy(), want)


PARAMS = [
    dict(eta=0.3, gamma=0.0, min_child_weight=1.0, lambda_=1.0, alpha=0.0,
         max_delta_step=0.0),
    dict(eta=0.3, gamma=0.0, min_child_weight=0.5, lambda_=2.0, alpha=0.5,
         max_delta_step=0.0),
    dict(eta=0.1, gamma=0.5, min_child_weight=3.0, lambda_=2.0, alpha=0.5,
         max_delta_step=0.7),
]


def _case(N, F, B, seed, ties):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, F, B, 2)).astype(np.float32)
    h[..., 1] = np.abs(h[..., 1]) * 3
    if ties:  # repeated bins and features: equal gains compete
        h[:, :, 1::2] = h[:, :, ::2][:, :, : B // 2]
        h[:, 1::2] = h[:, ::2][:, : F // 2]
    nb = rng.integers(2, B + 1, size=F).astype(np.int32)
    for f in range(F):
        h[:, f, nb[f]:] = 0.0
    tot = h[:, 0].sum(1).astype(np.float32)
    tot += (rng.normal(size=(N, 2)) * (rng.random((N, 1)) < 0.5)).astype(
        np.float32)
    tot[:, 1] = np.abs(tot[:, 1]) + 0.5
    if N > 1:
        h[-1] = 0.0
        tot[-1] = 0.0  # a dead slot
    if N > 2:
        h[0, :, :, 1] = 1e-3  # no bin reaches min_child_weight
    fm = rng.random((N, F)) < 0.7
    bounds = np.stack([rng.normal(size=N) - 2, rng.normal(size=N) + 2],
                      1).astype(np.float32)
    mono = tuple(int(c) for c in rng.integers(-1, 2, size=F))
    return h, tot, nb, fm, bounds, mono


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("pi", range(len(PARAMS)))
@pytest.mark.parametrize("monotone", [False, True])
@pytest.mark.parametrize("N,F,B", [(1, 28, 256), (2, 28, 256),
                                   (8, 28, 256), (4, 6, 33), (5, 3, 17)])
def test_evaluate_splits_bitwise_against_reference(N, F, B, monotone, pi,
                                                   ties):
    h, tot, nb, fm, bounds, mono = _case(N, F, B, N * 7 + B + pi, ties)
    mono = mono if monotone else None
    rp = RefSplitParams(**PARAMS[pi], monotone=mono)
    # the reference's own CPU route: the native scan when unconstrained
    assert _native_split_ok(rp) == (not monotone)
    for mask in (None, fm):
        want = ref_evaluate_splits(
            jnp.asarray(h), jnp.asarray(tot), jnp.asarray(nb), rp,
            None if mask is None else jnp.asarray(mask), jnp.asarray(bounds))
        got = evaluate_splits(
            torch.from_numpy(h), torch.from_numpy(tot), torch.from_numpy(nb),
            SplitParams(**PARAMS[pi], monotone=mono),
            None if mask is None else torch.from_numpy(mask),
            torch.from_numpy(bounds))
        for name in got._fields:
            _bits_equal(getattr(got, name).numpy().astype(
                np.asarray(getattr(want, name)).dtype),
                getattr(want, name))


def test_fma_is_one_rounding():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.fmaf.restype = ctypes.c_float
    libm.fmaf.argtypes = [ctypes.c_float] * 3
    rng = np.random.default_rng(0)
    n = 4000
    a = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, n)).astype(
        np.float32)
    b = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, n)).astype(
        np.float32)
    c = (rng.normal(size=n) * 10.0 ** rng.integers(-6, 6, n)).astype(
        np.float32)
    c[: n // 2] = (-(a[: n // 2].astype(np.float64) * b[: n // 2])).astype(
        np.float32)  # near-cancellation, where double rounding would show
    want = np.array([libm.fmaf(float(x), float(y), float(z))
                     for x, y, z in zip(a, b, c)], np.float32)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    _bits_equal(got, want)


def test_exp_and_sigmoid_match_xla():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-88, 88, 200_000),
                        rng.normal(size=50_000) * 1e-3,
                        [0.0, -0.0, 1e-30, -1e-30]]).astype(np.float32)
    t = torch.from_numpy(x)
    _bits_equal(exp_f32(t).numpy(), np.asarray(jax.jit(jnp.exp)(x)))
    _bits_equal(sigmoid_f32(t).numpy(),
                np.asarray(jax.jit(jax.nn.sigmoid)(x)))


def _f32_range(lo, hi):
    """Every f32 in [lo, hi] (lo and hi of one sign)."""
    a, b = sorted(abs(np.float32(v)).view(np.int32) for v in (lo, hi))
    x = np.arange(a, b + 1, dtype=np.int32).view(np.float32)
    return -x if lo < 0 else x


@pytest.mark.parametrize("lo,hi", [(-104.0, -87.0), (87.0, 88.8)])
def test_exp_matches_xla_on_every_f32_at_the_range_edges(lo, hi):
    """exp_f32 against XLA's exp on every f32 where the range reduction
    meets the limits: results flushed below the smallest normal f32, and
    the top, where XLA caps the exponent at 127."""
    x = _f32_range(lo, hi)
    _bits_equal(exp_f32(torch.from_numpy(x)).numpy(),
                np.asarray(jax.jit(jnp.exp)(x)))


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 63, 64, 65, 100, 1023,
                               1024, 1025, 1500, 2049, 20_000, 100_003])
def test_sum_is_jnp_sums_order(n):
    """sum_f32 against jnp.sum on XLA's CPU, bitwise, over lengths below,
    at and above the 32-value windows and their powers, in one and two
    dimensions (the axis-0 sums of init_estimation)."""
    from xgboost_tpu_torch.utils.fp import sum_f32

    rng = np.random.default_rng(n)
    x = (rng.normal(size=(n, 2)) * rng.random((n, 2)) * 100).astype(
        np.float32)
    _bits_equal(sum_f32(torch.from_numpy(x[:, 0])).numpy(),
                np.asarray(jnp.sum(jnp.asarray(x[:, 0]))))
    _bits_equal(sum_f32(torch.from_numpy(x), dim=0).numpy(),
                np.asarray(jnp.sum(jnp.asarray(x), axis=0)))


def test_sigmoid_dispatch_takes_plain_version_on_cpu():
    """The objective's sigmoid on a CPU tensor is the plain version, with
    XLA's bits across the f32 range and at its edges (the clamps, overflow,
    infinities, NaN), and launches no kernel; K4's wrapper refuses a CPU
    tensor."""
    from xgboost_tpu_torch.ops import hist_cuda
    from xgboost_tpu_torch.ops.sigmoid_cuda import sigmoid, sigmoid_cuda

    rng = np.random.default_rng(2)
    edges = [0.0, -0.0, 1e-8, -1e-8, 17.0, -17.0, 88.37, -88.37, 88.8,
             -88.8, 89.0, -89.0, 104.0, -104.0, 105.0, -105.0, 1e4, -1e4,
             np.inf, -np.inf, np.nan]
    x = np.concatenate([rng.normal(size=20_000) * 4,
                        rng.uniform(-120, 120, 20_000), edges]).astype(
                            np.float32)
    before = dict(hist_cuda.launches)
    got = sigmoid(torch.from_numpy(x)).numpy()
    assert hist_cuda.launches == before
    _bits_equal(got, np.asarray(jax.jit(jax.nn.sigmoid)(x)))
    with pytest.raises(ValueError, match="CUDA"):
        sigmoid_cuda(torch.from_numpy(x))


def test_split_dispatch_takes_plain_version_on_cpu():
    """``evaluate_splits`` on CPU tensors runs the plain scan and launches
    no kernel; K3's wrapper refuses CPU tensors."""
    from xgboost_tpu_torch.ops import hist_cuda
    from xgboost_tpu_torch.ops.split_cuda import split_scan_cuda

    h, tot, nb, fm, _, _ = _case(4, 5, 16, seed=3, ties=False)
    p = SplitParams(**PARAMS[0])
    args = [torch.from_numpy(a) for a in (h, tot, nb)]
    before = dict(hist_cuda.launches)
    evaluate_splits(*args, p, torch.from_numpy(fm))
    assert hist_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        split_scan_cuda(*args, p)


# ------------------------------------------- what K3's design relies on
def _lane_prefix(x):
    """K3's blocked prefix (modes 1 and 2) as its lanes compute it, in f32
    numpy over rows: lane j sums block j of 16 values from 0.0 (zero
    padding past the end), the block totals go to the level above, until
    a level holds at most 16 values, which one lane sums in order; then,
    from the top down, each block's exclusive prefix (0.0 for the first)
    is added to the block."""
    with np.errstate(invalid="ignore"):  # inf - inf in the sums
        return _lane_levels(x)


def _lane_levels(x):
    levels = [x.astype(np.float32).copy()]
    while levels[-1].shape[1] > 16:
        a = levels[-1]
        n = a.shape[1]
        tot = np.zeros((a.shape[0], -(-n // 16)), np.float32)
        for j in range(tot.shape[1]):  # lane j
            s = np.zeros(a.shape[0], np.float32)
            for i in range(16 * j, 16 * j + 16):
                s = s + (a[:, i] if i < n else np.float32(0.0))
                if i < n:
                    a[:, i] = s
            tot[:, j] = s
        levels.append(tot)
    top = levels[-1]
    s = np.zeros(top.shape[0], np.float32)
    for i in range(top.shape[1]):
        s = s + top[:, i]
        top[:, i] = s
    for a, up in zip(levels[-2::-1], levels[:0:-1]):
        for i in range(a.shape[1]):
            e = up[:, i // 16 - 1] if i >= 16 else np.float32(0.0)
            a[:, i] = a[:, i] + e
    return levels[0]


def _same_bits_or_nan(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(b)
    np.testing.assert_array_equal(np.isnan(a), nan)
    np.testing.assert_array_equal(a[~nan].view(np.uint32),
                                  b[~nan].view(np.uint32))


@pytest.mark.parametrize("B", [2, 15, 16, 17, 255, 256, 257, 300, 1024,
                               4096, 4100])
def test_lane_decomposition_of_the_blocked_prefix(B):
    """The lanes' order of K3's blocked prefix is prefix_blocked's and
    jnp.cumsum's on XLA's CPU, bitwise, with -0.0, +-inf and ties in the
    input and a third level past 256 values (a fourth past 4096)."""
    rng = np.random.default_rng(B)
    x = (rng.normal(size=(3, B)) * rng.random((3, B)) * 100).astype(
        np.float32)
    x[:, 1::3] = x[:, ::3][:, : len(range(1, B, 3))]  # ties
    x[0, ::5] = -0.0
    x[1, :] = -0.0
    x[2, B // 2] = np.inf
    x[2, B // 3] = -np.inf if B > 2 else x[2, 0]
    got = _lane_prefix(x)
    _same_bits_or_nan(got, prefix_blocked(torch.from_numpy(x)).numpy())
    _same_bits_or_nan(got, np.asarray(
        jax.jit(lambda v: jnp.cumsum(v, axis=-1))(x)))


def _grouping_case(mode, seed):
    """A level's inputs with cross-feature ties placed on purpose: every
    odd feature repeats the even one before it, and odd bins repeat even
    ones, so that equal gains compete within and across features."""
    rng = np.random.default_rng(seed)
    N, F, B = 6, 8, 40
    h = rng.normal(size=(N, F, B, 2)).astype(np.float32)
    h[..., 1] = np.abs(h[..., 1]) * 2
    h[:, :, 1::2] = h[:, :, ::2]
    h[:, 1::2] = h[:, ::2]
    nb = rng.integers(B // 2, B + 1, size=F).astype(np.int32)
    nb[1::2] = nb[::2]
    for f in range(F):
        h[:, f, nb[f]:] = 0.0
    tot = (h[:, 0].sum(1) * np.float32(1.05)).astype(np.float32)
    h[0, :, :, 1] = 1e-4  # no candidate at node 0
    tot[0, 1] = np.float32(B * 1e-4 + 1e-3)
    cm = None
    mono = None
    if mode == "monotone":
        mono = tuple(int(c) for c in rng.integers(-1, 2, size=F))
    if mode == "categorical":
        cm = np.zeros(F, bool)
        cm[4:] = True
        nb[6:] = 3  # one-hot below max_cat_to_onehot
        h[:, 6:, 3:] = 0.0
    bounds = np.stack([rng.normal(size=N) - 1.5, rng.normal(size=N) + 1.5],
                      1).astype(np.float32)
    T = torch.from_numpy
    return (T(h), T(tot), T(nb), T(bounds), None if cm is None else T(cm),
            SplitParams(**PARAMS[0], monotone=mono))


@pytest.mark.parametrize("mode", ["native", "monotone", "categorical"])
def test_answer_does_not_depend_on_the_grouping_of_the_reduction(mode):
    """K3's warps may group the features in any way: the plain scan run
    with one feature allowed at a time, its per-feature candidates reduced
    by (gain desc, flat index asc) in random groupings, gives the
    all-features answer wherever a candidate exists, bitwise (cat_set
    too), with cross-feature ties placed on purpose."""
    from xgboost_tpu_torch.ops.split import split_scan_plain

    h, tot, nb, bounds, cm, p = _grouping_case(mode, seed=len(mode))
    N, F, B, _ = h.shape
    full = split_scan_plain(h, tot, nb, p, None, bounds, cm)
    per_feature = []
    for f in range(F):
        only = torch.zeros(F, dtype=torch.bool)
        only[f] = True
        per_feature.append(split_scan_plain(h, tot, nb, p, only, bounds, cm))
    rng = np.random.default_rng(0)
    has = full.gain > -torch.inf
    assert has.sum() >= N - 1
    ties = 0
    for n in range(N):
        if not has[n]:
            continue
        cands = [(float(r.gain[n]), int(r.feature[n]) * B + int(r.bin[n]), r)
                 for r in per_feature if r.gain[n] > -torch.inf]
        ties += len(cands) - len({c[0] for c in cands})

        def best_of(group):
            return min(group, key=lambda c: (-c[0], c[1]))
        for _ in range(8):  # random groupings, reduced in random order
            order = rng.permutation(len(cands))
            cuts = np.sort(rng.choice(np.arange(1, len(cands)),
                                      size=rng.integers(0, len(cands)),
                                      replace=False))
            groups = np.split(order, cuts)
            bests = [best_of([cands[i] for i in g]) for g in groups]
            rng.shuffle(bests)
            got = best_of(bests)[2]
            for name in full._fields:
                a, b = getattr(got, name), getattr(full, name)
                if b is None:
                    continue
                _bits_equal(a[n].numpy(), b[n].numpy())
    assert ties > 0  # the ties were placed where the reduction meets them
