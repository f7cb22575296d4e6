"""K5's index logic on the CPU (csrc/lambdarank.cu runs only on a card):
the bundles a layout packs its query groups into (each group of 2 to CAP
docs in exactly one, in order, within the docs and groups a block's shared
memory and consumer lanes take, packed greedily; the groups above CAP with
their rows), the kernel's warp sort (``bitonic_model``, its network of
compare-exchanges) putting every width's keys in order and, on the keys
the kernel makes, giving ``sorted_order``'s positions with NaN, signed
zeros and ties, and, from the labels' 32-bit keys alone, the ideal gains
in the plain version's order and bits; and that the +0.0 K5 adds for a
pair the native loop skips changes no chain."""
import numpy as np
import pytest
import torch

from xgboost_tpu_torch.ops.lambdarank_cuda import (
    BUNDLE_DOCS, BUNDLE_GROUPS, CAP, GroupLayout, _desc_bits, bundle_groups,
    sorted_order)
from xgboost_tpu_torch.utils.libm import exp2f


def bitonic_model(keys, E: int):
    """K5's warp sort of a group (csrc/lambdarank.cu ``bitonic``) in
    numpy: 32 E uint64 keys (the scores' are distinct, the labels' may
    repeat), element e of lane l at position l E + e, put in ascending
    order by the kernel's network of compare-exchanges (within a lane
    where the partner is, else through a shuffle with lane l ^ (j / E)).
    Returns the keys as the network leaves them, position by position."""
    a = np.asarray(keys, np.uint64).reshape(32, E).copy()
    lane = np.arange(32)
    k = 2
    while k <= 32 * E:
        j = k >> 1
        while j > 0:
            if j < E:
                for e in range(E):
                    if e & j:
                        continue
                    up = ((lane * E + e) & k) == 0
                    lo, hi = a[:, e].copy(), a[:, e | j].copy()
                    swap = (lo > hi) == up
                    a[:, e] = np.where(swap, hi, lo)
                    a[:, e | j] = np.where(swap, lo, hi)
            else:
                m = j // E
                lower = (lane & m) == 0
                new = a.copy()
                for e in range(E):
                    keep_min = lower == (((lane * E + e) & k) == 0)
                    other = a[lane ^ m, e]
                    new[:, e] = np.where(keep_min, np.minimum(a[:, e], other),
                                         np.maximum(a[:, e], other))
                a = new
            j >>= 1
        k <<= 1
    return a.reshape(-1)


def _sizes(kind, rng):
    if kind == "mslr":
        return rng.integers(40, 200, size=3000)
    if kind == "tiny":
        return rng.integers(0, 4, size=500)
    if kind == "at_cap":
        return np.tile([CAP, CAP - 1, 1, CAP], 50)
    if kind == "mixed":
        s = rng.integers(1, 300, size=800)
        s[::97] = 20_000
        return s
    if kind == "all_big":
        return np.array([CAP + 1, 5000, 300])
    if kind == "one_group":
        return np.array([7])
    raise ValueError(kind)


KINDS = ["mslr", "tiny", "at_cap", "mixed", "all_big", "one_group"]


@pytest.mark.parametrize("kind", KINDS)
def test_bundles_take_each_fitting_group_once(kind):
    sizes = _sizes(kind, np.random.default_rng(KINDS.index(kind)))
    fit, ptr = bundle_groups(sizes)
    want = np.flatnonzero((sizes >= 2) & (sizes <= CAP))
    np.testing.assert_array_equal(fit, want)  # each once, in order
    assert ptr[0] == 0 and ptr[-1] == len(fit)
    assert np.all(np.diff(ptr) >= 1)
    for b in range(len(ptr) - 1):
        n = sizes[fit[ptr[b]:ptr[b + 1]]]
        assert n.sum() <= BUNDLE_DOCS and len(n) <= BUNDLE_GROUPS
        if b + 2 < len(ptr):  # greedy: the next group did not fit
            nxt = sizes[fit[ptr[b + 1]]]
            assert (len(n) == BUNDLE_GROUPS
                    or n.sum() + nxt > BUNDLE_DOCS)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_tables_of_a_layout(kind):
    sizes = _sizes(kind, np.random.default_rng(10 + KINDS.index(kind)))
    gp = np.concatenate([[0], np.cumsum(sizes)])
    layout = GroupLayout(gp, "cpu")
    t = layout.kernel_tables
    fit, ptr = bundle_groups(sizes)
    np.testing.assert_array_equal(t.bgroups.numpy(), fit)
    np.testing.assert_array_equal(t.bptr.numpy(), ptr)
    assert t.n_bundles == len(ptr) - 1
    docs = [int(sizes[fit[ptr[b]:ptr[b + 1]]].sum())
            for b in range(t.n_bundles)]
    assert t.bundle_docs == max(docs, default=0) <= BUNDLE_DOCS
    assert t.bundle_ngroups == int(np.diff(ptr).max(initial=0)) \
        <= BUNDLE_GROUPS
    assert t.max_n == int(sizes[fit].max(initial=0)) <= CAP
    big = np.flatnonzero(sizes > CAP)
    assert t.n_big == len(big)
    assert layout.sorts_in_kernel == (len(big) == 0)
    np.testing.assert_array_equal(np.diff(t.big_ptr.numpy()), sizes[big])
    want_rows = np.concatenate(
        [np.arange(gp[g], gp[g + 1]) for g in big] + [np.zeros(0, int)])
    np.testing.assert_array_equal(t.big_rows.numpy(), want_rows)
    np.testing.assert_array_equal(
        t.big_gid.numpy(), np.repeat(np.arange(len(big)), sizes[big]))
    assert t.r_big == len(want_rows)


@pytest.mark.parametrize("E", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", range(4))
def test_bitonic_model_sorts_every_width(E, seed):
    rng = np.random.default_rng(seed * 8 + E)
    n = int(rng.integers(1, 32 * E + 1))
    keys = np.full(32 * E, np.iinfo(np.uint64).max, np.uint64)
    keys[:n] = rng.choice(2**62, size=n, replace=False).astype(np.uint64)
    rng.shuffle(keys[:n])
    np.testing.assert_array_equal(bitonic_model(keys, E), np.sort(keys))


def _width(n):
    return 1 if n <= 32 else 2 if n <= 64 else 4 if n <= 128 else 8


@pytest.mark.parametrize("n", [2, 31, 32, 33, 64, 100, 128, 129, 199, CAP])
@pytest.mark.parametrize("kind", ["normal", "tied", "nan"])
def test_kernel_sort_is_sorted_order(n, kind):
    """The keys K5 makes (the 32-bit key above the doc's index) through its
    network: each doc's sorted position is ``sorted_order``'s (ties by
    row)."""
    rng = np.random.default_rng(n)
    v = rng.normal(size=n).astype(np.float32)
    if kind == "tied":
        v = np.round(2 * v).astype(np.float32)
        v[::3] = -0.0
        v[1::5] = 0.0
    elif kind == "nan":
        v[::4] = np.nan
        v[1::6] = -np.inf
    E = _width(n)
    key = _desc_bits(torch.from_numpy(v)).numpy().astype(np.uint64)
    keys = np.full(32 * E, np.iinfo(np.uint64).max, np.uint64)
    keys[:n] = (key << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    got = bitonic_model(keys, E)[:n] & np.uint64(0xFFFFFFFF)
    want = sorted_order(torch.from_numpy(v),
                        torch.zeros(n, dtype=torch.int64))
    np.testing.assert_array_equal(got.astype(np.int64), want.numpy())


def _desc_value(key):
    """csrc/lambdarank.cu desc_value: a label's value from its 32-bit key."""
    key = key.astype(np.uint32)
    b = np.where(key & np.uint32(0x80000000), key & np.uint32(0x7FFFFFFF),
                 ~key)
    return -b.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("n", [2, 33, 100, 199, CAP])
@pytest.mark.parametrize("kind", ["graded", "real", "odd"])
def test_kernel_label_sort_gives_the_ideal_gains(n, kind):
    """The labels' 32-bit keys through K5's network, each position's gain
    made from its key: the plain version's ideal gains, bit for bit (NaN
    where it has NaN)."""
    rng = np.random.default_rng(n + 1)
    y = rng.integers(0, 5, n).astype(np.float32)
    if kind == "real":
        y = rng.uniform(0, 4, n).astype(np.float32)
    elif kind == "odd":
        y[::3] = -0.0
        y[1::7] = np.nan
        y[2::9] = -200.0
    E = _width(n)
    keys = np.full(32 * E, 0xFFFFFFFF, np.uint64)
    keys[:n] = _desc_bits(torch.from_numpy(y)).numpy().astype(np.uint64)
    vals = _desc_value(bitonic_model(keys, E)[:n])
    got = exp2f(torch.from_numpy(vals)) - 1.0
    order = sorted_order(torch.from_numpy(y),
                         torch.zeros(n, dtype=torch.int64))
    want = exp2f(torch.from_numpy(y)[order]) - 1.0
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _chain(terms):
    acc = np.float32(0.0)
    for x in terms:
        acc = np.float32(acc + x)
    return acc


@pytest.mark.parametrize("seed", range(6))
def test_a_skipped_pairs_zero_changes_no_chain(seed):
    """K5 and the plain version add +0.0 for a pair of equal gains, which
    the native loop skips: every chain (the signed gradient terms, the
    hessian terms, sum_lambda's -2 lam) keeps its bits, +0.0 and -0.0
    terms, infinities and subnormals included."""
    rng = np.random.default_rng(seed)
    n = 400
    lam = -np.abs(rng.normal(size=n)).astype(np.float32) \
        * np.float32(10.0) ** rng.integers(-45, 3, n).astype(np.float32)
    lam[rng.random(n) < 0.1] = np.float32(0.0)
    lam[rng.random(n) < 0.1] = np.float32(-0.0)
    if seed == 5:
        lam[n // 2] = -np.inf
    sgn = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    at = rng.integers(0, n, 50)
    for terms in (lam * sgn, np.abs(lam), np.float32(-2.0) * lam):
        skipped = np.insert(terms, at, np.float32(0.0))
        assert _chain(terms).view(np.int32) == _chain(skipped).view(np.int32)
