"""Port parity: split evaluation and one whole depthwise tree against
xgboost_tpu on data without near-ties.  Decisions (feature, bin, default
direction, leaves) must be equal; gains and leaf values agree within
rtol 1e-4 (f32 sums in another order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xgboost_tpu.data.ellpack import build_ellpack as ref_build_ellpack
from xgboost_tpu.data.quantile import sketch_dense as ref_sketch_dense
from xgboost_tpu.ops.histogram import build_histogram as ref_build_histogram
from xgboost_tpu.ops.split import SplitParams as RefSplitParams
from xgboost_tpu.ops.split import evaluate_splits as ref_evaluate_splits
from xgboost_tpu.tree.grow import HistTreeGrower as RefGrower
from xgboost_tpu_torch.ops.split import (SplitParams, calc_gain, calc_weight,
                                         evaluate_splits)
from xgboost_tpu_torch.tree.grow import HistTreeGrower, leaf_margin_delta

PARAMS = [
    dict(eta=0.3, gamma=0.0, min_child_weight=1.0, lambda_=1.0, alpha=0.0,
         max_delta_step=0.0),
    dict(eta=0.1, gamma=0.5, min_child_weight=3.0, lambda_=2.0, alpha=0.5,
         max_delta_step=0.7),
]


def _problem(R=2000, F=6, max_bin=32, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) ** 2
         + 0.3 * rng.normal(size=R)).astype(np.float32)
    cuts = ref_sketch_dense(X, max_bin)
    ell = ref_build_ellpack(jnp.asarray(X), cuts)
    R_pad = ell.n_padded
    valid = np.arange(R_pad) < R
    # squared-error gradients at margin 0, zero on pad rows
    g = np.zeros((R_pad, 2), np.float32)
    g[:R, 0] = -y
    g[:R, 1] = 1.0 + rng.random(R).astype(np.float32)
    return (np.array(ell.bins), g, valid, np.array(ell.cuts_pad),
            np.array(ell.n_bins))


@pytest.mark.parametrize("p", PARAMS)
def test_weight_and_gain_match_reference(p):
    from xgboost_tpu.ops.split import calc_gain as ref_gain
    from xgboost_tpu.ops.split import calc_weight as ref_weight

    rng = np.random.default_rng(1)
    G = rng.normal(size=500).astype(np.float32) * 5
    H = np.abs(rng.normal(size=500)).astype(np.float32) * 3
    H[:10] = 0.0
    for ref_fn, fn in ((ref_weight, calc_weight), (ref_gain, calc_gain)):
        np.testing.assert_allclose(
            fn(torch.from_numpy(G), torch.from_numpy(H), SplitParams(**p)),
            np.asarray(ref_fn(jnp.asarray(G), jnp.asarray(H),
                              RefSplitParams(**p))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("p", PARAMS)
def test_evaluate_splits_matches_reference(p):
    bins, g, valid, cuts_pad, n_bins = _problem(seed=2)
    B = cuts_pad.shape[1]
    pos = np.where(valid, np.arange(len(valid)) % 4, -1).astype(np.int32)
    hist = np.array(ref_build_histogram(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(pos), node0=0,
        n_nodes=4, n_bin=B))
    totals = np.stack([g[pos == n].sum(0) for n in range(4)])
    # one node with missing-only stats exercises the top-bin rule
    totals[3] += np.float32([0.5, 2.0])
    ref = ref_evaluate_splits(jnp.asarray(hist), jnp.asarray(totals),
                              jnp.asarray(n_bins), RefSplitParams(**p))
    got = evaluate_splits(torch.from_numpy(hist), torch.from_numpy(totals),
                          torch.from_numpy(n_bins), SplitParams(**p))
    np.testing.assert_array_equal(got.feature.numpy(), np.asarray(ref.feature))
    np.testing.assert_array_equal(got.bin.numpy(), np.asarray(ref.bin))
    np.testing.assert_array_equal(got.default_left.numpy(),
                                  np.asarray(ref.default_left))
    np.testing.assert_allclose(got.gain.numpy(), np.asarray(ref.gain),
                               rtol=1e-4)
    np.testing.assert_allclose(got.left_sum.numpy(), np.asarray(ref.left_sum),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.right_sum.numpy(),
                               np.asarray(ref.right_sum), rtol=1e-4, atol=1e-4)


def test_argmax_takes_first_maximum():
    """Equal gains at several (feature, bin): the first one wins, and equal
    default directions resolve to left, as in the reference."""
    hist = torch.zeros((1, 3, 4, 2))
    hist[0, :, 0] = torch.tensor([-2.0, 2.0])
    hist[0, :, 1] = torch.tensor([2.0, 2.0])
    totals = torch.tensor([[0.0, 4.0]])
    best = evaluate_splits(hist, totals, torch.tensor([4, 4, 4]),
                           SplitParams(**PARAMS[0]))
    assert best.feature.item() == 0 and best.bin.item() == 0
    assert bool(best.default_left.item())


@pytest.mark.parametrize("p", PARAMS)
@pytest.mark.parametrize("max_depth", [1, 4])
def test_whole_tree_matches_reference(p, max_depth):
    bins, g, valid, cuts_pad, n_bins = _problem(seed=3)
    ref_state = RefGrower(max_depth, RefSplitParams(**p)).grow(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(valid),
        jnp.asarray(cuts_pad), jnp.asarray(n_bins))
    ref = RefGrower.to_host(ref_state)
    grower = HistTreeGrower(max_depth, SplitParams(**p))
    state = grower.grow(torch.from_numpy(bins), torch.from_numpy(g),
                        torch.from_numpy(valid), torch.from_numpy(cuts_pad),
                        torch.from_numpy(n_bins))
    got = grower.to_host(state)
    assert ref.is_leaf.sum() > 1
    for name in ("feat", "sbin", "is_leaf"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name), err_msg=name)
    # the default direction is a decision only where a split node saw
    # missing values of its feature; elsewhere both directions score the
    # same up to f32 rounding of (node total - feature total)
    leaf_of = np.asarray(ref_state.pos)[valid]
    saw_missing = np.zeros(len(ref.feat), bool)
    for h in np.nonzero(ref.feat >= 0)[0]:
        anc = leaf_of.copy()  # walk each row's leaf up to depth(h)
        while (anc > h).any():
            anc = np.where(anc > h, (anc - 1) // 2, anc)
        rows = anc == h  # rows that passed through node h
        saw_missing[h] = (bins[:len(leaf_of)][rows, ref.feat[h]]
                          == cuts_pad.shape[1]).any()
    assert saw_missing.any()
    np.testing.assert_array_equal(got.dleft[saw_missing],
                                  ref.dleft[saw_missing])
    np.testing.assert_array_equal(got.thr, ref.thr)
    for name in ("leaf_val", "base_weight", "gain", "sum_hess"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(state.pos.numpy(),
                                  np.asarray(ref_state.pos))
    delta = leaf_margin_delta(state.pos, state.leaf_val).numpy()
    assert np.all(delta[~valid] == 0.0)
    np.testing.assert_allclose(
        delta[valid], ref.leaf_val[np.asarray(ref_state.pos)[valid]],
        rtol=1e-4, atol=1e-5)
