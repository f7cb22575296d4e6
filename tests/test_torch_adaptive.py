"""The adaptive quantile leaf refit (ops/adaptive.py) against
xgboost_tpu/ops/adaptive.py bitwise: empty leaves, padded rows, ties,
signed zeros, alpha 0 and 1; and the refit in training, depthwise and
best-first, against the reference's trees."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu.ops.adaptive import segment_quantile_leaf as ref_sql
from xgboost_tpu_torch.ops.adaptive import lexsort_stable, \
    segment_quantile_leaf


def _case(seed, R, M, kind):
    rng = np.random.default_rng(seed)
    pos = rng.integers(-1, M, R).astype(np.int32)
    res = rng.normal(0, 2, R).astype(np.float32)
    if kind == "ties":
        res = np.round(res).astype(np.float32)  # ties, and -0.0 from -0.4
    elif kind == "signed_zeros":
        res[rng.random(R) < 0.5] = 0.0
        res[rng.random(R) < 0.5] = -0.0
    elif kind == "empty":
        pos[pos == 1] = 2  # leaf 1 has no rows
    valid = rng.random(R) < 0.9
    leaf = rng.random(M) < 0.7
    leaf[1] = True
    return pos, res, valid, leaf


@pytest.mark.parametrize("alpha", [0.0, 0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("kind", ["plain", "ties", "signed_zeros", "empty"])
@pytest.mark.parametrize("R,M", [(1, 3), (17, 7), (1999, 63)])
def test_segment_quantile_leaf_bitwise(alpha, kind, R, M):
    pos, res, valid, leaf = _case(R * 31 + M, R, M, kind)
    want = np.asarray(ref_sql(jnp.asarray(pos), jnp.asarray(res),
                              jnp.asarray(valid), jnp.asarray(leaf), alpha,
                              0.3, max_nodes=M))
    got = segment_quantile_leaf(torch.from_numpy(pos), torch.from_numpy(res),
                                torch.from_numpy(valid),
                                torch.from_numpy(leaf), alpha, 0.3,
                                max_nodes=M).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_lexsort_keeps_row_order_among_equal_keys():
    key = torch.tensor([1, 0, 1, 1, 0, 1])
    val = torch.tensor([0.0, 2.0, -0.0, 0.0, float("nan"), -1.0])
    order = lexsort_stable(key, val).tolist()
    # key 0: 2.0 then NaN (last); key 1: -1.0, then the zeros in row order
    assert order == [1, 4, 5, 0, 2, 3]


def _data(R=1200, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, 5)).astype(np.float32)
    y = (X[:, 0] + np.abs(X[:, 1]) + rng.standard_t(2, size=R)).astype(
        np.float32)
    return X, y


@pytest.mark.parametrize("params", [
    {"objective": "reg:absoluteerror", "deterministic_histogram": 1},
    {"objective": "reg:quantileerror", "quantile_alpha": [0.0, 0.3, 1.0],
     "deterministic_histogram": 1},
    {"objective": "reg:absoluteerror", "grow_policy": "lossguide",
     "max_leaves": 6},
    {"objective": "reg:quantileerror", "quantile_alpha": 0.8,
     "subsample": 0.7, "num_parallel_tree": 2, "deterministic_histogram": 1},
])
def test_refit_in_training_matches_reference(params):
    X, y = _data()
    p = {"max_depth": 3, "eta": 0.5, **params}
    ref = xtb.train(p, xtb.DMatrix(X, label=y), 5, verbose_eval=False)
    port = xtt.train(p, xtt.DMatrix(X, label=y, device="cpu"), 5,
                     verbose_eval=False, device="cpu")
    assert len(port.trees) == len(ref.trees)
    for a, b in zip(port.trees, ref.trees):
        np.testing.assert_array_equal(a.left_children, b.left_children)
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
        leaf = a.left_children == -1
        # the refit's leaves: the reference's bits (f32 sums only choose
        # the splits)
        np.testing.assert_array_equal(a.split_conditions[leaf],
                                      b.split_conditions[leaf])


def test_refit_leaves_are_quantiles_of_their_rows():
    """Every leaf of the first tree is eta times the alpha-quantile (linear
    interpolation) of its rows' residuals against the base score."""
    X, y = _data(R=500, seed=2)
    d = xtt.DMatrix(X, label=y, device="cpu")
    bst = xtt.train({"objective": "reg:quantileerror", "quantile_alpha": 0.2,
                     "max_depth": 2, "eta": 1.0}, d, 1, verbose_eval=False,
                    device="cpu")
    leaves = bst.predict(d, pred_leaf=True)[:, 0]
    base = float(bst.base_score[0])
    tree = bst.trees[0]
    for nid in np.unique(leaves):
        r = (y[leaves == nid] - np.float32(base)).astype(np.float64)
        assert tree.split_conditions[nid] == pytest.approx(
            np.quantile(r, 0.2), rel=1e-5, abs=1e-5)
