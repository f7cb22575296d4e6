"""The tree comparison that chip_smoke.py's f32 parity checks stand on
(``_first_difference``, ``_same_or_near_tie``), on CPU boosters of the
port: where two models' trees first differ, which differences count, and
that a first difference far from a tie is refused.  Exact: every case
compares a booster with a copy changed at one node."""
import copy

import numpy as np
import pytest

import chip_smoke as cs
import xgboost_tpu_torch as xtt


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(600, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float32)
    bst = xtt.train({"objective": "binary:logistic", "max_depth": 3,
                     "max_bin": 32}, xtt.DMatrix(X, label=y, device="cpu"),
                    2, verbose_eval=False, device="cpu")
    return X, bst


def _node(bst):
    """An internal node of tree 0 below the root, and the tree."""
    tree = bst.trees[0]
    return tree, int(tree.left_children[0])


def test_the_same_trees_have_no_first_difference(model):
    X, bst = model
    assert cs._first_difference(bst, copy.deepcopy(bst)) is None
    assert cs._first_difference(bst, copy.deepcopy(bst), X) is None


def test_a_threshold_that_moves_rows_is_a_difference(model):
    X, bst = model
    got = copy.deepcopy(bst)
    tree, n = _node(got)
    rows = cs._node_rows(tree, X, n)[n]
    tree.split_conditions[n] = np.median(X[rows, tree.split_indices[n]])
    assert cs._first_difference(got, bst) == (0, n)
    assert cs._first_difference(got, bst, X) == (0, n)


def test_a_threshold_that_moves_no_row_is_none_with_the_rows(model):
    X, bst = model
    got = copy.deepcopy(bst)
    tree, n = _node(got)
    rows = cs._node_rows(tree, X, n)[n]
    x = X[rows, tree.split_indices[n]]
    below = x[x < tree.split_conditions[n]]
    # halfway to the largest value of the node's rows still going left
    tree.split_conditions[n] = np.float32(
        (below.max() + tree.split_conditions[n]) / 2)
    assert cs._first_difference(got, bst) == (0, n)
    assert cs._first_difference(got, bst, X) is None


def test_a_default_direction_counts_only_where_rows_miss(model):
    X, bst = model
    got = copy.deepcopy(bst)
    tree, n = _node(got)
    tree.default_left[n] = not tree.default_left[n]
    assert cs._first_difference(got, bst) == (0, n)
    assert cs._first_difference(got, bst, X) is None  # X has no NaN
    Xm = X.copy()
    Xm[:, tree.split_indices[n]] = np.nan
    assert cs._first_difference(got, bst, Xm) == (0, n)


@pytest.mark.parametrize("factor, tie", [(1.0, True), (2.0, False)])
def test_a_first_difference_passes_only_at_a_tie(model, factor, tie):
    """Another feature at one node: with its gain equal to the other's it
    is a tie (the same splits before it agree exactly, so the noise is
    0); at twice the gain it is refused."""
    X, bst = model
    got = copy.deepcopy(bst)
    tree, n = _node(got)
    tree.split_indices[n] = (tree.split_indices[n] + 1) % X.shape[1]
    tree.loss_changes[n] = tree.loss_changes[n] * np.float32(factor)
    logged = []
    check = lambda: cs._same_or_near_tie(  # noqa: E731
        got, bst, "t", 1, lambda: 0.0, 1e-6, "a changed copy", X)
    cs_log, cs.log = cs.log, logged.append
    try:
        if tie:
            assert check() == (0, n)
        else:
            with pytest.raises(AssertionError, match="not at a near tie"):
                check()
    finally:
        cs.log = cs_log
    assert "first differs at node" in logged[0]
