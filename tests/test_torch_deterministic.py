"""Port parity for the depthwise level step's full feature set: training
with deterministic_histogram=1 (exact limb histograms), monotone and
interaction constraints, column sampling and the max_leaves budget, held
against xgboost_tpu.train on the same numpy input.

Tolerances:
- deterministic_histogram: split features, thresholds and children are
  equal; leaf values agree within rtol 1e-5 and atol 1e-6, predictions
  within atol 1e-5.  The base score, and so the gradients, can differ by an
  ulp between the packages (f32 sums in another order), which moves a
  quantised gradient by at most one step of rho / (2**22 - 1), about 1e-6
  here: a leaf near zero differs by that much in absolute terms.
- f32 histogram: split features and children are equal and predictions
  agree within atol 1e-4, as tests/test_torch_train.py holds the default
  path.  Thresholds and leaf values are not compared there: f32 sums in
  another order, amplified by the subtractions of the sibling trick and the
  missing-value statistics, move node sums by up to ~1e-5 relative, enough
  to pick the other bin of a near tie of the same feature."""
import json

import numpy as np
import pytest

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt


def _data(R=1500, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    z = (np.nan_to_num(X[:, 0]) + 0.8 * np.nan_to_num(X[:, 1])
         * (X[:, 2] > 0) - 0.5 * np.nan_to_num(X[:, 3]) ** 2)
    return X, z


def _train_both(params, objective="binary:logistic", rounds=5, seed=0):
    X, z = _data(seed=seed)
    y = (z > 0).astype(np.float32) if objective == "binary:logistic" else z
    params = dict(params, objective=objective)
    ref = xtb.train(params, xtb.DMatrix(X, label=y), rounds,
                    verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), rounds,
                    verbose_eval=False, device="cpu")
    return X, y, ref, got


def _assert_same_trees(ref, got, X, *, deterministic):
    assert len(got.trees) == len(ref.trees)
    for a, b in zip(got.trees, ref.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
        np.testing.assert_array_equal(a.left_children, b.left_children)
        if deterministic:
            inner = a.left_children != -1
            np.testing.assert_array_equal(a.split_conditions[inner],
                                          b.split_conditions[inner])
            np.testing.assert_allclose(a.split_conditions[~inner],
                                       b.split_conditions[~inner],
                                       rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.predict(xtt.DMatrix(X, device="cpu")),
                               ref.predict(xtb.DMatrix(X)),
                               atol=1e-5 if deterministic else 1e-4)


@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_deterministic_training_matches_reference(objective):
    params = {"max_depth": 4, "max_bin": 32, "eta": 0.3,
              "deterministic_histogram": 1}
    X, y, ref, got = _train_both(params, objective)
    _assert_same_trees(ref, got, X, deterministic=True)
    again = xtt.train(dict(params, objective=objective),
                      xtt.DMatrix(X, label=y, device="cpu"), 5,
                      verbose_eval=False, device="cpu")
    assert json.dumps(again.save_raw_dict()) == json.dumps(got.save_raw_dict())


CONSTRAINTS = {
    "monotone": {"monotone_constraints": "(1,0,0,-1,0,0)"},
    "interaction": {"interaction_constraints": [[0, 1, 2], [3, 4]]},
    "colsample_bytree": {"colsample_bytree": 0.5},
    "colsample_bylevel": {"colsample_bylevel": 0.6},
    "colsample_bynode": {"colsample_bynode": 0.7},
    "max_leaves": {"max_leaves": 6},
}
ALL = {k: v for d in CONSTRAINTS.values() for k, v in d.items()}
ALL.update(colsample_bytree=0.84, colsample_bylevel=0.8, colsample_bynode=0.8,
           max_leaves=9, seed=3)


@pytest.mark.parametrize("name", list(CONSTRAINTS) + ["all"])
def test_constraint_matches_reference(name):
    params = dict(CONSTRAINTS.get(name, ALL), max_depth=4, max_bin=32,
                  eta=0.3)
    X, _, ref, got = _train_both(params, seed=1)
    _assert_same_trees(ref, got, X, deterministic=False)
    n_leaves = [int((t.left_children == -1).sum()) for t in got.trees]
    if "max_leaves" in params:
        assert max(n_leaves) <= params["max_leaves"]


def test_all_constraints_deterministic_matches_reference():
    params = dict(ALL, max_depth=4, max_bin=32, eta=0.3,
                  deterministic_histogram=1)
    X, _, ref, got = _train_both(params, seed=2)
    _assert_same_trees(ref, got, X, deterministic=True)


def test_monotone_predictions_do_not_decrease():
    params = {"max_depth": 4, "max_bin": 32, "eta": 0.3,
              "monotone_constraints": "(1,0,0,-1,0,0)"}
    X, _, _, got = _train_both(params, seed=4)
    grid = np.linspace(-3, 3, 25, dtype=np.float32)
    rows = np.repeat(np.nan_to_num(X[:40]), len(grid), axis=0)
    for f, sign in ((0, 1), (3, -1)):
        r = rows.copy()
        r[:, f] = np.tile(grid, 40)
        p = got.predict(xtt.DMatrix(r, device="cpu")).reshape(40, -1)
        assert (sign * np.diff(p, axis=1) >= -1e-7).all()


def test_constraint_parameters_are_validated():
    X, z = _data(R=64)
    d = xtt.DMatrix(X, label=z, device="cpu")
    with pytest.raises(ValueError, match="monotone_constraints"):
        xtt.train({"monotone_constraints": "(1,0)"}, d, 1,
                  verbose_eval=False, device="cpu")
    with pytest.raises(ValueError, match="colsample_bytree"):
        xtt.train({"colsample_bytree": 0.0}, d, 1, verbose_eval=False,
                  device="cpu")
