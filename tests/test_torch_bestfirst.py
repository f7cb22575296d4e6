"""The port's best-first grower (grow_policy=lossguide with max_leaves > 1,
xgboost_tpu_torch/tree/bestfirst.py) against xgboost_tpu.train on the same
numpy input: the cases of tests/test_bestfirst.py, cut to 2000 rows.
Split features and children are equal and predictions agree within 1e-4
(f32 histograms: sums in another order, as tests/test_torch_train.py holds
the depthwise path), on data whose seeds give no near-tie of two splits
that those sums could flip.  Models cross-load between the packages in both
directions as JSON, and deterministic_histogram raises as in the
reference."""
import json

import numpy as np
import pytest

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt


def _skewed(n=2000, seed=0):
    """Data that rewards a deep chain on one feature."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, size=(n, 4)).astype(np.float32)
    return X, np.floor(X[:, 0] * 40).astype(np.float32)


def _both(params, X, y, rounds, **dm):
    ref = xtb.train(params, xtb.DMatrix(X, label=y, **dm), rounds,
                    verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu", **dm),
                    rounds, verbose_eval=False, device="cpu")
    assert len(got.trees) == len(ref.trees)
    for a, b in zip(got.trees, ref.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
        np.testing.assert_array_equal(a.left_children, b.left_children)
        np.testing.assert_array_equal(a.right_children, b.right_children)
    np.testing.assert_allclose(got.predict(xtt.DMatrix(X, device="cpu")),
                               ref.predict(xtb.DMatrix(X)), atol=1e-4)
    return ref, got


def test_bestfirst_exceeds_depth_ten():
    """max_depth=0 (unbounded) and a leaf budget: the table-order tree
    grows past ten levels, and the writer and predictor take it."""
    X, y = _skewed()
    ref, got = _both({"objective": "reg:squarederror", "max_depth": 0,
                      "grow_policy": "lossguide", "max_leaves": 40,
                      "eta": 1.0, "max_bin": 64}, X, y, 1)
    t = got.trees[0]
    assert int((t.left_children == -1).sum()) <= 40
    assert t.max_depth > 10, t.max_depth
    p = got.predict(xtt.DMatrix(X, device="cpu"))
    assert np.mean((p - y) ** 2) < np.var(y) * 0.05


def test_bestfirst_budget_and_quality():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(2000, 8)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + X[:, 2] > 0).astype(np.float32)
    ref, got = _both({"objective": "binary:logistic",
                      "grow_policy": "lossguide", "max_leaves": 16,
                      "max_depth": 0, "eta": 0.3}, X, y, 10)
    for t in got.trees:
        assert int((t.left_children == -1).sum()) <= 16
    p = got.predict(xtt.DMatrix(X, device="cpu"))
    first = xtt.Booster(device="cpu")
    first.load_model_dict(got.save_raw_dict())
    p1 = first.predict(xtt.DMatrix(X, device="cpu"), iteration_range=(0, 1))
    ll = lambda q: -np.mean(y * np.log(q) + (1 - y) * np.log(1 - q))  # noqa
    assert ll(p) < ll(p1)


def test_bestfirst_respects_max_depth():
    X, y = _skewed(seed=2)
    _, got = _both({"objective": "reg:squarederror", "max_depth": 4,
                    "grow_policy": "lossguide", "max_leaves": 64,
                    "max_bin": 64}, X, y, 1)
    assert got.trees[0].max_depth <= 4


def test_bestfirst_matches_depthwise_on_balanced_data():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(2000, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2 > 0.5).astype(np.float32)
    _, bf = _both({"objective": "binary:logistic", "grow_policy": "lossguide",
                   "max_leaves": 32, "max_depth": 0, "eta": 0.3}, X, y, 8)
    dw = xtt.train({"objective": "binary:logistic", "max_depth": 5,
                    "eta": 0.3}, xtt.DMatrix(X, label=y, device="cpu"), 8,
                   verbose_eval=False, device="cpu")

    def ll(b):
        p = np.clip(b.predict(xtt.DMatrix(X, device="cpu")), 1e-7, 1 - 1e-7)
        return -np.mean(y * np.log(p) + (1 - y) * np.log(1 - p))

    assert ll(bf) < ll(dw) * 1.25


@pytest.mark.parametrize("params", [
    {"subsample": 0.7, "colsample_bynode": 0.6, "seed": 4},
    {"sampling_method": "gradient_based", "subsample": 0.5},
    {"monotone_constraints": "(1,0,0,-1,0,0)",
     "interaction_constraints": [[0, 1, 2], [3, 4]]},
    {"max_delta_step": 0.7, "alpha": 0.5, "gamma": 0.2,
     "min_child_weight": 3.0},
])
def test_bestfirst_options_match_reference(params):
    rng = np.random.default_rng(6)
    X = rng.normal(size=(1500, 6)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.8 * np.nan_to_num(X[:, 1])
         * (X[:, 2] > 0) > 0).astype(np.float32)
    fw = np.array([1.0, 2.0, 0.5, 1.0, 3.0, 0.0], np.float32)
    _both(dict(params, objective="binary:logistic", grow_policy="lossguide",
               max_leaves=12, max_depth=0, max_bin=32), X, y, 4,
          feature_weights=fw)


def test_lossguide_level_grower_matches_reference():
    """lossguide without a leaf budget grows level by level, to the
    resolved depth of 10 when max_depth is 0."""
    X, y = _skewed(seed=4)
    _both({"objective": "reg:squarederror", "grow_policy": "lossguide",
           "max_depth": 3, "max_bin": 32}, X, y, 2)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_bestfirst_json_round_trip(direction, tmp_path):
    X, y = _skewed(seed=6)
    params = {"objective": "reg:squarederror", "max_depth": 0,
              "grow_policy": "lossguide", "max_leaves": 24, "max_bin": 64}
    ref, got = _both(params, X, y, 3)
    path = str(tmp_path / "m.json")
    if direction == "port_to_reference":
        got.save_model(path)
        again = xtb.Booster(model_file=path).predict(xtb.DMatrix(X))
        want = got.predict(xtt.DMatrix(X, device="cpu"))
    else:
        ref.save_model(path)
        again = xtt.Booster(model_file=path, device="cpu").predict(
            xtt.DMatrix(X, device="cpu"))
        want = ref.predict(xtb.DMatrix(X))
    np.testing.assert_allclose(again, want, atol=1e-6)
    with open(path) as fh:
        trees = json.load(fh)["learner"]["gradient_booster"]["model"]["trees"]
    assert max(len(t["left_children"]) for t in trees) <= 2 * 24 - 1


def test_bestfirst_with_deterministic_histogram_raises():
    X, y = _skewed(n=256)
    params = {"grow_policy": "lossguide", "max_leaves": 8,
              "deterministic_histogram": 1}
    with pytest.raises(NotImplementedError, match="deterministic_histogram"):
        xtb.train(params, xtb.DMatrix(X, label=y), 1, verbose_eval=False)
    with pytest.raises(NotImplementedError, match="deterministic_histogram"):
        xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), 1,
                  verbose_eval=False, device="cpu")
