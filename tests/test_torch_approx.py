"""Port parity for tree_method="approx" (updater_approx.cc grow_histmaker;
reference core.py:1456-1497): every round the rows are re-sketched with
their hessians as weights (the host sketch, data/quantile.py
``WeightedSketch``), the matrix binned against those cuts, and the
round's trees grown on them, held against xgboost_tpu on the same numpy
input.

Tolerances: the weighted cuts are bitwise the reference's; under
deterministic_histogram=1 the model JSON is byte-identical; on the f32
path the split features and children are equal and predictions agree
within 1e-4, as tests/test_torch_deterministic.py holds the hist path."""
import json

import numpy as np
import pytest

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu.data.quantile import sketch_dense as ref_sketch_dense
from xgboost_tpu_torch.data.quantile import WeightedSketch

APPROX = {"tree_method": "approx", "max_depth": 4, "max_bin": 32, "eta": 0.3,
          "deterministic_histogram": 1, "objective": "binary:logistic"}


def _data(R=1500, F=6, seed=0, n_cat=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    z = (np.nan_to_num(X[:, 0]) + 0.8 * np.nan_to_num(X[:, 1])
         * (X[:, 2] > 0) - 0.5 * np.nan_to_num(X[:, 3]) ** 2
         + 0.3 * rng.normal(size=R)).astype(np.float32)
    if n_cat:
        codes = rng.integers(0, n_cat, size=R).astype(np.float32)
        z = z + (codes % 3 == 1) - 0.5
        codes[rng.random(R) < 0.05] = np.nan
        X[:, -1] = codes
    return X, z


def _json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


@pytest.mark.parametrize("case", ["plain", "categorical", "zero_weights",
                                  "constant_column", "max_bin_2"])
def test_weighted_cuts_are_the_references(case):
    rng = np.random.default_rng(5)
    X, _ = _data(R=900, n_cat=7 if case == "categorical" else 0)
    w = rng.gamma(0.5, size=900)
    cat_mask, max_bin = None, 64
    if case == "categorical":
        cat_mask = np.array([False] * 5 + [True])
    elif case == "zero_weights":
        w[:] = 0.0  # the unweighted inverted-CDF quantiles
    elif case == "constant_column":
        X[:, 2] = 1.5
        X[:, 4] = np.nan
    elif case == "max_bin_2":
        max_bin = 2
    sketch = WeightedSketch(X, cat_mask)
    got = sketch.cuts(max_bin, w)
    want = ref_sketch_dense(X, max_bin, weights=w, use_device=False,
                            cat_mask=cat_mask)
    np.testing.assert_array_equal(got.cut_ptrs, want.cut_ptrs)
    np.testing.assert_array_equal(got.cut_values, want.cut_values)
    np.testing.assert_array_equal(got.min_vals, want.min_vals)
    # the weights move the cuts
    if case == "plain":
        flat = sketch.cuts(max_bin, np.ones(900))
        assert not np.array_equal(flat.cut_values, got.cut_values)
        # the same sketch under the first weights again: the same cuts
        np.testing.assert_array_equal(sketch.cuts(max_bin, w).cut_values,
                                      got.cut_values)


CASES = {
    "binary": ({}, {}),
    "squarederror": ({"objective": "reg:squarederror",
                      "base_score": 0.2}, {}),
    "softprob": ({"objective": "multi:softprob", "num_class": 3}, {}),
    "categorical": ({"max_cat_to_onehot": 4}, {"n_cat": 9}),
    "sampling": ({"subsample": 0.8, "colsample_bylevel": 0.7, "seed": 4,
                  "num_parallel_tree": 2}, {}),
    "monotone_leaves": ({"monotone_constraints": "(1,0,0,0,0,0)",
                         "max_leaves": 6}, {}),
    "max_bin_256": ({"max_bin": 256}, {}),
    "dart": ({"booster": "dart", "rate_drop": 0.3, "seed": 1}, {}),
}


def _both(params, rounds=5, n_cat=0):
    X, z = _data(n_cat=n_cat)
    obj = params["objective"]
    y = ((z > 0).astype(np.float32) if obj == "binary:logistic" else
         np.digitize(z, [-0.5, 0.5]).astype(np.float32)
         if obj.startswith("multi:") else z)
    ft = ["q"] * 5 + ["c"] if n_cat else None
    ref = xtb.train(params, xtb.DMatrix(X, label=y, feature_types=ft,
                                        enable_categorical=bool(n_cat)),
                    rounds, verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=y, feature_types=ft,
                                        enable_categorical=bool(n_cat),
                                        device="cpu"),
                    rounds, verbose_eval=False, device="cpu")
    return X, y, ref, got


@pytest.mark.parametrize("name", sorted(CASES))
def test_deterministic_approx_model_is_the_references(name):
    extra, data = CASES[name]
    X, y, ref, got = _both(dict(APPROX, **extra), **data)
    assert _json(got) == _json(ref)


def test_approx_grows_on_each_rounds_cuts():
    """The thresholds of approx trees are not the resident page's cuts
    alone: each round's sketch moves them."""
    X, y, _, got = _both(APPROX)
    hist = xtt.train(dict(APPROX, tree_method="hist"),
                     xtt.DMatrix(X, label=y, device="cpu"), 5,
                     verbose_eval=False, device="cpu")
    thr = lambda b: {float(v) for t in b.trees  # noqa: E731
                     for v, l in zip(t.split_conditions, t.left_children)
                     if l != -1}
    assert thr(got) - thr(hist)


def test_f32_approx_grows_the_references_trees():
    X, y, ref, got = _both(dict(APPROX, deterministic_histogram=0))
    assert len(got.trees) == len(ref.trees)
    for a, b in zip(got.trees, ref.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
        np.testing.assert_array_equal(a.left_children, b.left_children)
    np.testing.assert_allclose(got.predict(xtt.DMatrix(X, device="cpu")),
                               ref.predict(xtb.DMatrix(X)), atol=1e-4)


def test_f32_approx_lossguide_grows_the_references_trees():
    params = dict(APPROX, deterministic_histogram=0,
                  grow_policy="lossguide", max_leaves=8, max_depth=0)
    X, y, ref, got = _both(params, rounds=3)
    for a, b in zip(got.trees, ref.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
    np.testing.assert_allclose(got.predict(xtt.DMatrix(X, device="cpu")),
                               ref.predict(xtb.DMatrix(X)), atol=1e-4)


def test_approx_quality_is_the_hists():
    """(the reference's tests/test_updaters_process.py::
    test_approx_tree_method)"""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(2500, 6)).astype(np.float32)
    logits = X[:, 0] * 2 + X[:, 1]
    y = (logits + rng.normal(scale=0.5, size=2500) > 0).astype(np.float32)
    out = {}
    for tm in ("approx", "hist"):
        res = {}
        d = xtt.DMatrix(X, label=y, device="cpu")
        xtt.train({"objective": "binary:logistic", "tree_method": tm,
                   "max_depth": 4, "eta": 0.3, "max_bin": 64,
                   "eval_metric": "logloss"}, d, 8, evals=[(d, "t")],
                  evals_result=res, verbose_eval=False, device="cpu")
        out[tm] = res["t"]["logloss"]
    assert out["approx"][-1] < out["approx"][0]
    assert abs(out["approx"][-1] - out["hist"][-1]) < 0.05


def test_approx_continuation_and_config():
    X, z = _data()
    y = (z > 0).astype(np.float32)
    models = {}
    for pkg, kw in ((xtb, {}), (xtt, {"device": "cpu"})):
        half = pkg.train(APPROX, pkg.DMatrix(X, label=y, **kw), 3,
                         verbose_eval=False, **kw)
        cont = pkg.train(APPROX, pkg.DMatrix(X, label=y, **kw), 3,
                         xgb_model=half.save_raw("ubj"), verbose_eval=False,
                         **kw)
        models[pkg.__name__] = (_json(cont), json.loads(cont.save_config()))
    assert models["xgboost_tpu_torch"][0] == models["xgboost_tpu"][0]
    gbt = models["xgboost_tpu_torch"][1]["learner"]["gradient_booster"]
    assert gbt["gbtree_train_param"]["tree_method"] == "approx"
    full = xtt.train(APPROX, xtt.DMatrix(X, label=y, device="cpu"), 6,
                     verbose_eval=False, device="cpu")
    assert models["xgboost_tpu_torch"][0] == _json(full)
