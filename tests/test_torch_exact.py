"""Port parity for tree_method="exact" (tree/exact.py; reference
xgboost_tpu/tree/exact.py and core.py:953-1119): the host enumeration over
raw values, the pruner after each tree, and the round machinery shared
with the hist path (DART, parallel trees, column and row sampling, the
adaptive refit), held against xgboost_tpu on the same numpy input; the
reference's own cases (tests/test_exact.py) ported.

Tolerance: none.  Both packages run the same numpy enumeration on the
same gradients (the reference's bits), so the model JSON is
byte-identical, with or without deterministic_histogram, which exact
refuses anyway."""
import json

import numpy as np
import pytest

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu.metric import auc as ref_auc
from xgboost_tpu.tree.exact import grow_exact as ref_grow_exact
from xgboost_tpu_torch.tree.exact import grow_exact

EXACT = {"tree_method": "exact", "max_depth": 4, "eta": 0.3,
         "objective": "binary:logistic"}


def _data(seed=0, n=1500, f=8, sparsity=0.05):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    if sparsity:
        X[rng.random((n, f)) < sparsity] = np.nan
    logit = np.nan_to_num(X[:, 0]) * 1.5 + np.nan_to_num(X[:, 1]) ** 2 - 1.0
    z = (logit + rng.normal(scale=0.5, size=n)).astype(np.float32)
    return X, z


def _json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _labels(z, objective):
    if objective in ("binary:logistic",):
        return (z > 0).astype(np.float32)
    if objective.startswith("multi:"):
        return np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    return z


def _both(params, rounds=5, sparsity=0.05, **dm):
    X, z = _data(sparsity=sparsity)
    y = _labels(z, params["objective"])
    ref = xtb.train(params, xtb.DMatrix(X, label=y, **dm), rounds,
                    verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu", **dm),
                    rounds, verbose_eval=False, device="cpu")
    return X, y, ref, got


CASES = {
    "plain": ({}, {}),
    "dense": ({}, {"sparsity": 0.0}),
    "many_nans": ({}, {"sparsity": 0.4}),
    "min_child_weight": ({"min_child_weight": 5.0}, {}),
    "gamma_prunes": ({"gamma": 2.0, "max_depth": 6}, {}),
    "alpha": ({"alpha": 1.0, "lambda": 0.5}, {}),
    "max_delta_step": ({"max_delta_step": 0.7, "eta": 1.0}, {}),
    "column_sampling": ({"colsample_bytree": 0.8, "colsample_bylevel": 0.8,
                         "colsample_bynode": 0.7, "seed": 5}, {}),
    "row_sampling": ({"subsample": 0.7, "seed": 2}, {}),
    "gradient_sampling": ({"subsample": 0.7,
                           "sampling_method": "gradient_based"}, {}),
    "parallel_trees": ({"num_parallel_tree": 3, "subsample": 0.8,
                        "colsample_bynode": 0.8}, {}),
    "softprob": ({"objective": "multi:softprob", "num_class": 3}, {}),
    "squarederror": ({"objective": "reg:squarederror"}, {}),
    "absoluteerror": ({"objective": "reg:absoluteerror"}, {}),
    "weighted_quantile": ({"objective": "reg:quantileerror",
                           "quantile_alpha": 0.3}, {"weights": True}),
    "max_leaves": ({"max_depth": 0, "max_leaves": 8,
                    "min_child_weight": 0.0}, {}),
    "dart": ({"booster": "dart", "rate_drop": 0.3, "seed": 1}, {}),
    "dart_weighted_forest": ({"booster": "dart", "rate_drop": 0.3,
                              "sample_type": "weighted",
                              "normalize_type": "forest", "one_drop": 1,
                              "objective": "reg:squarederror"}, {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_exact_model_is_the_references(name):
    extra, opts = CASES[name]
    params = dict(EXACT, **extra)
    X, z = _data(sparsity=opts.get("sparsity", 0.05))
    y = _labels(z, params["objective"])
    w = (np.random.default_rng(9).random(len(y)).astype(np.float32) + 0.5
         if opts.get("weights") else None)
    ref = xtb.train(params, xtb.DMatrix(X, label=y, weight=w), 5,
                    verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=y, weight=w, device="cpu"),
                    5, verbose_eval=False, device="cpu")
    assert _json(got) == _json(ref)
    if name == "gamma_prunes":
        # the pruner engaged: no leaf-pair parent keeps a split below gamma
        for t in got.trees:
            lc, rc = t.left_children, t.right_children
            for nid in range(t.n_nodes):
                if lc[nid] != -1 and lc[lc[nid]] == -1 and lc[rc[nid]] == -1:
                    assert t.loss_changes[nid] >= 2.0 - 1e-6


def test_grow_exact_is_the_references():
    X, z = _data(n=800)
    rng = np.random.default_rng(3)
    g = rng.normal(size=800)
    h = rng.random(800) + 0.1
    a, pa = grow_exact(X, g, h, max_depth=5, min_child_weight=0.5)
    b, pb = ref_grow_exact(X, g, h, max_depth=5, min_child_weight=0.5)
    np.testing.assert_array_equal(pa, pb)
    assert a.to_json_dict(8, 0) == b.to_json_dict(8, 0)


@pytest.mark.parametrize("sparsity", [0.0, 0.3])
def test_exact_learns(sparsity):
    X, z = _data(sparsity=sparsity)
    Xt, zt = _data(seed=5, sparsity=sparsity)
    bst = xtt.train(EXACT, xtt.DMatrix(X, label=(z > 0).astype(np.float32),
                                       device="cpu"), 20, verbose_eval=False,
                    device="cpu")
    a = ref_auc(bst.predict(xtt.DMatrix(Xt, device="cpu")),
                (zt > 0).astype(np.float32))
    assert a > 0.85, a


def test_exact_missingness_signal_split():
    """colmaker's end-of-enumeration candidate: a constant column whose
    NaN pattern is the label splits."""
    rng = np.random.default_rng(6)
    X = np.ones((400, 2), np.float32)
    X[:, 1] = rng.normal(size=400)
    miss = rng.random(400) < 0.5
    X[miss, 0] = np.nan
    y = miss.astype(np.float32)
    bst = xtt.train({"objective": "binary:logistic", "tree_method": "exact",
                     "max_depth": 3, "eta": 0.5},
                    xtt.DMatrix(X, label=y, device="cpu"), 5,
                    verbose_eval=False, device="cpu")
    t = bst.trees[0]
    assert t.n_nodes > 1 and t.split_indices[0] == 0
    p = bst.predict(xtt.DMatrix(X, device="cpu"))
    assert float(np.mean((p > 0.5) == (y > 0.5))) > 0.99


def test_exact_model_roundtrip_and_continuation(tmp_path):
    X, y, ref, got = _both(EXACT)
    path = str(tmp_path / "m.ubj")
    got.save_model(path)
    back = xtt.Booster(model_file=path, device="cpu")
    d = xtt.DMatrix(X, device="cpu")
    np.testing.assert_array_equal(back.predict(d), got.predict(d))
    into_ref = xtb.Booster(model_file=path)
    np.testing.assert_array_equal(np.asarray(into_ref.predict(
        xtb.DMatrix(X))), np.asarray(ref.predict(xtb.DMatrix(X))))
    cont = xtt.train(EXACT, xtt.DMatrix(X, label=y, device="cpu"), 3,
                     xgb_model=got, verbose_eval=False, device="cpu")
    full = xtt.train(EXACT, xtt.DMatrix(X, label=y, device="cpu"), 8,
                     verbose_eval=False, device="cpu")
    assert _json(cont) == _json(full)


REFUSALS = {
    "categorical": ({}, {"feature_types": ["q"] * 7 + ["c"]},
                    NotImplementedError),
    "monotone": ({"monotone_constraints": "(1,0,0,0,0,0,0,0)"}, {},
                 NotImplementedError),
    "interaction": ({"interaction_constraints": "[[0, 1]]"}, {},
                    NotImplementedError),
    "lossguide": ({"grow_policy": "lossguide"}, {}, ValueError),
    "unbounded": ({"max_depth": 0}, {}, ValueError),
    "deterministic_histogram": ({"deterministic_histogram": 1}, {},
                                NotImplementedError),
    "vector_leaves": ({"objective": "reg:squarederror", "num_target": 2,
                       "multi_strategy": "multi_output_tree"}, {"K": 2},
                      NotImplementedError),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_exact_refusals_are_the_references(name):
    extra, dm, exc = REFUSALS[name]
    X, z = _data(n=200)
    X = np.abs(X)
    y = (z > 0).astype(np.float32)
    if dm.pop("K", None):
        y = np.stack([z, -z], axis=1)
    if "feature_types" in dm:
        X[:, -1] = np.floor(np.nan_to_num(X[:, -1]))
    params = dict(EXACT, **extra)
    with pytest.raises(exc):
        xtb.train(params, xtb.DMatrix(X, label=y, **dm), 2,
                  verbose_eval=False)
    with pytest.raises(exc):
        xtt.train(params, xtt.DMatrix(X, label=y, device="cpu", **dm), 2,
                  verbose_eval=False, device="cpu")


def test_exact_builds_no_sketch():
    X, z = _data(n=300)
    d = xtt.DMatrix(X, label=(z > 0).astype(np.float32), device="cpu")
    bst = xtt.train(EXACT, d, 2, verbose_eval=False, device="cpu")
    assert d._ellpack is None
    assert bst._grower is None
    assert bst._caches[id(d)].ellpack is None
