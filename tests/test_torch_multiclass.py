"""Port parity for multiclass (multi:softprob, multi:softmax) and forest
(num_parallel_tree) boosting, held against xgboost_tpu on the same numpy
input.

Tolerances:
- the softmax gradient and the deterministic_histogram=1 model JSON are
  bitwise / byte-identical to the reference's;
- the f32 histogram path grows the same trees, margins within 1e-4: f32
  sums in another order move leaf values by a few 1e-6 (3 rounds of 3
  classes here: at most 3.6e-5), as tests/test_torch_deterministic.py
  explains for the binary path, which it holds at the same 1e-4;
- the golden multiclass model (written by dmlc/xgboost) predicts its
  recorded margins within 1e-5, as tests/test_golden_models.py holds the
  reference;
- metrics agree with the reference's to 1e-12 (both reduce in f64 on the
  host).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu import metric as ref_metric
from xgboost_tpu.objective import create_objective as ref_objective
from xgboost_tpu_torch import metric
from xgboost_tpu_torch.convert import booster_from_dict, booster_to_dict
from xgboost_tpu_torch.objective import create_objective

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "data", "models")


def _data(K, R=1500, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    z = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])
         - 0.4 * np.nan_to_num(X[:, 2]) ** 2 + 0.3 * rng.normal(size=R))
    y = np.digitize(z, np.quantile(z, np.linspace(0, 1, K + 1)[1:-1]))
    w = rng.uniform(0.5, 2.0, R).astype(np.float32)
    return X, y.astype(np.float32), w


def _json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _train_both(params, X, y, rounds=3, **dm):
    ref = xtb.train(params, xtb.DMatrix(X, label=y, **dm), rounds,
                    verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu", **dm),
                    rounds, verbose_eval=False, device="cpu")
    return ref, got


def _margins(K, R=20_000, seed=1):
    """Margins of N(0, 4^2), a quarter across [-100, 100], and rows where
    one class leads by 88 or more (their other classes' exponentials
    flush to zero); weights in [0.5, 2] but an eighth of 1e-38 to 1e-36
    (subnormal products) and a hundred subnormal weights."""
    rng = np.random.default_rng(seed)
    m = (rng.normal(size=(R, K)) * 4).astype(np.float32)
    m[: R // 4] = rng.uniform(-100, 100, (R // 4, K))
    m[R // 4: R // 4 + 500, 0] = 95.0
    m[R // 4: R // 4 + 500, 1] = 7.0
    lab = rng.integers(0, K, R).astype(np.float32)
    w = rng.uniform(0.5, 2.0, R).astype(np.float32)
    w[: R // 8] = rng.uniform(1e-38, 1e-36, R // 8)
    w[R // 8: R // 8 + 100] = np.float32(1e-39)
    return m, lab, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("K", [3, 7])
def test_softmax_gradient_is_the_references_bits(K, weighted):
    m, lab, w = _margins(K)
    ww = w if weighted else None
    want = np.asarray(ref_objective("multi:softprob", {"num_class": K})
                      .get_gradient(jnp.asarray(m), jnp.asarray(lab),
                                    None if ww is None else jnp.asarray(ww)))
    got = create_objective("multi:softprob", {"num_class": K}).get_gradient(
        torch.from_numpy(m), torch.from_numpy(lab),
        None if ww is None else torch.from_numpy(ww)).numpy()
    assert got.shape == want.shape == (len(m), K, 2)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if weighted:  # the flushes are exercised: XLA zeroes subnormal products
        assert (want[: len(m) // 8] == 0).sum() > len(m) // 8


@pytest.mark.parametrize("objective", ["multi:softprob", "multi:softmax"])
def test_pred_transform_is_the_references(objective):
    m, _, _ = _margins(5, R=5000)
    ref = ref_objective(objective, {"num_class": 5})
    got = create_objective(objective, {"num_class": 5})
    want = np.asarray(ref.pred_transform(jnp.asarray(m)))
    out = got.pred_transform(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("K", [3, 7])
def test_deterministic_json_is_the_references(K, sampled):
    """Depth 4, max_bin 32, 3 rounds; sampled: subsample, colsample_bynode
    and weights (the K class trees share one column sampler a round)."""
    X, y, w = _data(K)
    params = {"objective": "multi:softprob", "num_class": K, "max_depth": 4,
              "max_bin": 32, "eta": 0.3, "deterministic_histogram": 1}
    dm = {}
    if sampled:
        params.update(subsample=0.8, colsample_bynode=0.8, seed=3)
        dm["weight"] = w
    ref, got = _train_both(params, X, y, **dm)
    assert len(got.trees) == 3 * K
    assert _json(got) == _json(ref)


def test_f32_path_grows_the_references_trees():
    X, y, _ = _data(3)
    params = {"objective": "multi:softprob", "num_class": 3, "max_depth": 4,
              "max_bin": 32, "eta": 0.3}
    ref, got = _train_both(params, X, y)
    assert got.tree_info == ref.tree_info == [0, 1, 2] * 3
    for a, b in zip(got.trees, ref.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
        np.testing.assert_array_equal(a.left_children, b.left_children)
    np.testing.assert_allclose(
        got.predict(xtt.DMatrix(X, device="cpu"), output_margin=True),
        ref.predict(xtb.DMatrix(X), output_margin=True), atol=1e-4)


def test_golden_multiclass_model_margins():
    """A 4-class model written by dmlc/xgboost with a vector intercept."""
    bst = xtt.Booster(model_file=os.path.join(GOLD, "multiclass.json"),
                      device="cpu")
    X = np.load(os.path.join(GOLD, "golden_X.npy"))
    got = bst.predict(xtt.DMatrix(X, device="cpu"), output_margin=True)
    want = np.load(os.path.join(GOLD, "multiclass_margin.npy"))
    assert got.shape == want.shape == (X.shape[0], 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert bst.num_boosted_rounds() == 5


def test_vector_base_score_loads_and_saves():
    """The bracketed per-class intercept is read whole and written back
    bracketed (it used to be cut to its first value)."""
    ref = xtb.Booster()
    ref.load_model(os.path.join(GOLD, "multiclass.json"))
    raw = json.load(open(os.path.join(GOLD, "multiclass.json")))
    raw["learner"].get("attributes", {}).pop("base_margin_exact", None)
    got = booster_from_dict(raw, device="cpu")
    np.testing.assert_array_equal(got.base_score, ref.base_score)
    assert len(set(got.base_score.tolist())) == 4
    lmp = got.save_raw_dict()["learner"]["learner_model_param"]
    assert lmp["base_score"].startswith("[") and lmp["num_class"] == "4"
    assert lmp["base_score"] == \
        ref.save_raw_dict()["learner"]["learner_model_param"]["base_score"]
    bad = json.loads(json.dumps(raw))
    bad["learner"]["learner_model_param"]["base_score"] = "[0.1,0.2]"
    with pytest.raises(ValueError, match="output groups"):
        booster_from_dict(bad, device="cpu")


@pytest.mark.parametrize("name", ["merror", "mlogloss", "auc"])
@pytest.mark.parametrize("weighted", [False, True])
def test_multiclass_metrics_match_reference(name, weighted):
    m, lab, w = _margins(4, R=3000)
    p = np.asarray(ref_objective("multi:softprob", {"num_class": 4})
                   .pred_transform(jnp.asarray(m / 8)))
    ww = w.clip(0.5) if weighted else None
    fn, _ = metric.create_metric(name)
    rfn, _ = ref_metric.create_metric(name)
    assert abs(fn(p, lab, ww) - rfn(p, lab, ww)) <= 1e-12
    if name == "merror":  # multi:softmax hands it the classes
        cls = np.argmax(p, axis=1).astype(np.float32)
        assert abs(fn(cls, lab, ww) - rfn(cls, lab, ww)) <= 1e-12


@pytest.mark.parametrize("objective", ["multi:softprob", "multi:softmax"])
def test_eval_log_matches_reference(objective):
    """Multiclass evaluation sees the (R, K) probabilities or the (R,)
    classes, not a first column."""
    X, y, _ = _data(3)
    params = {"objective": objective, "num_class": 3, "max_depth": 3,
              "max_bin": 32, "deterministic_histogram": 1,
              "eval_metric": ["mlogloss", "merror", "auc"]
              if objective == "multi:softprob" else ["merror"]}
    logs = []
    for pkg, kw in ((xtb, {}), (xtt, {"device": "cpu"})):
        d = pkg.DMatrix(X, label=y, **kw)
        log: dict = {}
        pkg.train(params, d, 3, evals=[(d, "train")], evals_result=log,
                  verbose_eval=False, **kw)
        logs.append(log)
    for m in logs[0]["train"]:
        np.testing.assert_allclose(logs[1]["train"][m], logs[0]["train"][m],
                                   rtol=1e-6)
    assert logs[1]["train"]["merror"][-1] < 0.5


@pytest.mark.parametrize("num_class", [0, 3])
def test_forest_json_is_the_references(num_class):
    """num_parallel_tree=3 with row and column sampling; with num_class,
    3 x 3 trees a round."""
    X, y, w = _data(3)
    params = {"max_depth": 3, "max_bin": 32, "eta": 1.0,
              "num_parallel_tree": 3, "subsample": 0.8,
              "colsample_bynode": 0.8, "seed": 5,
              "deterministic_histogram": 1}
    if num_class:
        params.update(objective="multi:softprob", num_class=num_class)
    else:
        params.update(objective="binary:logistic")
        y = (y > 0).astype(np.float32)
    ref, got = _train_both(params, X, y, rounds=2)
    assert len(got.trees) == 2 * 3 * max(num_class, 1)
    assert got.num_boosted_rounds() == ref.num_boosted_rounds() == 2
    assert _json(got) == _json(ref)
    assert got.save_raw_dict()["learner"]["gradient_booster"]["model"][
        "gbtree_model_param"]["num_parallel_tree"] == "3"


@pytest.mark.parametrize("objective,num_class,forest", [
    ("multi:softprob", 3, 1), ("multi:softmax", 3, 1),
    ("binary:logistic", 0, 2), ("multi:softprob", 3, 2)])
def test_iteration_range_and_strict_shape(objective, num_class, forest):
    """iteration_range counts rounds of num_class x num_parallel_tree
    trees; the outputs keep the class axis, and strict_shape keeps the
    one of a single group."""
    X, y, _ = _data(3, R=600)
    if not num_class:
        y = (y > 0).astype(np.float32)
    params = {"objective": objective, "max_depth": 3, "max_bin": 16,
              "num_parallel_tree": forest, "deterministic_histogram": 1}
    if num_class:
        params["num_class"] = num_class
    ref, got = _train_both(params, X, y, rounds=4)
    assert got.num_boosted_rounds() == ref.num_boosted_rounds() == 4
    dr, dt = xtb.DMatrix(X), xtt.DMatrix(X, device="cpu")
    for kw in ({}, {"iteration_range": (1, 3)}, {"iteration_range": (0, 1)},
               {"output_margin": True, "iteration_range": (2, 4)},
               {"strict_shape": True}, {"output_margin": True,
                                        "strict_shape": True}):
        want = ref.predict(dr, **kw)
        out = got.predict(dt, **kw)
        assert out.shape == want.shape, kw
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    full = got.predict(dt, output_margin=True, strict_shape=True)
    part = got.predict(dt, output_margin=True, strict_shape=True,
                       iteration_range=(0, 2))
    assert not np.array_equal(full, part)


def test_multi_softmax_predicts_classes():
    X, y, _ = _data(4)
    params = {"objective": "multi:softmax", "num_class": 4, "max_depth": 4,
              "max_bin": 32}
    got = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), 5,
                    verbose_eval=False, device="cpu")
    cls = got.predict(xtt.DMatrix(X, device="cpu"))
    assert cls.shape == (len(X),) and set(np.unique(cls)) <= {0, 1, 2, 3}
    assert np.mean(cls != y) < 0.5
    with pytest.raises(ValueError, match="num_class"):
        xtt.train({"objective": "multi:softprob"},
                  xtt.DMatrix(X, label=y, device="cpu"), 1,
                  verbose_eval=False, device="cpu")


@pytest.mark.parametrize("kind", ["multiclass", "forest", "continued"])
def test_models_carry_across_both_ways(kind):
    """convert.py carries a multiclass model with a vector intercept, a
    forest and a model continued from a reload, in both directions, to
    the same predictions."""
    X, y, _ = _data(3, R=800)
    params = {"objective": "multi:softprob", "num_class": 3, "max_depth": 3,
              "max_bin": 16, "deterministic_histogram": 1}
    if kind == "forest":
        params.update(num_parallel_tree=2, subsample=0.7)
    d = xtt.DMatrix(X, label=y, device="cpu")
    port = xtt.train(params, d, 2, verbose_eval=False, device="cpu")
    if kind == "continued":
        port = xtt.train(params, d, 2, verbose_eval=False, device="cpu",
                         xgb_model=port.save_raw("ubj"))
    if kind == "multiclass":
        port._base_margin_value = np.asarray([0.1, -0.2, 0.3], np.float32)
    ref = xtb.Booster()
    ref.load_model_dict(booster_to_dict(port))
    back = booster_from_dict(ref.save_raw_dict(), device="cpu")
    want = port.predict(xtt.DMatrix(X, device="cpu"), output_margin=True)
    np.testing.assert_array_equal(
        ref.predict(xtb.DMatrix(X), output_margin=True), want)
    np.testing.assert_array_equal(
        back.predict(xtt.DMatrix(X, device="cpu"), output_margin=True), want)
    assert ref.num_boosted_rounds() == back.num_boosted_rounds() == \
        port.num_boosted_rounds()
    assert _json(back) == _json(port)
