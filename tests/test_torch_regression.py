"""The port's regression, binary and count objectives, their metrics and
XLA's f32 transcendentals against xgboost_tpu on the same numpy inputs:
log, log1p, erf and cumsum bitwise, every gradient bitwise, weighted or
not, the links and init_estimation bitwise, the metrics within 1e-12, and
deterministic models byte-identical to the reference's on the CPU."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu import metric as ref_metric
from xgboost_tpu.objective import create_objective as ref_create
from xgboost_tpu_torch import metric
from xgboost_tpu_torch.convert import _plain, booster_to_dict
from xgboost_tpu_torch.objective import create_objective
from xgboost_tpu_torch.utils import fp


def _bits_equal(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape
    same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a)
                                                     & np.isnan(b))
    assert same.all(), (np.nonzero(~same.ravel())[0][:5],
                        a.ravel()[~same.ravel()][:5],
                        b.ravel()[~same.ravel()][:5])


EDGES = np.array([0.0, -0.0, 1e-40, -1e-40, 1.1754942e-38, 1.1754944e-38,
                  np.inf, -np.inf, np.nan, 1.0, -1.0, -0.99999994, 2.0,
                  0.41421354, 0.41421357, -0.41421357, 0.70710677,
                  0.7071068, 3.7439213, -3.7439213, 3.75, -4.0, 88.72,
                  3.4028235e38, -3.4028235e38, 1e-30], np.float32)


def _sweep(seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    return np.concatenate([bits, rng.uniform(-1, 3, 50_000).astype(
        np.float32), rng.normal(0, 2, 50_000).astype(np.float32), EDGES])


@pytest.mark.parametrize("name,ours,ref", [
    ("log", fp.log_f32, jnp.log),
    ("log1p", fp.log1p_f32, jnp.log1p),
    ("erf", fp.erf_f32, jax.lax.erf),
])
def test_transcendentals_bitwise(name, ours, ref):
    x = _sweep(hash(name) % 1000)
    _bits_equal(ours(torch.from_numpy(x)).numpy(), ref(jnp.asarray(x)))


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 31, 32, 33, 255, 256, 257,
                               1000, 4097, 70_001])
def test_cumsum_bitwise(n):
    rng = np.random.default_rng(n)
    x = rng.uniform(-1, 1, n).astype(np.float32)
    x[rng.random(n) < 0.05] = -0.0
    _bits_equal(fp.cumsum_f32(torch.from_numpy(x)).numpy(),
                jnp.cumsum(jnp.asarray(x)))
    _bits_equal(fp.cumsum_f32(torch.from_numpy(x).flip(0)).flip(0).numpy(),
                jnp.cumsum(jnp.asarray(x)[::-1])[::-1])


OBJECTIVES = [
    ("reg:squaredlogerror", {}),
    ("reg:pseudohubererror", {}),
    ("reg:pseudohubererror", {"huber_slope": 0.3}),
    ("reg:absoluteerror", {}),
    ("reg:logistic", {}),
    ("binary:logitraw", {"scale_pos_weight": 2.0}),
    ("binary:hinge", {}),
    ("count:poisson", {}),
    ("count:poisson", {"max_delta_step": 1.3}),
    ("reg:gamma", {}),
    ("reg:tweedie", {}),
    ("reg:tweedie", {"tweedie_variance_power": 1.2}),
    ("reg:expectileerror", {}),
    ("reg:expectileerror", {"expectile_alpha": [0.2, 0.5, 0.9]}),
    ("reg:quantileerror", {"quantile_alpha": 0.3}),
    ("reg:quantileerror", {"quantile_alpha": [0.1, 0.5, 0.9]}),
]


def _labels(name, R, rng):
    if name in ("binary:hinge", "reg:logistic", "binary:logitraw"):
        return (rng.random(R) < 0.4).astype(np.float32)
    if name == "count:poisson":
        return rng.poisson(2, R).astype(np.float32)
    if name in ("reg:gamma", "reg:tweedie", "reg:squaredlogerror"):
        return rng.gamma(2, 1, R).astype(np.float32)
    return rng.normal(0, 2, R).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,params", OBJECTIVES)
def test_gradient_bitwise(name, params, weighted):
    rng = np.random.default_rng(1)
    R = 2000
    obj, ref = create_objective(name, params), ref_create(name, params)
    K = obj.n_groups()
    assert K == ref.n_groups()
    pred = rng.normal(0, 2, (R, K)).astype(np.float32)
    pred[:5] = 0.0
    y = _labels(name, R, rng)
    w = rng.uniform(0.5, 2, R).astype(np.float32) if weighted else None
    got = obj.get_gradient(torch.from_numpy(pred), torch.from_numpy(y),
                           None if w is None else torch.from_numpy(w))
    want = ref.get_gradient(jnp.asarray(pred), jnp.asarray(y),
                            None if w is None else jnp.asarray(w))
    _bits_equal(got.numpy(), want)


@pytest.mark.parametrize("name,params", OBJECTIVES)
def test_links_and_estimation_bitwise(name, params):
    rng = np.random.default_rng(2)
    obj, ref = create_objective(name, params), ref_create(name, params)
    K = obj.n_groups()
    y = _labels(name, 1001, rng)
    w = rng.uniform(0.5, 2, 1001).astype(np.float32)
    for wt in (None, w):
        _bits_equal(
            obj.init_estimation(torch.from_numpy(y), None if wt is None
                                else torch.from_numpy(wt)).numpy(),
            ref.init_estimation(jnp.asarray(y), None if wt is None
                                else jnp.asarray(wt)))
    m = rng.normal(0, 3, (300, K)).astype(np.float32)
    _bits_equal(obj.pred_transform(torch.from_numpy(m)).numpy(),
                ref.pred_transform(jnp.asarray(m)))
    p = rng.uniform(0.01, 5, 300).astype(np.float32)
    p[:3] = [0.0, 1e-9, 1.0]
    _bits_equal(obj.prob_to_margin(torch.from_numpy(p)).numpy(),
                ref.prob_to_margin(jnp.asarray(p)))
    assert obj.default_metric() == ref.default_metric()
    assert obj.task_is_classification() == ref.task_is_classification()
    assert obj.adaptive_leaf() == ref.adaptive_leaf()
    for k in range(K if obj.adaptive_leaf() else 0):
        assert obj.adaptive_alpha(k) == ref.adaptive_alpha(k)


def test_median_and_quantile_of_nan_and_one_value():
    for y in ([3.0], [1.0, np.nan, 2.0], [-0.0, 0.0]):
        y = np.asarray(y, np.float32)
        obj = create_objective("reg:absoluteerror", {})
        ref = ref_create("reg:absoluteerror", {})
        _bits_equal(obj.init_estimation(torch.from_numpy(y), None).numpy(),
                    ref.init_estimation(jnp.asarray(y), None))
        q = {"quantile_alpha": [0.0, 0.25, 1.0]}
        _bits_equal(create_objective("reg:quantileerror", q).init_estimation(
            torch.from_numpy(y), None).numpy(),
            ref_create("reg:quantileerror", q).init_estimation(
                jnp.asarray(y), None))


def test_poisson_keeps_the_trees_max_delta_step():
    bst = xtt.Booster({"objective": "count:poisson"}, device="cpu")
    bst._configure()
    assert bst.tparam.max_delta_step == 0.0


@pytest.mark.parametrize("name", [
    "rmsle", "mae", "mape", "mphe", "poisson-nloglik", "gamma-nloglik",
    "gamma-deviance", "tweedie-nloglik", "tweedie-nloglik@1.2", "quantile",
    "quantile@0.3", "expectile", "aucpr", "ams", "ams@0.2",
])
def test_metrics_match_reference(name):
    rng = np.random.default_rng(6)
    p = rng.uniform(0.05, 3, 500)
    p[:50] = p[50:100]  # ties
    y = rng.gamma(2, 1, 500).astype(np.float32)
    if name in ("aucpr", "ams", "ams@0.2"):
        y = (rng.random(500) < p / 3).astype(np.float32)
    w = rng.random(500).astype(np.float32)
    kw = {"slope": 0.7} if name == "mphe" else {}
    for wt in (None, w):
        fn, _ = metric.create_metric(name)
        ref_fn, _ = ref_metric.create_metric(name)
        assert fn(p, y, wt, **kw) == pytest.approx(ref_fn(p, y, wt, **kw),
                                                   rel=1e-12)


@pytest.mark.parametrize("name", ["quantile", "quantile@0.9", "expectile",
                                  "expectile@0.1"])
def test_multi_alpha_metrics_match_reference(name):
    rng = np.random.default_rng(7)
    p = rng.normal(size=(400, 3))
    y = rng.normal(size=400).astype(np.float32)
    alphas = [0.1, 0.5, 0.9]
    fn, _ = metric.create_metric(name)
    ref_fn, _ = ref_metric.create_metric(name)
    assert fn(p, y, None, alphas=alphas) == pytest.approx(
        ref_fn(p, y, None, alphas=alphas), rel=1e-12)


def _data(R=1500, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.03] = np.nan
    z = np.nan_to_num(X[:, :3]) @ np.array([1.0, -0.5, 0.3], np.float32)
    z = (z + 0.1 * rng.normal(size=R)).astype(np.float32)
    zs = (z - z.mean()) / z.std()
    mu = np.exp(0.3 * zs)
    return X, {
        "cont": z,
        "count": rng.poisson(mu).astype(np.float32),
        "pos": rng.gamma(2.0, mu / 2.0).astype(np.float32),
        "binary": (z > 0).astype(np.float32),
    }


TRAIN = [
    ("reg:absoluteerror", {}, "cont"),
    ("reg:absoluteerror", {"grow_policy": "lossguide"}, "cont"),
    ("reg:quantileerror", {"quantile_alpha": [0.1, 0.5, 0.9]}, "cont"),
    ("count:poisson", {}, "count"),
    ("reg:tweedie", {}, "pos"),
    ("reg:gamma", {}, "pos"),
    ("reg:pseudohubererror", {"huber_slope": 0.5}, "cont"),
    ("reg:squaredlogerror", {}, "pos"),
    ("reg:logistic", {}, "binary"),
    ("binary:logitraw", {}, "binary"),
    ("binary:hinge", {}, "binary"),
    ("reg:expectileerror", {"expectile_alpha": [0.2, 0.8]}, "cont"),
]


def _train_both(params, X, y, rounds=8, **dm):
    dr = xtb.DMatrix(X, label=y, **dm)
    er, ep = {}, {}
    ref = xtb.train(params, dr, rounds, evals=[(dr, "train")],
                    verbose_eval=False, evals_result=er)
    dp = xtt.DMatrix(X, label=y, device="cpu", **dm)
    port = xtt.train(params, dp, rounds, evals=[(dp, "train")],
                     verbose_eval=False, evals_result=ep, device="cpu")
    return ref, port, dr, dp, er, ep


@pytest.mark.parametrize("name,params,target", TRAIN)
def test_deterministic_model_is_the_references(name, params, target):
    X, ys = _data()
    p = {"objective": name, "max_depth": 4, "eta": 0.3,
         "deterministic_histogram": 1, **params}
    ref, port, dr, dp, er, ep = _train_both(p, X, ys[target])
    assert json.dumps(port.save_raw_dict()) == json.dumps(
        _plain(ref.save_raw_dict()))
    np.testing.assert_array_equal(port.predict(dp), ref.predict(dr))
    assert ep == er


def _structure(d):
    return [(t["left_children"], t["split_indices"])
            for t in d["learner"]["gradient_booster"]["model"]["trees"]]


@pytest.mark.parametrize("name,params,target", [
    ("reg:absoluteerror", {"grow_policy": "lossguide", "max_leaves": 9,
                           "max_depth": 0}, "cont"),
    ("reg:quantileerror", {"quantile_alpha": [0.2, 0.7],
                           "grow_policy": "lossguide", "max_leaves": 7},
     "cont"),
    ("reg:expectileerror", {"expectile_alpha": [0.2, 0.8], "_lockstep": 1},
     "cont"),
    ("count:poisson", {}, "count"),
    ("reg:logistic", {}, "binary"),
])
def test_f32_trees_have_the_references_structure(name, params, target):
    X, ys = _data(seed=3)
    p = {"objective": name, "max_depth": 4, "eta": 0.3, **params}
    ref, port, dr, dp, _, _ = _train_both(p, X, ys[target], rounds=5)
    assert _structure(port.save_raw_dict()) == _structure(
        ref.save_raw_dict())
    # f32 histograms sum in another order: test_torch_train's tolerance
    np.testing.assert_allclose(port.predict(dp, output_margin=True),
                               ref.predict(dr, output_margin=True),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name,params,target", TRAIN)
def test_models_convert_both_ways(name, params, target):
    """A multi-alpha model's file holds no alphas (the reference's schema):
    both packages load it given them."""
    X, ys = _data(R=600, seed=4)
    p = {"objective": name, "max_depth": 3, **params}
    dp = xtt.DMatrix(X, label=ys[target], device="cpu")
    port = xtt.train(p, dp, 4, verbose_eval=False, device="cpu")
    ref = xtb.Booster(dict(params))
    ref.load_model_dict(booster_to_dict(port))
    assert ref.save_raw_dict()["learner"]["objective"]["name"] == name
    np.testing.assert_allclose(ref.predict(xtb.DMatrix(X)), port.predict(dp),
                               rtol=1e-6, atol=1e-6)
    rref = xtb.train(p, xtb.DMatrix(X, label=ys[target]), 4,
                     verbose_eval=False)
    back = xtt.Booster(dict(params), device="cpu")
    back.load_model_dict(_plain(rref.save_raw_dict()))
    np.testing.assert_allclose(back.predict(dp),
                               rref.predict(xtb.DMatrix(X)), rtol=1e-6,
                               atol=1e-6)


def test_multi_alpha_grows_one_tree_per_alpha():
    X, ys = _data(R=500)
    d = xtt.DMatrix(X, label=ys["cont"], device="cpu")
    bst = xtt.train({"objective": "reg:quantileerror",
                     "quantile_alpha": "[0.1, 0.9]", "max_depth": 2}, d, 3,
                    verbose_eval=False, device="cpu")
    assert len(bst.trees) == 6 and bst.tree_info == [0, 1] * 3
    assert bst.predict(d).shape == (500, 2)


def test_generic_metric_of_a_multi_alpha_model_tiles_labels():
    X, ys = _data(R=500)
    p = {"objective": "reg:quantileerror", "quantile_alpha": [0.1, 0.9],
         "max_depth": 2, "eval_metric": ["mae", "quantile", "quantile@0.9"]}
    ref, port, _, _, er, ep = _train_both(p, X, ys["cont"], rounds=3)
    assert ep == er
