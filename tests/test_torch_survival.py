"""The port's survival objectives and metrics against xgboost_tpu on the
same numpy inputs: AFT's gradient and hessian bitwise for each
distribution and each kind of censoring, Cox's with tied times bitwise,
the survival metrics within 1e-12, deterministic AFT and Cox models
byte-identical to the reference's, and the golden AFT model's margins."""
import json
import os

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

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "models")


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _bounds(kind, R, seed):
    rng = np.random.default_rng(seed)
    t = np.exp(rng.normal(0, 1, R)).astype(np.float32)
    lo, hi = t.copy(), t.copy()
    if kind == "right":
        hi[:] = np.inf
    elif kind == "left":
        lo[:] = 0.0
    elif kind == "interval":
        lo = (t * rng.uniform(0.3, 1, R)).astype(np.float32)
        hi = (t * rng.uniform(1, 3, R)).astype(np.float32)
    elif kind == "mixed":
        k = rng.integers(0, 4, R)
        hi[k == 1] = np.inf
        lo[k == 2] = 0.0
        hi[k == 3] = (t[k == 3] * 1.5).astype(np.float32)
    return t, lo, hi


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["uncensored", "right", "left", "interval",
                                  "mixed"])
@pytest.mark.parametrize("dist,sigma", [("normal", 1.0), ("normal", 0.7),
                                        ("logistic", 1.0),
                                        ("logistic", 2.0),
                                        ("extreme", 1.0),
                                        ("extreme", 0.5)])
def test_aft_gradient_bitwise(dist, sigma, kind, weighted):
    R = 2000
    t, lo, hi = _bounds(kind, R, seed=hash((dist, kind)) % 997)
    rng = np.random.default_rng(5)
    pred = rng.normal(0, 3, R).astype(np.float32)
    pred[:40] = rng.normal(0, 25, 40)  # beyond the +-15 clamps
    w = rng.uniform(0.5, 2, R).astype(np.float32) if weighted else None
    p = {"aft_loss_distribution": dist, "aft_loss_distribution_scale": sigma}
    ref = ref_create("survival:aft", p)
    ref.set_bounds(lo, hi)
    obj = create_objective("survival:aft", p)
    obj.set_bounds(torch.from_numpy(lo), torch.from_numpy(hi))
    got = obj.get_gradient(torch.from_numpy(pred)[:, None],
                           torch.from_numpy(t),
                           None if w is None else torch.from_numpy(w))
    want = ref.get_gradient(jnp.asarray(pred)[:, None], jnp.asarray(t),
                            None if w is None else jnp.asarray(w))
    _bits_equal(got.numpy(), want)


def test_aft_without_bounds_is_uncensored_at_the_label():
    t, _, _ = _bounds("uncensored", 300, seed=1)
    pred = np.linspace(-3, 3, 300).astype(np.float32)
    got = create_objective("survival:aft", {}).get_gradient(
        torch.from_numpy(pred)[:, None], torch.from_numpy(t), None)
    want = ref_create("survival:aft", {}).get_gradient(
        jnp.asarray(pred)[:, None], jnp.asarray(t), None)
    _bits_equal(got.numpy(), want)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("R", [7, 300, 2000])
def test_cox_gradient_with_ties_bitwise(R, weighted):
    rng = np.random.default_rng(R)
    t = np.round(rng.exponential(3, R), 1) + 0.1  # many tied times
    y = (t * np.where(rng.random(R) < 0.6, 1, -1)).astype(np.float32)
    pred = rng.normal(0, 1, (R, 1)).astype(np.float32)
    w = rng.uniform(0.5, 2, R).astype(np.float32) if weighted else None
    got = create_objective("survival:cox", {}).get_gradient(
        torch.from_numpy(pred), torch.from_numpy(y),
        None if w is None else torch.from_numpy(w))
    want = ref_create("survival:cox", {}).get_gradient(
        jnp.asarray(pred), jnp.asarray(y),
        None if w is None else jnp.asarray(w))
    _bits_equal(got.numpy(), want)


@pytest.mark.parametrize("dist", ["normal", "logistic", "extreme"])
def test_survival_metrics_match_reference(dist):
    R = 800
    t, lo, hi = _bounds("mixed", R, seed=3)
    rng = np.random.default_rng(4)
    preds = np.exp(rng.normal(0, 1, R))
    w = rng.random(R).astype(np.float32)
    kw = dict(y_lower=lo, y_upper=hi, dist=dist, sigma=0.8)
    for wt in (None, w):
        for name in ("aft-nloglik", "interval-regression-accuracy"):
            fn, _ = metric.create_metric(name)
            ref_fn, _ = ref_metric.create_metric(name)
            assert fn(preds, t, wt, **kw) == pytest.approx(
                ref_fn(preds, t, wt, **kw), rel=1e-12)
    y = (t * np.where(rng.random(R) < 0.5, 1, -1)).astype(np.float32)
    fn, _ = metric.create_metric("cox-nloglik")
    ref_fn, _ = ref_metric.create_metric("cox-nloglik")
    assert fn(preds, y) == pytest.approx(ref_fn(preds, y), rel=1e-12)


def _data(R=1500, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, 6)).astype(np.float32)
    z = X[:, :3] @ np.array([1.0, -0.5, 0.3], np.float32)
    zs = (z - z.mean()) / z.std()
    t = np.exp(zs / 2 + 0.3 * rng.normal(size=R)).astype(np.float32)
    k = rng.integers(0, 4, R)
    lo, hi = t.copy(), t.copy()
    hi[k == 2] = np.inf
    lo[k == 3] = (t[k == 3] * 0.7).astype(np.float32)
    hi[k == 3] = (t[k == 3] * 1.5).astype(np.float32)
    cox = (t * np.where(k == 2, -1, 1)).astype(np.float32)
    return X, t, lo, hi, cox


@pytest.mark.parametrize("params", [
    {"objective": "survival:aft"},
    {"objective": "survival:aft", "aft_loss_distribution": "logistic",
     "aft_loss_distribution_scale": 0.8},
    {"objective": "survival:aft", "aft_loss_distribution": "extreme",
     "eval_metric": ["aft-nloglik", "interval-regression-accuracy"]},
    {"objective": "survival:cox"},
])
def test_deterministic_survival_model_is_the_references(params):
    X, t, lo, hi, cox = _data()
    p = {"max_depth": 4, "eta": 0.3, "deterministic_histogram": 1, **params}
    if params["objective"] == "survival:cox":
        y, kw = cox, {}
    else:
        y, kw = t, dict(label_lower_bound=lo, label_upper_bound=hi)
    dr = xtb.DMatrix(X, label=y, **kw)
    dp = xtt.DMatrix(X, label=y, device="cpu", **kw)
    er, ep = {}, {}
    ref = xtb.train(p, dr, 8, evals=[(dr, "train")], verbose_eval=False,
                    evals_result=er)
    port = xtt.train(p, dp, 8, evals=[(dp, "train")], verbose_eval=False,
                     evals_result=ep, device="cpu")
    assert json.dumps(port.save_raw_dict()) == json.dumps(
        _plain(ref.save_raw_dict()))
    np.testing.assert_array_equal(port.predict(dp), ref.predict(dr))
    assert ep == er
    back = xtb.Booster(dict(params))
    back.load_model_dict(booster_to_dict(port))
    np.testing.assert_array_equal(back.predict(dr), ref.predict(dr))


def test_bounds_are_settable_info():
    X, t, lo, hi, _ = _data(R=200)
    d = xtt.DMatrix(X, label=t, device="cpu")
    d.label_lower_bound, d.label_upper_bound = lo, hi
    with pytest.raises(ValueError):
        xtt.DMatrix(X, label=t, label_lower_bound=lo[:5], device="cpu")
    ref = xtb.DMatrix(X, label=t, label_lower_bound=lo, label_upper_bound=hi)
    p = {"objective": "survival:aft", "max_depth": 3,
         "deterministic_histogram": 1}
    a = xtt.train(p, d, 3, verbose_eval=False, device="cpu")
    b = xtb.train(p, ref, 3, verbose_eval=False)
    np.testing.assert_array_equal(a.predict(d), b.predict(ref))


def test_golden_aft_model_margins():
    """The AFT model written by dmlc/xgboost (tests/test_golden_models.py)."""
    bst = xtt.Booster(model_file=os.path.join(GOLD, "aft.json"),
                      device="cpu")
    X = np.load(os.path.join(GOLD, "golden_X.npy"))
    got = bst.predict(xtt.DMatrix(X, device="cpu"), output_margin=True)
    np.testing.assert_allclose(got, np.load(os.path.join(
        GOLD, "aft_margin.npy")), rtol=1e-5, atol=1e-5)
    assert bst.objective.name == "survival:aft"
