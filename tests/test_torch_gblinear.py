"""Port parity for booster="gblinear" (models/gblinear.py; reference
xgboost_tpu/models/gblinear.py and core.py:586-667): both updaters, the
five feature selectors, several output groups, the model layout and its
refusals, held against xgboost_tpu on the same numpy input, with the
reference's own cases (tests/test_boosters.py) ported.

Tolerance: after 10 rounds the weights and bias agree with the
reference's within 1e-5 relative, 1e-6 absolute (``TOL``): the chain's
dot products and sums are PyTorch's, not XLA's order.  The selectors'
orders (cyclic, shuffle, random, and thrifty's ranking) are the
reference's exactly; predictions of a model loaded across the packages
agree within the same tolerance, and a golden model written by XGBoost
itself predicts its recorded margins within 1e-5."""
import json
import os

import numpy as np
import pytest

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu.models import gblinear as ref_gblinear
from xgboost_tpu_torch.models import gblinear

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = dict(rtol=1e-5, atol=1e-6)
LINEAR = {"booster": "gblinear", "eta": 0.5, "lambda": 0.1}


def _data(R=1500, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    z = (np.nan_to_num(X[:, 0]) - 2.0 * np.nan_to_num(X[:, 1])
         + 0.5 * np.nan_to_num(X[:, 4]) + 0.3 * rng.normal(size=R)
         ).astype(np.float32)
    return X, z


def _labels(z, objective):
    if objective == "binary:logistic":
        return (z > 0).astype(np.float32)
    if objective.startswith("multi:"):
        return np.digitize(z, [-1.0, 1.0]).astype(np.float32)
    return z


def _both(params, rounds=10, data=None):
    X, z = data if data is not None else _data()
    y = _labels(z, params.get("objective", "reg:squarederror"))
    ref = xtb.train(params, xtb.DMatrix(X, label=y), rounds,
                    verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), rounds,
                    verbose_eval=False, device="cpu")
    return X, y, ref, got


def _close(got, ref):
    np.testing.assert_allclose(got.linear_weights, ref.linear_weights, **TOL)
    np.testing.assert_allclose(got.linear_bias, ref.linear_bias, **TOL)


UPDATERS = {
    "coord_descent": {},
    "shotgun": {"updater": "shotgun"},
    "cyclic": {"updater": "shotgun", "feature_selector": "cyclic"},
    "random": {"updater": "shotgun", "feature_selector": "random",
               "seed": 3},
    "thrifty": {"feature_selector": "thrifty", "top_k": 3},
    "thrifty_all": {"feature_selector": "thrifty"},
    "greedy": {"feature_selector": "greedy", "top_k": 3},
    "greedy_all": {"feature_selector": "greedy", "updater": "shotgun"},
    "l1": {"alpha": 0.5, "lambda": 0.01},
}


@pytest.mark.parametrize("objective", ["reg:squarederror",
                                       "binary:logistic"])
@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_gblinear_weights_are_the_references(name, objective):
    params = dict(LINEAR, objective=objective, **UPDATERS[name])
    X, y, ref, got = _both(params)
    assert got.linear_weights.shape == (6, 1)
    _close(got, ref)
    assert got.num_boosted_rounds() == ref.num_boosted_rounds() == 10
    np.testing.assert_allclose(got.predict(xtt.DMatrix(X, device="cpu")),
                               np.asarray(ref.predict(xtb.DMatrix(X))),
                               **TOL)


@pytest.mark.parametrize("selector", ["cyclic", "greedy"])
def test_gblinear_several_output_groups(selector):
    params = dict(LINEAR, objective="multi:softprob", num_class=3,
                  feature_selector=selector)
    X, y, ref, got = _both(params)
    assert got.linear_weights.shape == (6, 3)
    _close(got, ref)
    np.testing.assert_allclose(got.predict(xtt.DMatrix(X, device="cpu")),
                               np.asarray(ref.predict(xtb.DMatrix(X))),
                               **TOL)


def test_selector_orders_are_the_references():
    for sel in ("cyclic", "shuffle", "random"):
        for rnd in range(4):
            np.testing.assert_array_equal(
                gblinear.selector_order(sel, 11, rnd, 7),
                ref_gblinear.selector_order(sel, 11, rnd, 7))
    rng = np.random.default_rng(31)
    X = rng.normal(size=(500, 6)).astype(np.float32)
    y = 3.0 * X[:, 2] + 1.0 * X[:, 0] + 0.5 * X[:, 4]
    gpair = np.stack([-y, np.ones_like(y)], axis=1)
    w0 = np.zeros(6, np.float32)
    for top_k in (0, 2):
        np.testing.assert_array_equal(
            gblinear.thrifty_order(X, gpair[:, 0], gpair[:, 1], w0,
                                   top_k=top_k, alpha=0.1, lambda_=1.0),
            ref_gblinear.thrifty_order(X, gpair, w0, top_k=top_k,
                                       alpha=0.1, lambda_=1.0))
    with pytest.raises(ValueError, match="gain-ranked"):
        gblinear.selector_order("greedy", 6, 0, 0)
    assert [gblinear.effective_top_k(k, 5) for k in (0, 3, 10)] == [5, 3, 5]


def test_greedy_picks_are_the_references():
    """(the reference's tests/test_boosters.py::
    test_gblinear_gain_selector_orders)"""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(31)
    X = rng.normal(size=(2000, 6)).astype(np.float32)
    y = 3.0 * X[:, 2] + 1.0 * X[:, 0] + 0.5 * X[:, 4]
    gpair = np.stack([-y, np.ones_like(y)], axis=1).astype(np.float32)
    w0 = np.zeros(6, np.float32)
    _, _, want = ref_gblinear.linear_update_greedy(
        jnp.asarray(X), jnp.asarray(gpair), jnp.asarray(w0),
        jnp.float32(0.0), steps=6, eta=0.5, lambda_=1.0, alpha=0.0)
    _, _, got = gblinear.linear_update_greedy(
        torch.from_numpy(X.T.copy()), torch.from_numpy(gpair[:, 0]),
        torch.from_numpy(gpair[:, 1]), torch.from_numpy(w0),
        torch.tensor(0.0), steps=6, eta=0.5, lambda_=1.0, alpha=0.0)
    assert got.tolist() == np.asarray(want).tolist()
    assert got[0] == 2 and len(set(got.tolist())) == 6


def test_gblinear_shotgun_cyclic_matches_coord_descent():
    X, z = _data(seed=21)
    d = xtt.DMatrix(X, label=z, device="cpu")

    def weights(params):
        return xtt.train(dict(LINEAR, **params), d, 8, verbose_eval=False,
                         device="cpu").linear_weights

    np.testing.assert_array_equal(
        weights({"updater": "coord_descent"}),
        weights({"updater": "shotgun", "feature_selector": "cyclic"}))


def test_gblinear_recovers_coefficients_and_l1_sparsity():
    """(the reference's test_gblinear_recovers_coefficients and
    test_gblinear_l1_sparsity)"""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1000, 5)).astype(np.float32)
    true_w = np.array([1.0, -2.0, 0.5, 0.0, 3.0], np.float32)
    y = X @ true_w + 0.05 * rng.normal(size=1000).astype(np.float32)
    d = xtt.DMatrix(X, label=y, device="cpu")
    bst = xtt.train({"booster": "gblinear", "eta": 0.7, "lambda": 0.01}, d,
                    40, verbose_eval=False, device="cpu")
    np.testing.assert_allclose(bst.linear_weights[:, 0], true_w, atol=0.05)
    y2 = (2 * X[:, 0]).astype(np.float32)
    sparse = xtt.train({"booster": "gblinear", "eta": 0.7, "alpha": 5.0,
                        "lambda": 0.0},
                       xtt.DMatrix(X, label=y2, device="cpu"), 40,
                       verbose_eval=False, device="cpu")
    w = sparse.linear_weights[:, 0]
    assert abs(w[0]) > 0.5 and np.abs(w[1:]).max() < 0.05


def test_gblinear_top_k_moves_k_weights_and_seeds_differ():
    X, z = _data(seed=24)
    d = xtt.DMatrix(X, label=z, device="cpu")
    for sel in ("greedy", "thrifty"):
        wk = xtt.train(dict(LINEAR, feature_selector=sel, top_k=2), d, 1,
                       verbose_eval=False, device="cpu").linear_weights
        assert np.count_nonzero(wk) == 2
    p = dict(LINEAR, updater="shotgun", seed=7)
    w1 = xtt.train(p, d, 5, verbose_eval=False, device="cpu").linear_weights
    w2 = xtt.train(p, d, 5, verbose_eval=False, device="cpu").linear_weights
    w3 = xtt.train(dict(p, seed=8), d, 5, verbose_eval=False,
                   device="cpu").linear_weights
    np.testing.assert_array_equal(w1, w2)
    assert not np.array_equal(w1, w3)


def test_gblinear_refusals():
    X, z = _data(R=300)
    d = xtt.DMatrix(X, label=z, device="cpu")
    with pytest.raises(ValueError, match="feature_selector"):
        xtt.train(dict(LINEAR, feature_selector="sideways"), d, 1,
                  verbose_eval=False, device="cpu")
    with pytest.raises(ValueError, match="updater"):
        xtt.train(dict(LINEAR, updater="warp_drive"), d, 1,
                  verbose_eval=False, device="cpu")
    bst = xtt.train(LINEAR, d, 2, verbose_eval=False, device="cpu")
    with pytest.raises(ValueError, match="pred_leaf"):
        bst.predict(d, pred_leaf=True)
    with pytest.raises(ValueError, match="Slice"):
        bst[0:1]


def test_golden_gblinear_model_margins():
    """A model written by dmlc/xgboost itself (reference
    tests/test_golden_models.py:63-68)."""
    gold = os.path.join(HERE, "data", "models")
    bst = xtt.Booster(model_file=os.path.join(gold, "gblinear.json"),
                      device="cpu")
    assert bst.booster_kind == "gblinear"
    X = np.load(os.path.join(gold, "golden_X.npy"))
    got = bst.predict(xtt.DMatrix(X, device="cpu"), output_margin=True)
    np.testing.assert_allclose(
        got.reshape(-1), np.load(os.path.join(
            gold, "gblinear_margin.npy")).reshape(-1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", ["json", "ubj"])
def test_gblinear_files_load_across_the_packages(fmt, tmp_path):
    params = dict(LINEAR, objective="multi:softprob", num_class=3)
    X, y, ref, got = _both(params, rounds=4)
    ref_path, port_path = (str(tmp_path / f"ref.{fmt}"),
                           str(tmp_path / f"port.{fmt}"))
    ref.save_model(ref_path)
    got.save_model(port_path)
    gb = got.save_raw_dict()["learner"]["gradient_booster"]
    assert gb["name"] == "gblinear"
    assert gb["model"]["param"] == {"num_feature": "6",
                                    "num_output_group": "3",
                                    "num_boosted_rounds": "4"}
    assert len(gb["model"]["weights"]) == 6 * 3 + 3
    into_port = xtt.Booster(model_file=ref_path, device="cpu")
    into_ref = xtb.Booster(model_file=port_path)
    np.testing.assert_array_equal(into_port.linear_weights,
                                  ref.linear_weights)
    np.testing.assert_array_equal(into_ref.linear_weights,
                                  got.linear_weights)
    assert into_port.num_boosted_rounds() == 4
    dp, dr = xtt.DMatrix(X, device="cpu"), xtb.DMatrix(X)
    np.testing.assert_allclose(into_port.predict(dp),
                               np.asarray(ref.predict(dr)), **TOL)
    np.testing.assert_allclose(np.asarray(into_ref.predict(dr)),
                               got.predict(dp), **TOL)
    # the port's own file reloads to identical predictions
    again = xtt.Booster(model_file=port_path, device="cpu")
    np.testing.assert_array_equal(again.predict(dp), got.predict(dp))


def test_gblinear_config_continuation_and_copy():
    params = dict(LINEAR, objective="binary:logistic", updater="shotgun",
                  feature_selector="shuffle", top_k=0, seed=5)
    X, z = _data()
    y = (z > 0).astype(np.float32)
    d = xtt.DMatrix(X, label=y, device="cpu")
    full = xtt.train(params, d, 8, verbose_eval=False, device="cpu")
    half = xtt.train(params, d, 4, verbose_eval=False, device="cpu")
    for model in (half, half.save_raw("ubj")):
        cont = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), 4,
                         xgb_model=model, verbose_eval=False, device="cpu")
        assert cont.num_boosted_rounds() == 8
        np.testing.assert_allclose(cont.linear_weights, full.linear_weights,
                                   **TOL)
    cfg = json.loads(full.save_config())
    ref = xtb.train(params, xtb.DMatrix(X, label=y), 8, verbose_eval=False)
    cfg_ref = json.loads(ref.save_config())
    assert cfg["learner"]["gradient_booster"] == \
        cfg_ref["learner"]["gradient_booster"]
    assert cfg["learner"]["learner_train_param"]["booster"] == "gblinear"
    back = xtt.Booster(device="cpu")
    back.unserialize(full.serialize())
    np.testing.assert_array_equal(back.linear_weights, full.linear_weights)
    assert back.num_boosted_rounds() == 8
    twin = full.copy()
    np.testing.assert_array_equal(twin.predict(d), full.predict(d))
    assert twin.linear_weights is not full.linear_weights


def test_gblinear_estimator_pickle_and_cv():
    import pickle

    X, z = _data(R=900)
    a = xtt.XGBRegressor(booster="gblinear", n_estimators=8, device="cpu",
                         learning_rate=0.5).fit(X, z)
    b = xtb.XGBRegressor(booster="gblinear", n_estimators=8,
                         learning_rate=0.5).fit(X, z)
    np.testing.assert_allclose(a.predict(X), np.asarray(b.predict(X)), **TOL)
    back = pickle.loads(pickle.dumps(a.get_booster()))
    np.testing.assert_array_equal(back.linear_weights,
                                  a.get_booster().linear_weights)
    res = xtt.cv(LINEAR, xtt.DMatrix(X, label=z, device="cpu"), 4, nfold=3,
                 as_pandas=False, seed=2, device="cpu")
    ref = xtb.cv(LINEAR, xtb.DMatrix(X, label=z), 4, nfold=3,
                 as_pandas=False, seed=2)
    for k in ref:
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-5, atol=1e-6)
