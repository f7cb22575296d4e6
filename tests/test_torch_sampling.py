"""Row and column sampling of the port against the reference's booster on
the same inputs: uniform ``subsample`` masks bitwise (the same threefry
draws over the padded rows); ``gradient_based`` masks bitwise (the
probabilities divide by an f32 sum in jnp.sum's order and take a correctly
rounded square root, utils/fp.py), and held as before too: bitwise except
where the uniform draw and the keep-probability are within a few ulps,
kept rows' weights within rtol 1e-5; column masks with ``feature_weights``
bitwise (numpy draws on the host in both); the reference's ValueErrors;
and whole trainings with each sampler growing the reference's trees
(uniform and gradient_based under deterministic_histogram=1 byte for
byte, the others with predictions within 1e-4)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt


def _boosters(params):
    ref = xtb.Booster(params)
    ref._configure()
    got = xtt.Booster(params, device="cpu")
    got._configure()
    return ref, got


def _gpair(R, seed):
    rng = np.random.default_rng(seed)
    g = np.zeros((R, 1, 2), np.float32)
    g[:, 0, 0] = rng.normal(size=R)
    g[:, 0, 1] = rng.random(R) + 0.05
    g[-R // 7:] = 0.0  # padded rows carry zeros
    return g


@pytest.mark.parametrize("seed", [0, 3, 1234])
@pytest.mark.parametrize("subsample", [0.3, 0.8])
@pytest.mark.parametrize("iteration", [0, 1, 17])
def test_uniform_subsample_masks_match_reference(seed, subsample, iteration):
    ref, got = _boosters({"subsample": subsample, "seed": seed})
    g = _gpair(2048, seed)
    a = np.asarray(ref._subsample_mask(jnp.asarray(g), iteration * 131))
    b = got._subsample_mask(torch.from_numpy(g), iteration * 131).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("subsample", [0.2, 0.6])
def test_gradient_based_masks_match_reference(seed, subsample):
    ref, got = _boosters({"subsample": subsample, "seed": seed,
                          "sampling_method": "gradient_based",
                          "lambda": 1.5})
    g = _gpair(3072, seed + 1)
    a = np.asarray(ref._subsample_mask(jnp.asarray(g), 131))[:, 0, :]
    b = got._subsample_mask(torch.from_numpy(g), 131).numpy()[:, 0, :]
    keep_a, keep_b = a[:, 1] != 0, b[:, 1] != 0
    # a row may flip only where its draw is within a few ulps of p
    from xgboost_tpu_torch.utils.random import prng_key, uniform

    u = uniform(prng_key((seed * 7919 + 131) % 2**31), len(g)).numpy()
    norm = np.sqrt(g[:, 0, 0].astype(np.float64) ** 2
                   + 1.5 * g[:, 0, 1].astype(np.float64) ** 2)
    p = norm * subsample * (norm > 0).sum() / norm.sum()
    flips = keep_a != keep_b
    assert np.all(np.abs(u[flips] - p[flips]) <= 1e-6 * np.maximum(p[flips],
                                                                   1e-6))
    both = keep_a & keep_b
    np.testing.assert_allclose(b[both], a[both], rtol=1e-5)
    assert keep_a.sum() > 0


@pytest.mark.parametrize("seed", [0, 5, 7])
@pytest.mark.parametrize("subsample", [0.2, 0.6])
def test_gradient_based_masks_are_the_references_bitwise(seed, subsample):
    ref, got = _boosters({"subsample": subsample, "seed": seed,
                          "sampling_method": "gradient_based",
                          "lambda": 1.5})
    g = _gpair(3072, seed + 1)
    a = np.asarray(ref._subsample_mask(jnp.asarray(g), 131))
    b = got._subsample_mask(torch.from_numpy(g), 131).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_gradient_based_deterministic_json_is_the_references(objective):
    X, y = _data()
    fw = np.array([1.0, 3.0, 0.5, 0.0, 2.0, 1.0], np.float32)
    params = {"objective": objective, "max_depth": 4, "max_bin": 32,
              "eta": 0.3, "seed": 9, "subsample": 0.5,
              "sampling_method": "gradient_based",
              "deterministic_histogram": 1}
    ref = xtb.train(params, xtb.DMatrix(X, label=y, feature_weights=fw), 4,
                    verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=y, feature_weights=fw,
                                        device="cpu"), 4,
                    verbose_eval=False, device="cpu")
    assert json.dumps(got.save_raw_dict()) == json.dumps(ref.save_raw_dict())


FW = np.array([4.0, 0.0, 1.0, 0.5, 2.0, 1.0, 0.25, 3.0], np.float32)


@pytest.mark.parametrize("sampler", [
    {"colsample_bytree": 0.5}, {"colsample_bylevel": 0.6},
    {"colsample_bynode": 0.4},
    {"colsample_bytree": 0.8, "colsample_bylevel": 0.8,
     "colsample_bynode": 0.7}])
@pytest.mark.parametrize("weights", [None, FW])
def test_weighted_column_masks_match_reference(sampler, weights):
    ref, got = _boosters(dict(sampler, seed=11))
    for it in (0, 2):
        fa = ref._feature_masks(it * 131, 0, len(FW), weights)
        fb = got._feature_masks(it * 131, 0, len(FW), weights)
        for depth, n in ((0, 1), (1, 2), (2, 4), (0, 2), (0, 2)):
            a = np.asarray(fa(depth, n))
            b = fb(depth, n).numpy()
            np.testing.assert_array_equal(np.broadcast_to(a, b.shape), b)
            if weights is not None:
                assert not b[:, 1].any()  # weight 0: never drawn


@pytest.mark.parametrize("weights,params", [
    (FW[:5], {}), (-FW, {"colsample_bytree": 0.5}),
    (np.zeros(8, np.float32), {}),
    (np.ones(9, np.float32), {"colsample_bynode": 0.5}),
])
def test_feature_weight_errors_match_reference(weights, params):
    ref, got = _boosters(dict(params, seed=2))
    draws = []
    for call in (lambda: ref._feature_masks(0, 0, 8, weights),
                 lambda: got._feature_masks(0, 0, 8, weights)):
        with pytest.raises(ValueError) as err:
            fn = call()
            for d in range(3):  # a level draw may be the one that fails
                fn(d, 1 << d)
        draws.append(str(err.value))
    assert draws[0] == draws[1]


def _data(R=1500, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.8 * np.nan_to_num(X[:, 1])
         * (X[:, 2] > 0) > 0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("params", [
    {"subsample": 0.7, "deterministic_histogram": 1},
    {"subsample": 0.7},
    {"subsample": 0.5, "sampling_method": "gradient_based"},
    {"colsample_bynode": 0.5, "colsample_bytree": 0.9},
])
def test_sampled_training_matches_reference(params):
    X, y = _data()
    fw = np.array([1.0, 3.0, 0.5, 0.0, 2.0, 1.0], np.float32)
    params = dict(params, objective="binary:logistic", max_depth=4,
                  max_bin=32, eta=0.3, seed=9)
    ref = xtb.train(params, xtb.DMatrix(X, label=y, feature_weights=fw), 4,
                    verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=y, feature_weights=fw,
                                        device="cpu"), 4,
                    verbose_eval=False, device="cpu")
    if params.get("deterministic_histogram"):
        assert json.dumps(got.save_raw_dict()) == json.dumps(
            ref.save_raw_dict())
        return
    for a, b in zip(got.trees, ref.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
        np.testing.assert_array_equal(a.left_children, b.left_children)
    np.testing.assert_allclose(got.predict(xtt.DMatrix(X, device="cpu")),
                               ref.predict(xtb.DMatrix(X)), atol=1e-4)


def test_sampling_parameters_are_validated():
    X, y = _data(R=64)
    d = xtt.DMatrix(X, label=y, device="cpu")
    for bad, match in (({"subsample": 0.0}, "subsample"),
                       ({"subsample": 0.5, "sampling_method": "poisson"},
                        "sampling_method")):
        with pytest.raises(ValueError, match=match):
            xtt.train(bad, d, 1, verbose_eval=False, device="cpu")
