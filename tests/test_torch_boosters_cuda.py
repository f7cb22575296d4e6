"""Card legs of the other boosters and updaters: DART, tree_method approx
and exact, process_type="update" and gblinear, trained on the GPU and on
the CPU from the same numpy input.  They need an NVIDIA GPU and skip
without one; run them on the card with
``python -m pytest -q -p no:cacheprovider tests/test_torch_boosters_cuda.py``.

This file imports PyTorch and the port only (the card's machine has no
JAX): the CPU run is the reference here, itself held against xgboost_tpu
by the CPU tests.  Tolerances: the deterministic DART and approx models,
and every exact and update model, are byte-identical card to CPU; the
gblinear weights agree within 1e-5 relative, 1e-6 absolute."""
import json

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xtt

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernels run only on a GPU")


def _data(R=3000, F=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    z = (np.nan_to_num(X[:, 0]) + 0.8 * np.nan_to_num(X[:, 1])
         * (X[:, 2] > 0) - 0.5 * np.nan_to_num(X[:, 3]) ** 2
         + 0.3 * rng.normal(size=R)).astype(np.float32)
    return X, (z > 0).astype(np.float32)


def _json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _on(device, params, rounds=6, model=None):
    X, y = _data()
    return xtt.train(params, xtt.DMatrix(X, label=y, device=device), rounds,
                     xgb_model=model, verbose_eval=False, device=device)


BASE = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 64,
        "eta": 0.3, "seed": 2}
CASES = {
    "dart_uniform_tree": {"booster": "dart", "rate_drop": 0.3,
                          "deterministic_histogram": 1},
    "dart_weighted_forest": {"booster": "dart", "rate_drop": 0.3,
                             "sample_type": "weighted",
                             "normalize_type": "forest", "one_drop": 1,
                             "skip_drop": 0.2,
                             "deterministic_histogram": 1},
    "approx": {"tree_method": "approx", "deterministic_histogram": 1},
    "approx_dart": {"tree_method": "approx", "booster": "dart",
                    "rate_drop": 0.3, "deterministic_histogram": 1},
    "exact": {"tree_method": "exact", "gamma": 0.5, "subsample": 0.8},
    "exact_dart": {"tree_method": "exact", "booster": "dart",
                   "rate_drop": 0.3},
}


@needs_cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_card_model_is_the_cpus(name):
    params = dict(BASE, **CASES[name])
    assert _json(_on("cuda", params)) == _json(_on("cpu", params))


@needs_cuda
@pytest.mark.parametrize("updater", ["refresh,prune", "refresh", "prune"])
def test_card_update_is_the_cpus(updater):
    base = _on("cpu", dict(BASE, deterministic_histogram=1), rounds=4)
    raw = bytes(base.save_raw("json"))
    params = dict(BASE, process_type="update", updater=updater, gamma=1.0,
                  refresh_leaf=0 if updater == "refresh" else 1)
    got = {dev: _json(_on(dev, params, rounds=4, model=bytearray(raw)))
           for dev in ("cuda", "cpu")}
    assert got["cuda"] == got["cpu"]


@needs_cuda
@pytest.mark.parametrize("selector", ["cyclic", "shuffle", "greedy",
                                      "thrifty"])
def test_card_gblinear_is_the_cpus(selector):
    params = {"booster": "gblinear", "objective": "binary:logistic",
              "feature_selector": selector, "top_k": 4, "eta": 0.5,
              "updater": "shotgun" if selector == "shuffle"
              else "coord_descent"}
    card, cpu = _on("cuda", params, rounds=10), _on("cpu", params, rounds=10)
    np.testing.assert_allclose(card.linear_weights, cpu.linear_weights,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(card.linear_bias, cpu.linear_bias,
                               rtol=1e-5, atol=1e-6)


@needs_cuda
def test_card_f32_dart_and_approx_grow_the_cpus_splits_at_depth_3():
    for extra in ({"booster": "dart", "rate_drop": 0.3},
                  {"tree_method": "approx"}):
        params = dict(BASE, max_depth=3, **extra)
        a, b = _on("cuda", params), _on("cpu", params)
        for ta, tb in zip(a.trees, b.trees):
            np.testing.assert_array_equal(ta.split_indices, tb.split_indices)
        assert a.tree_weights == b.tree_weights
