"""Port parity: gradients, links and base-score estimation of the port's
objectives against xgboost_tpu on the same numpy input (rtol 1e-6)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xgboost_tpu.objective import create_objective as ref_create
from xgboost_tpu_torch.objective import create_objective


def _inputs(R=1000, seed=0):
    rng = np.random.default_rng(seed)
    margin = (rng.normal(size=(R, 1)) * 3).astype(np.float32)
    y = (rng.random(R) < 0.4).astype(np.float32)
    w = rng.random(R).astype(np.float32) + 0.5
    return margin, y, w


@pytest.mark.parametrize("name", ["reg:squarederror", "binary:logistic"])
@pytest.mark.parametrize("weighted", [False, True])
def test_gradient_matches_reference(name, weighted):
    margin, y, w = _inputs()
    params = {"scale_pos_weight": 2.0} if name == "binary:logistic" else {}
    ref = np.asarray(ref_create(name, params).get_gradient(
        jnp.asarray(margin), jnp.asarray(y),
        jnp.asarray(w) if weighted else None))
    got = create_objective(name, params).get_gradient(
        torch.from_numpy(margin), torch.from_numpy(y),
        torch.from_numpy(w) if weighted else None).numpy()
    assert got.shape == ref.shape == (1000, 1, 2)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["reg:squarederror", "binary:logistic"])
def test_init_estimation_and_links(name):
    margin, y, w = _inputs(seed=1)
    ref_obj, obj = ref_create(name, {}), create_objective(name, {})
    for wt in (None, w):
        ref = np.asarray(ref_obj.init_estimation(
            jnp.asarray(y), None if wt is None else jnp.asarray(wt)))
        got = obj.init_estimation(
            torch.from_numpy(y),
            None if wt is None else torch.from_numpy(wt)).numpy()
        np.testing.assert_allclose(np.ravel(got), np.ravel(ref), rtol=1e-6)
    m = margin[:, 0]
    np.testing.assert_allclose(
        obj.pred_transform(torch.from_numpy(m)).numpy(),
        np.asarray(ref_obj.pred_transform(jnp.asarray(m))), rtol=1e-6)
    p = np.linspace(0.05, 0.95, 7).astype(np.float32)
    np.testing.assert_allclose(
        obj.prob_to_margin(torch.from_numpy(p)).numpy(),
        np.asarray(ref_obj.prob_to_margin(jnp.asarray(p))), rtol=1e-6)


def test_unknown_objective_is_not_implemented():
    with pytest.raises(NotImplementedError, match="rank:lambdamart"):
        create_objective("rank:lambdamart", {})


def _logistic_inputs(R=100_000, seed=3):
    """Margins across the f32 range and at its edges (the exponential's
    clamps, overflow, infinities, NaN, subnormals), labels 0 and 1 with a
    few others (between, above, subnormal), weights with products that
    fall below the smallest normal f32."""
    rng = np.random.default_rng(seed)
    m = (rng.normal(size=R) * 4).astype(np.float32)
    m[: R // 4] = rng.uniform(-120, 120, R // 4)
    edges = np.float32([0.0, -0.0, 1e-30, -1e-30, 1e-45, 88.37, -88.37,
                        88.8, -88.8, 89.0, -89.0, 104.0, -104.0, 105.0,
                        -105.0, 3.4e38, -3.4e38, np.inf, -np.inf, np.nan])
    m[:edges.size] = edges
    y = (rng.random(R) < 0.4).astype(np.float32)
    y[:4] = [0.5, 2.0, 1e-40, -1e-40]
    w = (rng.random(R) + 0.01).astype(np.float32)
    w[:3] = [1e-39, 3e38, 0.0]
    return m, y, w


@pytest.mark.parametrize("spw", [1.0, 2.0, 0.37])
@pytest.mark.parametrize("weighted", [False, True])
def test_logistic_gradient_plain_is_the_references_bits(weighted, spw):
    """K4's plain gradient entry against the reference's binary:logistic
    get_gradient, bitwise (NaN where it has NaN), with and without weights
    and scale_pos_weight, with margins at the f32 range's edges."""
    from xgboost_tpu_torch.ops.sigmoid_cuda import logistic_gradient_plain

    m, y, w = _logistic_inputs()
    ref = np.asarray(ref_create("binary:logistic",
                                {"scale_pos_weight": spw}).get_gradient(
        jnp.asarray(m[:, None]), jnp.asarray(y),
        jnp.asarray(w) if weighted else None))
    got = logistic_gradient_plain(torch.from_numpy(m), torch.from_numpy(y),
                                  torch.from_numpy(w) if weighted else None,
                                  spw).numpy()
    assert got.shape == ref.shape == (m.size, 1, 2)
    assert got.dtype == np.float32
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  ref[~nan].view(np.uint32))


def test_logistic_dispatch_takes_plain_version_on_cpu():
    """binary:logistic's get_gradient on CPU tensors is the plain version
    and launches no kernel; K4's gradient entry refuses CPU tensors."""
    from xgboost_tpu_torch.ops import hist_cuda
    from xgboost_tpu_torch.ops.sigmoid_cuda import (logistic_gradient_cuda,
                                                    logistic_gradient_plain)

    m, y, w = (torch.from_numpy(a) for a in _logistic_inputs(R=1000))
    obj = create_objective("binary:logistic", {"scale_pos_weight": 2.0})
    before = dict(hist_cuda.launches)
    got = obj.get_gradient(m[:, None], y, w)
    assert hist_cuda.launches == before
    want = logistic_gradient_plain(m, y, w, 2.0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        logistic_gradient_cuda(m, y, w, 2.0)
