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
    with pytest.raises(NotImplementedError, match="multi:softprob"):
        create_objective("multi:softprob", {})
