"""Port parity for the depthwise level step's full feature set: training
with deterministic_histogram=1 (exact limb histograms), monotone and
interaction constraints, column sampling and the max_leaves budget, held
against xgboost_tpu.train on the same numpy input.

Tolerances:
- deterministic_histogram: the model JSON is byte-identical to the
  reference's.  Every stage of a round is bitwise (the stage test names
  the first that is not): base margin, gradients (XLA's sigmoid,
  utils/fp.py), rho, limbs, limb histograms, the dequantised histogram,
  the split scan (the reference's summation order, ops/split.py) and the
  leaf values.  reg:squarederror's base margin without an explicit
  base_score, the mean of the labels, is an f32 sum in XLA's order
  (utils/fp.py ``sum_f32``); most tests pass base_score all the same, and
  one holds the model without it byte-identical too.
- f32 histogram: split features and children are equal and predictions
  agree within atol 1e-4, as tests/test_torch_train.py holds the default
  path.  Thresholds and leaf values are not compared there: f32 sums in
  another order, amplified by the subtractions of the sibling trick and the
  missing-value statistics, move node sums by up to ~1e-5 relative, enough
  to pick the other bin of a near tie of the same feature."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt


def _data(R=1500, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    z = (np.nan_to_num(X[:, 0]) + 0.8 * np.nan_to_num(X[:, 1])
         * (X[:, 2] > 0) - 0.5 * np.nan_to_num(X[:, 3]) ** 2)
    return X, z


def _model_json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _train_both(params, objective="binary:logistic", rounds=5, seed=0):
    X, z = _data(seed=seed)
    y = (z > 0).astype(np.float32) if objective == "binary:logistic" else z
    params = dict(params, objective=objective)
    ref = xtb.train(params, xtb.DMatrix(X, label=y), rounds,
                    verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), rounds,
                    verbose_eval=False, device="cpu")
    return X, y, ref, got


def _assert_same_trees(ref, got, X, *, deterministic):
    assert len(got.trees) == len(ref.trees)
    if deterministic:
        assert _model_json(got) == _model_json(ref)
        return
    for a, b in zip(got.trees, ref.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
        np.testing.assert_array_equal(a.left_children, b.left_children)
    np.testing.assert_allclose(got.predict(xtt.DMatrix(X, device="cpu")),
                               ref.predict(xtb.DMatrix(X)), atol=1e-4)


@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_deterministic_training_matches_reference(objective):
    params = {"max_depth": 4, "max_bin": 32, "eta": 0.3,
              "deterministic_histogram": 1}
    if objective == "reg:squarederror":
        params["base_score"] = 0.25  # the label mean without it: the test below
    X, y, ref, got = _train_both(params, objective)
    _assert_same_trees(ref, got, X, deterministic=True)
    again = xtt.train(dict(params, objective=objective),
                      xtt.DMatrix(X, label=y, device="cpu"), 5,
                      verbose_eval=False, device="cpu")
    assert _model_json(again) == _model_json(got)


@pytest.mark.parametrize("mono", [None, "(1,0,0,-1,0,0)"])
@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_deterministic_json_is_the_references(objective, mono):
    """Depth 4, max_bin 32, 3 rounds, unconstrained and monotone."""
    params = {"max_depth": 4, "max_bin": 32, "eta": 0.3,
              "deterministic_histogram": 1}
    if objective == "reg:squarederror":
        params["base_score"] = 0.25
    if mono:
        params["monotone_constraints"] = mono
    _, _, ref, got = _train_both(params, objective, rounds=3)
    assert _model_json(got) == _model_json(ref)


def _round0_stages(params, X, y):
    """Round 0 of both packages on one input, stage by stage: [(stage,
    reference value, port value)] as numpy arrays."""
    from xgboost_tpu.ops import quantise as rq
    from xgboost_tpu.ops.split import evaluate_splits as ref_evaluate
    from xgboost_tpu.tree.grow import HistTreeGrower as RefGrower
    from xgboost_tpu_torch.ops import quantise as tq
    from xgboost_tpu_torch.ops.split import evaluate_splits
    from xgboost_tpu_torch.tree.grow import HistTreeGrower

    d = xtb.DMatrix(X, label=y)
    ref = xtb.Booster(params, cache=[d])
    rc = ref._get_cache(d)
    rc.ensure_train()
    ref._sync_margin(rc)
    dt = xtt.DMatrix(X, label=y, device="cpu")
    got = xtt.Booster(params, cache=[dt], device="cpu")
    tc = got._get_cache(dt)
    tc.ensure_train(int(params["max_bin"]))
    got._sync_margin(tc)
    out = [("base margin", ref.base_score, got.base_score)]
    rg = (ref.objective.get_gradient(rc.margin, rc.labels, rc.weights, 0)
          * rc.valid[:, None, None])[:, 0, :]
    tg = (got.objective.get_gradient(tc.margin, tc.labels, tc.weights)
          * tc.valid[:, None, None])[:, 0, :]
    out.append(("gpair", rg, tg))
    ell = rc.ellpack
    B = ell.cuts_pad.shape[1]
    rrho, trho = rq.local_rho(rg, rc.valid), tq.local_rho(tg, tc.valid)
    out.append(("rho", rrho, trho))
    rgq, tgq = rq.quantise_gpair(rg, rrho), tq.quantise_gpair(tg, trho)
    out.append(("limbs", rgq, tgq))
    rpos = jnp.where(rc.valid, 0, -1).astype(jnp.int32)
    tpos = torch.where(tc.valid, 0, -1).to(torch.int32)
    rh = rq.hist_accumulate_q(ell.bins, rgq, rpos, 0, 1, B)
    th = tq.hist_accumulate_q(tc.bins, tgq, tpos, 0, 1, B)
    out.append(("limb histogram", rh, th))
    rhd, thd = rq.dequantise(rh, rrho), tq.dequantise(th, trho)
    out.append(("dequantised histogram", rhd, thd))
    rtot = rq.dequantise(rq.node_sums_q(rgq, rpos, 0, jnp.arange(1)), rrho)
    ttot = tq.dequantise(tq.node_sums_q(tgq, tpos, 0, 1), trho)
    out.append(("root totals", rtot, ttot))
    rs = ref_evaluate(rhd, rtot, ell.n_bins, ref._split_params)
    ts = evaluate_splits(thd, ttot, tc.n_bins, got._split_params)
    for field in ("gain", "feature", "bin", "default_left", "left_sum"):
        out.append((f"split {field}", getattr(rs, field),
                    getattr(ts, field)))
    md = int(params["max_depth"])
    rstate = RefGrower(md, ref._split_params, quantised=True).grow(
        ell.bins, rg, rc.valid, ell.cuts_pad, ell.n_bins)
    tstate = HistTreeGrower(md, got._split_params, quantised=True).grow(
        tc.bins, tg.contiguous(), tc.valid, tc.cuts_pad, tc.n_bins)
    for field in ("totals", "feat", "sbin", "gain", "leaf_val"):
        out.append((f"tree {field}", getattr(rstate, field),
                    getattr(tstate, field)))
    return [(name, np.asarray(a), np.asarray(b)) for name, a, b in out]


def _first_difference(stages):
    for name, a, b in stages:
        if a.dtype == np.float32 and b.dtype == np.float32:
            same = np.array_equal(a.view(np.uint32), b.view(np.uint32))
        else:
            same = np.array_equal(a.astype(np.int64), b.astype(np.int64))
        if not same:
            return name
    return None


@pytest.mark.parametrize("mono", [None, "(1,0,0,-1,0,0)"])
@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_round0_stages_are_bitwise(objective, mono):
    params = {"objective": objective, "max_depth": 4, "max_bin": 32,
              "eta": 0.3, "deterministic_histogram": 1}
    if objective == "reg:squarederror":
        params["base_score"] = 0.25
    if mono:
        params["monotone_constraints"] = mono
    X, z = _data()
    y = (z > 0).astype(np.float32) if objective == "binary:logistic" else z
    assert _first_difference(_round0_stages(params, X, y)) is None


def test_squarederror_base_margin_is_the_stage_that_differs():
    """Without base_score the base margin is the label mean, an f32 sum
    that once differed from the reference's by an ulp or so.  The port now
    sums in XLA's order (utils/fp.py ``sum_f32``), so no stage differs and
    the model JSON is the reference's byte for byte."""
    params = {"objective": "reg:squarederror", "max_depth": 4,
              "max_bin": 32, "eta": 0.3, "deterministic_histogram": 1}
    X, z = _data()
    assert _first_difference(_round0_stages(params, X, z)) is None
    _, _, ref, got = _train_both(params, "reg:squarederror")
    assert _model_json(got) == _model_json(ref)


CONSTRAINTS = {
    "monotone": {"monotone_constraints": "(1,0,0,-1,0,0)"},
    "interaction": {"interaction_constraints": [[0, 1, 2], [3, 4]]},
    "colsample_bytree": {"colsample_bytree": 0.5},
    "colsample_bylevel": {"colsample_bylevel": 0.6},
    "colsample_bynode": {"colsample_bynode": 0.7},
    "max_leaves": {"max_leaves": 6},
}
ALL = {k: v for d in CONSTRAINTS.values() for k, v in d.items()}
ALL.update(colsample_bytree=0.84, colsample_bylevel=0.8, colsample_bynode=0.8,
           max_leaves=9, seed=3)


@pytest.mark.parametrize("name", list(CONSTRAINTS) + ["all"])
def test_constraint_matches_reference(name):
    params = dict(CONSTRAINTS.get(name, ALL), max_depth=4, max_bin=32,
                  eta=0.3)
    X, _, ref, got = _train_both(params, seed=1)
    _assert_same_trees(ref, got, X, deterministic=False)
    n_leaves = [int((t.left_children == -1).sum()) for t in got.trees]
    if "max_leaves" in params:
        assert max(n_leaves) <= params["max_leaves"]


def test_all_constraints_deterministic_matches_reference():
    params = dict(ALL, max_depth=4, max_bin=32, eta=0.3,
                  deterministic_histogram=1)
    X, _, ref, got = _train_both(params, seed=2)
    _assert_same_trees(ref, got, X, deterministic=True)


def test_monotone_predictions_do_not_decrease():
    params = {"max_depth": 4, "max_bin": 32, "eta": 0.3,
              "monotone_constraints": "(1,0,0,-1,0,0)"}
    X, _, _, got = _train_both(params, seed=4)
    grid = np.linspace(-3, 3, 25, dtype=np.float32)
    rows = np.repeat(np.nan_to_num(X[:40]), len(grid), axis=0)
    for f, sign in ((0, 1), (3, -1)):
        r = rows.copy()
        r[:, f] = np.tile(grid, 40)
        p = got.predict(xtt.DMatrix(r, device="cpu")).reshape(40, -1)
        assert (sign * np.diff(p, axis=1) >= -1e-7).all()


def test_constraint_parameters_are_validated():
    X, z = _data(R=64)
    d = xtt.DMatrix(X, label=z, device="cpu")
    with pytest.raises(ValueError, match="monotone_constraints"):
        xtt.train({"monotone_constraints": "(1,0)"}, d, 1,
                  verbose_eval=False, device="cpu")
    with pytest.raises(ValueError, match="colsample_bytree"):
        xtt.train({"colsample_bytree": 0.0}, d, 1, verbose_eval=False,
                  device="cpu")
