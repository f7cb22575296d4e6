"""Port parity for multi-output models, held against xgboost_tpu on the
same numpy input: (R, K) labels, ``num_target`` under one tree per target,
vector-leaf trees (``multi_strategy="multi_output_tree"``) for
reg:squarederror, multi-label binary:logistic and multi:softprob, their
JSON/UBJ schema, prediction and cross-loading.

Tolerances:
- the (R, K) gradients, the per-target base score and the vector-leaf
  split scan ``evaluate_splits_multi`` are the reference's bits: the scan
  sums in XLA's orders (the blocked prefix over the bins, sequential sums
  over the K targets, the mean over K as the sum times f32(1/K)), on
  histograms whose values have no near-ties;
- the 2K-channel plain histogram is held against the reference's at
  rtol/atol 1e-5 (f32 sums in another order);
- trained models grow the reference's trees (split features and shape),
  margins within 1e-5 (the f32 histograms' order moves leaf values by a
  few 1e-7 here), or the same trees up to a near tie that f32 sums in
  another order decide (the two gains within 1e-5, relative), and the
  rounds before it within 1e-5;
- the golden multi-target model (written by dmlc/xgboost) predicts its
  recorded margins within 1e-5, as tests/test_golden_models.py holds the
  reference; models cross between the packages to identical predictions;
- metrics agree with the reference's to 1e-12 (both reduce in f64).
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
from xgboost_tpu.ops.split import SplitParams as RefSplitParams
from xgboost_tpu.ops.split import evaluate_splits_multi as ref_eval_multi
from xgboost_tpu.tree.grow_multi import build_level_hist_multi as ref_hist
from xgboost_tpu_torch import metric
from xgboost_tpu_torch.convert import booster_from_dict, booster_to_dict
from xgboost_tpu_torch.objective import create_objective
from xgboost_tpu_torch.ops import hist_cuda
from xgboost_tpu_torch.ops.split import SplitParams, evaluate_splits_multi

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "data", "models")


def _multi_data(seed=0, n=1500, f=8, k=3):
    """The reference's multi-target generator (tests/test_multitarget.py:
    10-15): Y = X W + 0.1 noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    W = rng.normal(size=(f, k)).astype(np.float32)
    Y = (X @ W + 0.1 * rng.normal(size=(n, k))).astype(np.float32)
    return X, Y


def _train_both(params, X, Y, rounds, **dm):
    ref = xtb.train(params, xtb.DMatrix(X, label=Y, **dm), rounds,
                    verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=Y, device="cpu", **dm),
                    rounds, verbose_eval=False, device="cpu")
    return ref, got


def _first_difference(got, ref):
    """(tree, node) of the first split where two models' trees differ, in
    training order and creation order; None where they are the same."""
    for t, (a, b) in enumerate(zip(got.trees, ref.trees)):
        n = min(a.n_nodes, b.n_nodes)
        inner = a.left_children[:n] != -1
        d = np.nonzero((a.split_indices[:n] != b.split_indices[:n])
                       | (a.left_children[:n] != b.left_children[:n])
                       | (inner & (a.split_conditions[:n]
                                   != b.split_conditions[:n])))[0]
        if len(d) or a.n_nodes != b.n_nodes:
            return t, int(d[0]) if len(d) else n
    return None


def _same_trees(ref, got, X, atol=1e-5):
    """The reference's trees and margins within ``atol``; or, where f32
    sums in another order decide a near tie, the same trees up to a first
    difference whose two gains are within 1e-5 of each other (relative),
    and the margins of the rounds before it within ``atol``."""
    assert got.tree_info == ref.tree_info
    assert len(got.trees) == len(ref.trees)
    assert [t.n_targets for t in got.trees] == [t.n_targets for t in ref.trees]
    rounds = got.num_boosted_rounds()
    first = _first_difference(got, ref)
    if first is not None:
        t, node = first
        ga = float(got.trees[t].loss_changes[node])
        gb = float(ref.trees[t].loss_changes[node])
        assert abs(ga - gb) <= 1e-5 * abs(gb), (first, ga, gb)
        rounds = t // got.trees_per_round
    if rounds:
        np.testing.assert_allclose(
            got.predict(xtt.DMatrix(X, device="cpu"), output_margin=True,
                        iteration_range=(0, rounds)),
            ref.predict(xtb.DMatrix(X), output_margin=True,
                        iteration_range=(0, rounds)), rtol=1e-5, atol=atol)
    return first


# ------------------------------------------------------------------ labels
@pytest.mark.parametrize("k", [1, 3])
def test_labels_of_k_targets(k):
    """A label matrix keeps its (R, K) shape (it used to be flattened to
    R * K rows); a single column becomes (R,), as the reference's."""
    X, Y = _multi_data(n=50, k=k)
    got = xtt.DMatrix(X, label=Y, device="cpu").get_label()
    want = xtb.DMatrix(X, label=Y).get_label()
    assert got.shape == want.shape == ((50,) if k == 1 else (50, k))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="rows"):
        xtt.DMatrix(X, label=Y.reshape(-1), device="cpu") if k > 1 \
            else xtt.DMatrix(X, label=Y[:-1], device="cpu")


# --------------------------------------------------------------- gradients
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", ["reg:squarederror", "binary:logistic"])
def test_gradients_are_the_references_bits(objective, weighted):
    """(R, K) margins and labels -> (R, K, 2) pairs: squared error, and
    multi-label logistic through K4's gradient entry flattened (its plain
    version here), with scale_pos_weight and row weights."""
    rng = np.random.default_rng(3)
    R, K = 2000, 3
    m = (rng.normal(size=(R, K)) * 4).astype(np.float32)
    if objective == "binary:logistic":
        y = (rng.random((R, K)) < 0.4).astype(np.float32)
    else:
        y = rng.normal(size=(R, K)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, R).astype(np.float32) if weighted else None
    params = {"num_target": K, "scale_pos_weight": 1.7}
    want = np.asarray(ref_objective(objective, params).get_gradient(
        jnp.asarray(m), jnp.asarray(y), None if w is None else jnp.asarray(w)))
    got = create_objective(objective, params).get_gradient(
        torch.from_numpy(m), torch.from_numpy(y),
        None if w is None else torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (R, K, 2)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", ["reg:squarederror", "binary:logistic"])
def test_base_score_is_the_references_bits(objective, weighted):
    """The per-target base score: squared error's per-target weighted mean
    (jnp.sum's order per column), the logistic's Newton step."""
    rng = np.random.default_rng(4)
    R, K = 1999, 3
    if objective == "binary:logistic":
        y = (rng.random((R, K)) < 0.3).astype(np.float32)
    else:
        y = (rng.normal(size=(R, K)) * 3 + 1).astype(np.float32)
    w = rng.uniform(0.5, 2.0, R).astype(np.float32) if weighted else None
    params = {"num_target": K}
    want = np.asarray(ref_objective(objective, params).init_estimation(
        jnp.asarray(y), None if w is None else jnp.asarray(w)))
    got = create_objective(objective, params).init_estimation(
        torch.from_numpy(y), None if w is None else torch.from_numpy(w))
    assert got.shape == want.shape == (K,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


# -------------------------------------------------------------------- scan
def _multi_hist(N, F, B, K, seed, empty=0.1):
    """Histograms (N, F, B, K, 2) of random gradients over random bins,
    with empty bins and missing rows; totals include the missing."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(N, F, B, K)).astype(np.float32)
    h = rng.uniform(0.1, 2.0, size=(N, F, B, 1)).astype(np.float32) \
        * np.ones((1, 1, 1, K), np.float32)
    keep = rng.random((N, F, B, 1)) > empty
    hist = np.stack([g * keep, h * keep], axis=-1).astype(np.float32)
    hist[:, :, B - 3:] = 0.0  # pad bins beyond n_bins
    feat_tot = hist.sum(axis=2, dtype=np.float64).astype(np.float32)
    miss = np.stack([rng.normal(size=(N, K)),
                     rng.uniform(0.0, 3.0, size=(N, 1)) * np.ones((1, K))],
                    axis=-1).astype(np.float32)
    miss[: N // 2] = 0.0  # nodes without missing values
    totals = (feat_tot[:, 0] + miss).astype(np.float32)
    n_bins = np.full(F, B - 3, np.int32)
    n_bins[0] = B - 5
    return hist, totals, n_bins


SCAN_PARAMS = [
    dict(eta=0.3, gamma=0.0, min_child_weight=1.0, lambda_=1.0, alpha=0.0,
         max_delta_step=0.0),
    dict(eta=0.3, gamma=0.0, min_child_weight=5.0, lambda_=0.5, alpha=0.3,
         max_delta_step=0.0),
    dict(eta=0.3, gamma=0.0, min_child_weight=1.0, lambda_=1.0, alpha=0.0,
         max_delta_step=0.7),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pi", range(len(SCAN_PARAMS)))
@pytest.mark.parametrize("N,F,B,K", [(1, 6, 32, 3), (4, 5, 40, 2),
                                     (8, 7, 20, 7)])
def test_evaluate_splits_multi_is_the_references_bits(N, F, B, K, pi,
                                                      masked):
    """Every output of the summed-gain scan bitwise equal to the
    reference's: the bin prefix in XLA's blocks of 16 along the bin axis
    of the 5-d histogram, the gains summed over K sequentially, the mean
    hessian as the sum times f32(1/K); with L1, max_delta_step and a
    column mask (the reference's scan has no monotone or categorical
    mode)."""
    hist, totals, n_bins = _multi_hist(N, F, B, K, seed=N * 100 + pi)
    fm = None
    if masked:
        fm = np.random.default_rng(pi).random((N, F)) < 0.6
        fm[:, 1] = True
    want = ref_eval_multi(jnp.asarray(hist), jnp.asarray(totals),
                          jnp.asarray(n_bins), RefSplitParams(**SCAN_PARAMS[pi]),
                          None if fm is None else jnp.asarray(fm))
    got = evaluate_splits_multi(torch.from_numpy(hist),
                                torch.from_numpy(totals),
                                torch.from_numpy(n_bins),
                                SplitParams(**SCAN_PARAMS[pi]),
                                None if fm is None else torch.from_numpy(fm))
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        if a.dtype == np.float32:
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32), err_msg=name)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


@pytest.mark.parametrize("node0,n_nodes,stride", [(0, 1, 1), (1, 1, 2),
                                                  (3, 2, 2), (7, 8, 1)])
def test_level_hist_multi_plain_matches_reference(node0, n_nodes, stride):
    """The 2K-channel level histogram (N, F, B, K, 2) from one pos against
    the reference's build_level_hist_multi (XLA on the CPU)."""
    rng = np.random.default_rng(node0)
    R, F, B, K = 1500, 6, 32, 3
    bins = rng.integers(0, B + 1, size=(R, F)).astype(np.uint8)
    gpair = rng.normal(size=(R, K, 2)).astype(np.float32)
    pos = rng.integers(node0 - 1, node0 + stride * n_nodes + 1,
                       size=R).astype(np.int32)
    pos[-50:] = -1
    want = np.asarray(ref_hist(jnp.asarray(bins), jnp.asarray(gpair),
                               jnp.asarray(pos), node0=node0, n_nodes=n_nodes,
                               n_bin=B, n_targets=K, stride=stride))
    got = hist_cuda.build_level_hist_multi(
        torch.from_numpy(bins), torch.from_numpy(gpair),
        torch.from_numpy(pos), node0=node0, n_nodes=n_nodes, n_bin=B,
        stride=stride).numpy()
    assert got.shape == want.shape == (n_nodes, F, B, K, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("depth", [4, 5])
def test_vector_trees_grow_the_references(depth):
    """One vector-leaf tree a round: the reference's trees, margins within
    1e-5, and its JSON schema (size_leaf_vector, n x K base_weights,
    n_leaves x K leaf_weights)."""
    X, Y = _multi_data()
    params = {"objective": "reg:squarederror", "num_target": 3,
              "multi_strategy": "multi_output_tree", "max_depth": depth,
              "eta": 0.3, "max_bin": 64}
    ref, got = _train_both(params, X, Y, 8)
    assert len(got.trees) == 8 and got.num_boosted_rounds() == 8
    _same_trees(ref, got, X)
    np.testing.assert_allclose(got.base_score, ref.base_score, rtol=0,
                               atol=0)
    t0 = got.save_raw_dict()["learner"]["gradient_booster"]["model"][
        "trees"][0]
    n = len(t0["left_children"])
    assert t0["tree_param"]["size_leaf_vector"] == "3"
    assert len(t0["base_weights"]) == 3 * n
    assert len(t0["leaf_weights"]) == 3 * t0["left_children"].count(-1)
    lmp = got.save_raw_dict()["learner"]["learner_model_param"]
    assert lmp["num_target"] == "3" and lmp["base_score"].startswith("[")


def test_lossguide_max_leaves_matches_reference():
    """lossguide with max_leaves on vector-leaf trees stays
    level-synchronous, the budget spent by gain: the reference's trees."""
    X, Y = _multi_data()
    params = {"objective": "reg:squarederror", "num_target": 3,
              "multi_strategy": "multi_output_tree", "max_depth": 6,
              "grow_policy": "lossguide", "max_leaves": 8, "eta": 0.3,
              "max_bin": 64}
    ref, got = _train_both(params, X, Y, 5)
    _same_trees(ref, got, X)
    for t in got.trees:
        assert int(np.sum(t.left_children == -1)) <= 8


def test_depthwise_max_leaves_and_sampling_match_reference():
    """The budget in node order, with row and column sampling and
    feature weights: the same draws as the reference's."""
    X, Y = _multi_data(seed=2, n=1200)
    params = {"objective": "reg:squarederror", "num_target": 3,
              "multi_strategy": "multi_output_tree", "max_depth": 5,
              "max_leaves": 10, "subsample": 0.8, "colsample_bynode": 0.7,
              "colsample_bytree": 0.9, "seed": 7, "max_bin": 32}
    fw = np.linspace(0.5, 2.0, X.shape[1]).astype(np.float32)
    ref, got = _train_both(params, X, Y, 5, feature_weights=fw)
    _same_trees(ref, got, X)


def test_multi_label_logistic_vector_trees_match_reference():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(1200, 6)).astype(np.float32)
    Y = np.stack([X[:, 0] > 0, X[:, 1] + X[:, 2] > 0.3],
                 axis=1).astype(np.float32)
    params = {"objective": "binary:logistic", "num_target": 2,
              "multi_strategy": "multi_output_tree", "max_depth": 4,
              "max_bin": 32, "eval_metric": ["logloss", "error"]}
    ref, got = _train_both(params, X, Y, 6)
    _same_trees(ref, got, X)
    p = got.predict(xtt.DMatrix(X, device="cpu"))
    assert p.shape == (1200, 2) and ((p > 0) & (p < 1)).all()


def test_softprob_multi_output_tree_matches_reference():
    """multi:softprob with multi_output_tree (reference
    tests/test_multitarget.py:89-101): one tree of 3-vector leaves a
    round, probabilities that sum to 1."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(1200, 6)).astype(np.float32)
    y = ((X[:, 0] > 0).astype(int) + (X[:, 1] > 0).astype(int)).astype(
        np.float32)
    params = {"objective": "multi:softprob", "num_class": 3,
              "multi_strategy": "multi_output_tree", "max_depth": 4,
              "max_bin": 32}
    ref, got = _train_both(params, X, y, 10)
    assert len(got.trees) == 10 and got.trees[0].n_targets == 3
    _same_trees(ref, got, X)
    p = got.predict(xtt.DMatrix(X, device="cpu"))
    np.testing.assert_allclose(p.sum(1), 1.0, rtol=1e-5)
    assert np.mean(np.argmax(p, 1) == y) > 0.8


@pytest.mark.parametrize("deterministic", [False, True])
def test_num_target_one_tree_per_target_matches_reference(deterministic):
    """num_target=3 with the default strategy: 3 scalar trees a round into
    margin columns 0-2; under deterministic_histogram the model JSON is
    the reference's byte for byte."""
    X, Y = _multi_data(seed=1, n=1000)
    params = {"objective": "reg:squarederror", "num_target": 3,
              "max_depth": 4, "max_bin": 32, "eta": 0.3,
              "deterministic_histogram": int(deterministic)}
    ref, got = _train_both(params, X, Y, 4)
    assert got.tree_info == [0, 1, 2] * 4 and got.num_boosted_rounds() == 4
    _same_trees(ref, got, X)
    full = got.predict(xtt.DMatrix(X, device="cpu"), output_margin=True)
    two = got.predict(xtt.DMatrix(X, device="cpu"), output_margin=True,
                      iteration_range=(0, 2))
    assert full.shape == two.shape == (1000, 3)
    if deterministic:
        assert json.dumps(got.save_raw_dict()) == \
            json.dumps(ref.save_raw_dict())
        np.testing.assert_array_equal(
            two, ref.predict(xtb.DMatrix(X), output_margin=True,
                             iteration_range=(0, 2)))


def test_continuation_and_rounds_of_vector_trees():
    """xgb_model continuation counts rounds of one vector tree, so 3 + 3
    rounds draw the seeds of an uninterrupted 6."""
    X, Y = _multi_data(seed=4, n=800)
    params = {"objective": "reg:squarederror", "num_target": 3,
              "multi_strategy": "multi_output_tree", "max_depth": 3,
              "subsample": 0.8, "seed": 3, "max_bin": 32}
    d = xtt.DMatrix(X, label=Y, device="cpu")
    full = xtt.train(params, d, 6, verbose_eval=False, device="cpu")
    half = xtt.train(params, d, 3, verbose_eval=False, device="cpu")
    cont = xtt.train(params, d, 3, verbose_eval=False, device="cpu",
                     xgb_model=half.save_raw("ubj"))
    assert cont.num_boosted_rounds() == 6
    assert json.dumps(cont.save_raw_dict()) == json.dumps(full.save_raw_dict())
    leaves = full.predict(xtt.DMatrix(X, device="cpu"), pred_leaf=True)
    assert leaves.shape == (800, 6) and leaves.dtype == np.int32
    m = np.zeros((800, 3), np.float32)
    for t, tree in enumerate(full.trees):
        m += tree.leaf_vector[leaves[:, t]]
    np.testing.assert_array_equal(
        m + full.base_score[None],
        full.predict(xtt.DMatrix(X, device="cpu"), output_margin=True))


# ---------------------------------------------------------- model format
def test_golden_multitarget_model_margins():
    """multitarget.json, written by dmlc/xgboost (reg:squarederror,
    num_target=2, multi_output_tree), with its vector base score."""
    bst = xtt.Booster(model_file=os.path.join(GOLD, "multitarget.json"),
                      device="cpu")
    X = np.load(os.path.join(GOLD, "golden_X.npy"))
    got = bst.predict(xtt.DMatrix(X, device="cpu"), output_margin=True)
    want = np.load(os.path.join(GOLD, "multitarget_margin.npy"))
    assert got.shape == want.shape == (X.shape[0], 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ref = xtb.Booster()
    ref.load_model(os.path.join(GOLD, "multitarget.json"))
    np.testing.assert_array_equal(bst.base_score, ref.base_score)
    assert bst.num_boosted_rounds() == ref.num_boosted_rounds() == 4
    assert bst.save_raw_dict()["learner"]["learner_model_param"][
        "base_score"] == ref.save_raw_dict()["learner"][
        "learner_model_param"]["base_score"]


@pytest.mark.parametrize("strategy", ["multi_output_tree",
                                      "one_output_per_tree"])
def test_models_cross_both_ways(strategy):
    """A model the port trains loads in the reference and predicts the
    same; the reference's loads in the port and predicts the same; dumps
    equal."""
    X, Y = _multi_data(seed=6, n=700)
    params = {"objective": "reg:squarederror", "num_target": 3,
              "multi_strategy": strategy, "max_depth": 4, "max_bin": 32}
    ref_model, port = _train_both(params, X, Y, 4)
    ref = xtb.Booster()
    ref.load_model_dict(booster_to_dict(port))
    want = port.predict(xtt.DMatrix(X, device="cpu"), output_margin=True)
    np.testing.assert_array_equal(
        np.asarray(ref.predict(xtb.DMatrix(X), output_margin=True)), want)
    back = booster_from_dict(ref_model.save_raw_dict(), device="cpu")
    np.testing.assert_array_equal(
        back.predict(xtt.DMatrix(X, device="cpu"), output_margin=True),
        np.asarray(ref_model.predict(xtb.DMatrix(X), output_margin=True)))
    for fmt in ("text", "json"):
        assert port.get_dump(dump_format=fmt, with_stats=True) == \
            ref.get_dump(dump_format=fmt, with_stats=True)


@pytest.mark.parametrize("ext", ["json", "ubj"])
def test_vector_model_reloads_to_the_same_predictions(tmp_path, ext):
    X, Y = _multi_data(seed=5, n=600)
    d = xtt.DMatrix(X, label=Y, device="cpu")
    bst = xtt.train({"objective": "reg:squarederror", "num_target": 3,
                     "multi_strategy": "multi_output_tree", "max_depth": 4},
                    d, 5, verbose_eval=False, device="cpu")
    path = str(tmp_path / f"m.{ext}")
    bst.save_model(path)
    again = xtt.Booster(model_file=path, device="cpu")
    np.testing.assert_array_equal(again.predict(d), bst.predict(d))
    assert json.dumps(again.save_raw_dict()) == json.dumps(bst.save_raw_dict())
    raw = bst.save_raw("ubj")
    ref = xtb.Booster()
    ref.load_model(bytearray(raw))
    np.testing.assert_array_equal(np.asarray(ref.predict(xtb.DMatrix(X))),
                                  bst.predict(d))


@pytest.mark.parametrize("extra,match", [
    ({"deterministic_histogram": 1}, "deterministic_histogram"),
    ({"monotone_constraints": "(1,0,0,0,0,0,0,0)"}, "monotone"),
    ({"booster": "dart"}, "booster"),
])
def test_unsupported_combinations_raise(extra, match):
    X, Y = _multi_data(n=300)
    params = {"objective": "reg:squarederror", "num_target": 3,
              "multi_strategy": "multi_output_tree", "max_depth": 3, **extra}
    with pytest.raises(NotImplementedError):
        xtb.train(params, xtb.DMatrix(X, label=Y), 2, verbose_eval=False)
    with pytest.raises(NotImplementedError, match=match):
        xtt.train(params, xtt.DMatrix(X, label=Y, device="cpu"), 2,
                  verbose_eval=False, device="cpu")


def test_categorical_vector_trees_raise():
    X, Y = _multi_data(n=300)
    X[:, 0] = np.random.default_rng(0).integers(0, 5, 300)
    params = {"objective": "reg:squarederror", "num_target": 3,
              "multi_strategy": "multi_output_tree", "max_depth": 3}
    ft = ["c"] + ["q"] * 7
    with pytest.raises(NotImplementedError):
        xtb.train(params, xtb.DMatrix(X, label=Y, feature_types=ft,
                                      enable_categorical=True), 2,
                  verbose_eval=False)
    with pytest.raises(NotImplementedError, match="categorical"):
        xtt.train(params, xtt.DMatrix(X, label=Y, feature_types=ft,
                                      enable_categorical=True, device="cpu"),
                  2, verbose_eval=False, device="cpu")


def test_unknown_multi_strategy_raises():
    X, Y = _multi_data(n=100)
    with pytest.raises(ValueError, match="multi_strategy"):
        xtt.train({"num_target": 3, "multi_strategy": "bogus"},
                  xtt.DMatrix(X, label=Y, device="cpu"), 1,
                  verbose_eval=False, device="cpu")


# ------------------------------------------------------------------ metrics
@pytest.mark.parametrize("name", ["rmse", "logloss", "error"])
@pytest.mark.parametrize("weighted", [False, True])
def test_multi_target_metrics_match_reference(name, weighted):
    """The mean over rows x targets (reference metric/__init__.py:121)."""
    rng = np.random.default_rng(9)
    R, K = 1000, 3
    p = rng.uniform(0.01, 0.99, (R, K)).astype(np.float32)
    y = (rng.random((R, K)) < 0.5).astype(np.float32)
    w = rng.uniform(0.5, 2, R).astype(np.float32) if weighted else None
    want = ref_metric.create_metric(name)[0](p, y, w)
    got = metric.create_metric(name)[0](p, y, w)
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want))


def test_eval_log_matches_reference():
    X, Y = _multi_data(seed=8, n=800)
    params = {"objective": "reg:squarederror", "num_target": 3,
              "multi_strategy": "multi_output_tree", "max_depth": 3,
              "max_bin": 32}
    res_ref, res_got = {}, {}
    xtb.train(params, xtb.DMatrix(X, label=Y), 4,
              evals=[(xtb.DMatrix(X, label=Y), "t")], evals_result=res_ref,
              verbose_eval=False)
    d = xtt.DMatrix(X, label=Y, device="cpu")
    xtt.train(params, d, 4, evals=[(d, "t")], evals_result=res_got,
              verbose_eval=False, device="cpu")
    np.testing.assert_allclose(res_got["t"]["rmse"], res_ref["t"]["rmse"],
                               rtol=1e-6)
