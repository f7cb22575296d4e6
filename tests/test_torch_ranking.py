"""The port's learning to rank against xgboost_tpu on the same numpy
inputs: query groups in DMatrix; glibc's expf/exp2f/log2f (utils/libm.py)
bitwise against the C library on a sample with the special values; the
top-k LambdaMART gradients bitwise against the reference's native kernel
(its gate on, so that no other path is compared), at one group of many
docs, groups of one and two docs, tied, equal and signed-zero scores,
a group at K5's shared-memory cap, k above the group size and each
normalisation off; the mean pair method bitwise
against the reference's XLA version over three rounds; ndcg, map and pre
(@k, the '-' suffix, group and row weights) and aucpr with groups within
1e-6 of the reference on both of its paths; deterministic models of the
three objectives byte-identical to the reference's, with and without
weights; the golden rank:ndcg model's margins within 1e-5; models
converting both ways."""
import ctypes
import ctypes.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu import metric as ref_metric
from xgboost_tpu.objective import ranking as ref_rank
from xgboost_tpu_torch import metric
from xgboost_tpu_torch.convert import _plain, booster_to_dict
from xgboost_tpu_torch.objective import create_objective
from xgboost_tpu_torch.objective.ranking import lambda_gradients_mean
from xgboost_tpu_torch.ops import hist_cuda
from xgboost_tpu_torch.ops.lambdarank_cuda import (CAP, GroupLayout,
                                                   lambdarank_topk,
                                                   make_group_layout)
from xgboost_tpu_torch.utils import libm

GOLD = os.path.join(os.path.dirname(__file__), "data", "models")


def _bits_equal(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape
    same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a)
                                                     & np.isnan(b))
    assert same.all(), (np.nonzero(~same.ravel())[0][:5],
                        a.ravel()[~same.ravel()][:5],
                        b.ravel()[~same.ravel()][:5])


# ----------------------------------------------------------------- DMatrix
@pytest.mark.parametrize("how", ["group", "qid", "set_group", "set_qid"])
def test_query_groups_match_the_reference(how):
    X = np.zeros((10, 2), np.float32)
    sizes = [3, 1, 6]
    qid = np.repeat([7, 2, 9], sizes)
    ours = xtt.DMatrix(X, device="cpu", **(
        {"group": sizes} if how == "group" else
        {"qid": qid} if how == "qid" else {}))
    ref = xtb.DMatrix(X, **({"group": sizes} if how == "group" else
                            {"qid": qid} if how == "qid" else {}))
    if how == "set_group":
        ours.set_group(sizes)
        ref.set_group(sizes)
    if how == "set_qid":
        ours.set_qid(qid)
        ref.set_qid(qid)
    np.testing.assert_array_equal(ours.group_ptr, ref.info.group_ptr)
    assert ours.group_ptr.dtype == np.int64
    assert ours.group_version == getattr(ref, "group_version", 0) == 1


def test_group_sizes_must_sum_to_the_rows():
    X = np.zeros((10, 2), np.float32)
    with pytest.raises(ValueError, match="sum to num_row"):
        xtt.DMatrix(X, group=[3, 3], device="cpu")
    with pytest.raises(ValueError, match="sum to num_row"):
        xtb.DMatrix(X, group=[3, 3])


def test_group_weights_are_taken_after_the_groups():
    X = np.zeros((10, 2), np.float32)
    d = xtt.DMatrix(X, group=[3, 7], device="cpu")
    d.set_weight([1.0, 2.0])
    np.testing.assert_array_equal(d.get_weight(), [1.0, 2.0])
    with pytest.raises(ValueError):
        d.set_weight([1.0, 2.0, 3.0])


# -------------------------------------------------------------------- libm
def _glibc():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    fns = {}
    for name in ("expf", "exp2f", "log2f"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_float]
        fn.restype = ctypes.c_float
        fns[name] = fn
    return fns


def _libm_sample():
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2**32, 60_000, dtype=np.uint64).astype(np.uint32)
    edge_bits = np.array([0x00000000, 0x80000000, 0x00000001, 0x80000001,
                          0x007FFFFF, 0x807FFFFF, 0x00800000, 0x7F800000,
                          0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
                          0x3F800000, 0x3F7FFFFF, 0x3F800001, 0xBF800000,
                          0x7F7FFFFF, 0xFF7FFFFF, 0x3F330000, 0x3F32FFFF],
                         np.uint32)
    edges = np.array([88.0, 88.72283, 88.722839, 88.72284, 89.0, -87.33655,
                      -103.0, -103.27893, -103.278931, -103.5, -103.97207,
                      -103.972084, -104.0, 127.99999, 128.0, 128.00002,
                      -126.0, -148.5, -149.0, -149.00002, -149.5, -150.0,
                      -150.00002, 1e-40, 0.5, 2.0, 3.0, 4.0, 1.5, 1e-8,
                      -1e-8], np.float32)
    near = np.concatenate([np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(-np.inf))])
    dense = np.concatenate([rng.uniform(-110, 110, 20_000),
                            rng.uniform(-160, 130, 20_000),
                            rng.uniform(0, 4, 10_000),
                            np.exp(rng.uniform(-80, 80, 20_000))])
    return np.concatenate([bits.view(np.float32), edge_bits.view(np.float32),
                           edges, near, dense.astype(np.float32)])


@pytest.mark.parametrize("name", ["expf", "exp2f", "log2f"])
def test_libm_matches_glibc(name):
    x = _libm_sample()
    fn = _glibc()[name]
    want = np.array([fn(float(v)) for v in x], np.float32)
    got = getattr(libm, name)(torch.from_numpy(x)).numpy()
    _bits_equal(got, want)


def test_fma64_rounds_once():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=20_000))
    b = torch.from_numpy(rng.normal(size=20_000))
    c = -(a * b) + torch.from_numpy(rng.normal(size=20_000)) * 1e-17
    got = libm.fma64(a, b, c).numpy()
    # the exact value as a rational: a * b + c of doubles is exact in
    # Python's integers scaled by 2^2200
    from fractions import Fraction
    for i in range(0, 20_000, 97):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        assert got[i] == float(exact), i


# ----------------------------------------------------------- the gradients
def _gptr(sizes):
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


TOPK_CASES = {
    "mslr": dict(sizes=[40, 199, 77, 120, 163, 58, 91, 40]),
    "big_group": dict(sizes=[2000, 50]),
    "small_groups": dict(sizes=[1, 2, 1, 2, 5, 1]),
    "tied": dict(sizes=[60, 45, 80], scores="tied"),
    "all_equal": dict(sizes=[60, 45, 80], scores="zero"),
    "k_above_n": dict(sizes=[5, 9, 3, 30], k=64),
    "no_score_norm": dict(sizes=[40, 70], score_norm=False),
    "no_group_norm": dict(sizes=[40, 70], group_norm=False),
    "pairwise_weights": dict(sizes=[40, 70, 2], ndcg=False),
    "padded_rows": dict(sizes=[30, 20], pad=24),
    "real_labels": dict(sizes=[50, 60], labels="real"),
    # every score +0.0 or -0.0: one tie across each group
    "signed_zero": dict(sizes=[60, 45, 80], scores="signed_zero"),
    # a group of exactly K5's cap, the largest its bundles take
    "at_cap": dict(sizes=[CAP, 40, CAP - 1]),
}


def _topk_inputs(sizes, scores="normal", labels="graded", pad=0, seed=0):
    rng = np.random.default_rng(seed)
    gp = _gptr(sizes)
    R = int(gp[-1]) + pad
    s = rng.normal(size=R).astype(np.float32)
    if scores == "tied":
        s = np.round(s * 2).astype(np.float32)
        s[::7] = -0.0
    elif scores == "zero":
        s[:] = 0.0
    elif scores == "signed_zero":
        s = np.where(rng.random(R) < 0.5, -0.0, 0.0).astype(np.float32)
    y = rng.integers(0, 5, R).astype(np.float32)
    if labels == "real":
        y = rng.uniform(0, 4, R).astype(np.float32)
    return gp, s, y


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_topk_gradients_are_the_native_kernels(case):
    c = dict(TOPK_CASES[case])
    k = c.pop("k", 32)
    nd = c.pop("ndcg", True)
    sn = c.pop("score_norm", True)
    gn = c.pop("group_norm", True)
    gp, s, y = _topk_inputs(**c)
    assert ref_rank._native_lambdarank_ok()
    g, h = ref_rank._lambda_gradients_topk_native(
        jnp.asarray(s), jnp.asarray(y), jnp.asarray(gp.astype(np.int32)),
        k=k, ndcg_weight=nd, score_norm=sn, group_norm=gn)
    before = dict(hist_cuda.launches)
    out = lambdarank_topk(torch.from_numpy(s), torch.from_numpy(y),
                          GroupLayout(gp, "cpu"), k, nd, sn, gn)
    assert hist_cuda.launches == before  # the CPU takes the plain version
    _bits_equal(out[:, 0, 0].numpy(), g)
    _bits_equal(out[:, 0, 1].numpy(), h)


@pytest.mark.parametrize("sizes", [[5, 12, 8], [32, 20], [33, 10, 1],
                                   [100, 140]])
@pytest.mark.parametrize("num_pair", [1, 3])
@pytest.mark.parametrize("ndcg", [True, False])
def test_mean_gradients_are_the_references(sizes, num_pair, ndcg):
    gp, s, y = _topk_inputs(sizes, seed=len(sizes) + num_pair)
    idx, mask, inv = make_group_layout(gp)
    ridx, rmask, rinv = ref_rank.make_group_layout(gp)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(inv, rinv)
    layout = GroupLayout(gp, "cpu")
    for it in range(3):
        g, h = ref_rank._lambda_gradients(
            jnp.asarray(s), jnp.asarray(y), jnp.asarray(idx),
            jnp.asarray(mask), jnp.asarray(inv), ref_rank.jax.random.PRNGKey(
                it), num_pair, ndcg, group_norm=True)
        out = lambda_gradients_mean(torch.from_numpy(s), torch.from_numpy(y),
                                    layout, it, num_pair, ndcg, True)
        _bits_equal(out[:, 0, 0].numpy(), g)
        _bits_equal(out[:, 0, 1].numpy(), h)


@pytest.mark.parametrize("pair_method", ["topk", "mean"])
def test_objective_gradients_with_weights(pair_method):
    gp, s, y = _topk_inputs([30, 45, 12], seed=8)
    w = np.random.default_rng(8).uniform(0.2, 3, len(s)).astype(np.float32)
    params = {"lambdarank_pair_method": pair_method}
    ours = create_objective("rank:ndcg", params)
    ours.set_group_info(gp)
    ref = ref_rank.LambdaRankNDCG(params)
    ref.set_group_info(gp)
    for weights in (w, w[:3]):  # a weight a group is ignored
        want = ref.get_gradient(jnp.asarray(s)[:, None], jnp.asarray(y),
                                jnp.asarray(weights), 2)
        got = ours.get_gradient(torch.from_numpy(s)[:, None],
                                torch.from_numpy(y),
                                torch.from_numpy(weights), 2)
        _bits_equal(got.numpy(), want)


def test_objective_errors():
    with pytest.raises(NotImplementedError, match="lambdarank_unbiased"):
        create_objective("rank:ndcg", {"lambdarank_unbiased": True})
    with pytest.raises(ValueError, match="lambdarank_pair_method"):
        create_objective("rank:pairwise", {"lambdarank_pair_method": "all"})
    obj = create_objective("rank:map", {})
    with pytest.raises(ValueError, match="group"):
        obj.get_gradient(torch.zeros(4, 1), torch.zeros(4), None)
    assert obj.default_metric() == "map"
    assert create_objective("rank:ndcg", {}).default_metric() == "ndcg"


# ----------------------------------------------------------------- metrics
def _metric_data(G, seed=0):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 30, G)
    sizes[3] = 0 if G > 3 else sizes[3]
    gp = _gptr(sizes)
    R = int(gp[-1])
    preds = rng.normal(size=R).astype(np.float32)
    preds[::5] = np.round(preds[::5])  # ties
    labels = rng.integers(0, 5, R).astype(np.float32)
    labels[gp[1]:gp[2]] = 0  # a group without a relevant doc
    return gp, preds, labels, rng


@pytest.mark.parametrize("name", ["ndcg", "ndcg@5", "ndcg-", "ndcg@3-",
                                  "map", "map@4", "map-", "map@2-", "pre",
                                  "pre@3"])
@pytest.mark.parametrize("G", [10, 80])
@pytest.mark.parametrize("weights", [None, "group", "row"])
def test_rank_metrics_match_the_reference(name, G, weights):
    gp, preds, labels, rng = _metric_data(G, seed=G)
    w = None
    if weights == "group":
        w = rng.uniform(0.5, 2, G).astype(np.float32)
    elif weights == "row":
        w = rng.uniform(0.5, 2, len(preds)).astype(np.float32)
    fn, _ = metric.create_metric(name)
    rfn = ref_metric.create_metric(name)
    rfn = rfn[0] if isinstance(rfn, tuple) else rfn
    for dev in (False, True):
        got = fn(preds, labels, w, group_ptr=gp, use_device_rank=dev)
        for rdev in (False, True):
            want = rfn(preds, labels, w, group_ptr=gp, use_device_rank=rdev)
            assert abs(got - want) <= 1e-6, (dev, rdev, got, want)


def test_rank_metric_names():
    with pytest.raises(ValueError, match="suffix"):
        metric.create_metric("rmse@2-")
    with pytest.raises(ValueError):
        metric.create_metric("ndcg@")
    with pytest.raises(NotImplementedError):
        metric.create_metric("ndcg_unknown")


@pytest.mark.parametrize("weights", [None, "group", "row"])
def test_auc_metrics_with_groups(weights):
    gp, preds, labels, rng = _metric_data(12, seed=3)
    labels = (labels > 1).astype(np.float32)
    w = None if weights is None else rng.uniform(
        0.5, 2, 12 if weights == "group" else len(preds)).astype(np.float32)
    got = metric.create_metric("aucpr")[0](preds, labels, w, group_ptr=gp)
    want = ref_metric.create_metric("aucpr")
    want = (want[0] if isinstance(want, tuple) else want)(
        preds, labels, w, group_ptr=gp)
    assert abs(got - want) <= 1e-6
    if weights != "group":
        a = metric.create_metric("auc")[0](preds, labels, w, group_ptr=gp)
        r = ref_metric.create_metric("auc")
        r = (r[0] if isinstance(r, tuple) else r)(preds, labels, w,
                                                   group_ptr=gp)
        assert abs(a - r) <= 1e-6


# ------------------------------------------------------------------ models
def _rank_data(G=40, F=6, seed=3):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(5, 60, G)
    R = int(sizes.sum())
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    y = np.clip(np.round(np.nan_to_num(X[:, 0]) + rng.normal(size=R)), 0,
                4).astype(np.float32)
    w = rng.uniform(0.5, 2, R).astype(np.float32)
    return X, y, sizes, w


@pytest.mark.parametrize("objective", ["rank:ndcg", "rank:pairwise",
                                       "rank:map"])
@pytest.mark.parametrize("pair_method", ["topk", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_deterministic_model_is_the_references(objective, pair_method,
                                               weighted):
    X, y, sizes, w = _rank_data()
    wt = w if weighted else None
    p = {"objective": objective, "max_depth": 4, "eta": 0.3,
         "deterministic_histogram": 1, "lambdarank_pair_method": pair_method}
    er, ep = {}, {}
    dr = xtb.DMatrix(X, label=y, group=sizes, weight=wt)
    ref = xtb.train(p, dr, 5, evals=[(dr, "train")], verbose_eval=False,
                    evals_result=er)
    dp = xtt.DMatrix(X, label=y, group=sizes, weight=wt, device="cpu")
    port = xtt.train(p, dp, 5, evals=[(dp, "train")], verbose_eval=False,
                     evals_result=ep, device="cpu")
    assert json.dumps(port.save_raw_dict()) == json.dumps(
        _plain(ref.save_raw_dict()))
    name = "ndcg" if objective == "rank:ndcg" else "map"
    np.testing.assert_allclose(ep["train"][name], er["train"][name],
                               atol=1e-6)


def test_ranking_learns_and_stops_on_a_maximised_metric():
    X, y, sizes, _ = _rank_data(G=30, seed=5)
    dp = xtt.DMatrix(X, label=y, group=sizes, device="cpu")
    res = {}
    bst = xtt.train({"objective": "rank:ndcg", "max_depth": 3,
                     "eval_metric": ["map", "ndcg@10"]}, dp, 8,
                    evals=[(dp, "train")], early_stopping_rounds=2,
                    verbose_eval=False, evals_result=res, device="cpu")
    curve = res["train"]["ndcg@10"]
    assert curve[-1] > curve[0]
    assert bst.best_iteration == int(np.argmax(curve))


def test_golden_rank_ndcg_model_margins():
    """The rank:ndcg model written by dmlc/xgboost
    (tests/test_golden_models.py): its stored lambdarank parameters
    (num_pair_per_sample 4294967295, "unset") load as the reference
    loads them."""
    bst = xtt.Booster(model_file=os.path.join(GOLD, "rank_ndcg.json"),
                      device="cpu")
    X = np.load(os.path.join(GOLD, "golden_X.npy"))
    got = bst.predict(xtt.DMatrix(X, device="cpu"), output_margin=True)
    np.testing.assert_allclose(got, np.load(os.path.join(
        GOLD, "rank_ndcg_margin.npy")), rtol=1e-5, atol=1e-5)
    assert bst.objective.name == "rank:ndcg"
    assert bst.objective.num_pair == 32


@pytest.mark.parametrize("objective", ["rank:ndcg", "rank:pairwise"])
def test_models_convert_both_ways(objective):
    X, y, sizes, _ = _rank_data(G=20, seed=9)
    p = {"objective": objective, "max_depth": 3}
    dp = xtt.DMatrix(X, label=y, group=sizes, device="cpu")
    port = xtt.train(p, dp, 4, verbose_eval=False, device="cpu")
    ref = xtb.Booster({})
    ref.load_model_dict(booster_to_dict(port))
    assert ref.save_raw_dict()["learner"]["objective"]["name"] == objective
    np.testing.assert_array_equal(ref.predict(xtb.DMatrix(X)),
                                  port.predict(dp))
    rref = xtb.train(p, xtb.DMatrix(X, label=y, group=sizes), 4,
                     verbose_eval=False)
    back = xtt.Booster({}, device="cpu")
    back.load_model_dict(_plain(rref.save_raw_dict()))
    np.testing.assert_array_equal(back.predict(dp),
                                  rref.predict(xtb.DMatrix(X)))
