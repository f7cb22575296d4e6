"""The lockstep class-batched grower of the port (tree/grow_lockstep.py,
``_lockstep=1``), mirroring the reference's tests/test_lockstep.py:41-69
and held against xgboost_tpu on the same numpy input.

Tolerances:
- on the CPU the port's lockstep trees are bitwise the port's sequential
  loop's (the same dump hash and predictions): each class's histogram,
  scan and routing are the sequential grower's arithmetic;
- against the reference's lockstep model: its trees, margins within 1e-5,
  or the same trees up to a near tie decided by f32 sums in another order
  (the two gains within 1e-5, relative);
- the plain class histograms equal K of the port's single histograms
  bitwise, and the reference's build_histogram_multi at rtol/atol 1e-5.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu.ops.histogram import build_histogram_multi as ref_multi
from xgboost_tpu.tree import grow_lockstep as ref_lockstep
from xgboost_tpu_torch.ops import hist_cuda
from xgboost_tpu_torch.tree import grow_lockstep

from test_torch_multitarget import _same_trees


def _data(n=2000, f=8, k=5, seed=2):
    """The reference's lockstep generator (tests/test_lockstep.py:16-23)
    at 2000 rows: 8% NaN, classes cut from a linear score's range."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.random(X.shape) < 0.08] = np.nan
    z = np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])
    y = np.clip(((z - z.min()) / (np.ptp(z) + 1e-9) * k), 0,
                k - 1).astype(np.int64).astype(np.float32)
    return X, y


def _h(bst):
    return hashlib.md5(
        "".join(bst.get_dump(dump_format="json")).encode()).hexdigest()


def _params(k, extra=None):
    p = {"objective": "multi:softprob", "num_class": k, "max_depth": 4,
         "eta": 0.3, "max_bin": 32, "_lockstep": "1"}
    p.update(extra or {})
    return p


def _train(X, y, k, extra=None, rounds=3, **dm):
    return xtt.train(_params(k, extra),
                     xtt.DMatrix(X, label=y, device="cpu", **dm), rounds,
                     verbose_eval=False, device="cpu")


@pytest.fixture
def lockstep_calls(monkeypatch):
    """How many rounds each package grew in lockstep."""
    calls = {"port": 0, "ref": 0}
    for key, cls in (("port", grow_lockstep.LockstepHistGrower),
                     ("ref", ref_lockstep.LockstepHistGrower)):
        grow = cls.grow

        def counted(self, *a, _grow=grow, _key=key, **kw):
            calls[_key] += 1
            return _grow(self, *a, **kw)
        monkeypatch.setattr(cls, "grow", counted)
    return calls


def _same_as_sequential(X, y, k, extra=None, **dm):
    a = _train(X, y, k, extra, **dm)
    b = _train(X, y, k, {**(extra or {}), "_lockstep": "0"}, **dm)
    assert _h(a) == _h(b)
    d = xtt.DMatrix(X, device="cpu")
    np.testing.assert_array_equal(a.predict(d), b.predict(d))
    return a


def test_lockstep_bitwise_matches_sequential(lockstep_calls):
    X, y = _data()
    _same_as_sequential(X, y, 5)
    assert lockstep_calls["port"] == 3


def test_lockstep_with_monotone_and_interaction(lockstep_calls):
    X, y = _data(f=6)
    extra = {"monotone_constraints": "(1,0,-1,0,0,0)",
             "interaction_constraints": "[[0, 1, 2], [3, 4, 5]]"}
    _same_as_sequential(X, y, 5, extra)
    assert lockstep_calls["port"] == 3


@pytest.mark.parametrize("grow_policy,lockstep_rounds", [
    ("lossguide", 0),  # max_leaves > 1 under lossguide: best-first
    ("depthwise", 3),  # the budget in node order, per class tree
])
def test_lockstep_subsample_and_leaves_budget(grow_policy, lockstep_rounds,
                                              lockstep_calls):
    X, y = _data()
    extra = {"subsample": 0.7, "seed": 9, "max_leaves": 6,
             "grow_policy": grow_policy, "max_depth": 4}
    bst = _same_as_sequential(X, y, 5, extra)
    assert lockstep_calls["port"] == lockstep_rounds
    assert all(int(np.sum(t.left_children == -1)) <= 6 for t in bst.trees)


def test_lockstep_with_weights_and_forest(lockstep_calls):
    X, y = _data(n=1200)
    w = np.random.default_rng(3).uniform(0.5, 2.0, len(y)).astype(np.float32)
    _same_as_sequential(X, y, 4, {"num_parallel_tree": 2, "subsample": 0.8},
                        weight=w)
    assert lockstep_calls["port"] == 3 * 2


def test_lockstep_softmax_quality():
    X, y = _data()
    bst = _train(X, y, 5, {"objective": "multi:softmax"}, rounds=6)
    pred = bst.predict(xtt.DMatrix(X, device="cpu"))
    assert np.mean(pred != y) < 0.25


@pytest.mark.parametrize("extra", [{}, {"max_leaves": 5},
                                   {"monotone_constraints": "(1,0,-1,0,0,0)"}])
def test_lockstep_grows_the_references_lockstep_trees(extra, lockstep_calls):
    X, y = _data(f=6)
    params = _params(5, extra)
    ref = xtb.train(params, xtb.DMatrix(X, label=y), 3, verbose_eval=False)
    got = _train(X, y, 5, extra)
    assert lockstep_calls == {"port": 3, "ref": 3}
    _same_trees(ref, got, X)


@pytest.mark.parametrize("extra,dm", [
    ({"colsample_bynode": 0.8, "seed": 2}, {}),
    ({"colsample_bytree": 0.7}, {}),
    ({"deterministic_histogram": 1}, {}),
    ({"max_cat_to_onehot": 4}, {"feature_types": ["c"] + ["q"] * 5,
                                "enable_categorical": True}),
    ({"_hist_impl": "native"}, {}),
    ({"_lockstep": "0"}, {}),
])
def test_gate_takes_the_sequential_loop_as_the_reference(extra, dm,
                                                         lockstep_calls):
    """Column sampling, deterministic_histogram, categorical features,
    another _hist_impl or _lockstep off: both packages grow the round
    sequentially (the reference's gate, core.py:1510-1516, :1522), and the
    port's model is its sequential loop's."""
    X, y = _data(n=1000, f=6)
    if "feature_types" in dm:
        X[:, 0] = np.random.default_rng(1).integers(0, 6, len(y))
    xtb.train(_params(4, extra), xtb.DMatrix(X, label=y, **dm), 2,
              verbose_eval=False)
    got = _train(X, y, 4, extra, rounds=2, **dm)
    seq = _train(X, y, 4, {**extra, "_lockstep": "0"}, rounds=2, **dm)
    assert lockstep_calls == {"port": 0, "ref": 0}
    assert _h(got) == _h(seq)


@pytest.mark.parametrize("node0,n_nodes,stride", [(0, 1, 1), (1, 1, 2),
                                                  (3, 2, 2), (7, 8, 1)])
def test_plain_class_histograms(node0, n_nodes, stride):
    """build_histogram_multi on the CPU: K single histograms of the class
    columns and their own pos, bitwise; the reference's within 1e-5."""
    rng = np.random.default_rng(node0 + 7)
    R, F, B, K = 1500, 6, 32, 4
    bins = rng.integers(0, B + 1, size=(R, F)).astype(np.uint8)
    gpair = rng.normal(size=(R, K, 2)).astype(np.float32)
    pos = rng.integers(node0 - 1, node0 + stride * n_nodes + 1,
                       size=(K, R)).astype(np.int32)
    pos[:, -40:] = -1
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=B, stride=stride)
    tb, tg, tp = (torch.from_numpy(a) for a in (bins, gpair, pos))
    got = hist_cuda.build_histogram_multi(tb, tg, tp, **kw)
    assert got.shape == (K, n_nodes, F, B, 2)
    for k in range(K):
        assert torch.equal(got[k], hist_cuda.build_histogram(
            tb, tg[:, k].contiguous(), tp[k], **kw))
    want = np.asarray(ref_multi(jnp.asarray(bins), jnp.asarray(gpair),
                                jnp.asarray(pos), node0, n_nodes=n_nodes,
                                n_bin=B, stride=stride))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
