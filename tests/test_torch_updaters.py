"""Port parity for the non-growing updaters and process_type="update"
(models/updaters.py; reference xgboost_tpu/models/updaters.py and
core.py:1191-1279): refresh, prune and sync on the same trees, and the
update flow over a model's rounds, with its errors, held against
xgboost_tpu on the same numpy input; the reference's own cases
(tests/test_updaters_process.py) ported.

Tolerance: none.  The updaters are the same numpy in both packages and the
gradients the reference's bits, so trees and model JSON are identical.
The model to update is trained once, by the reference, and loaded into
both packages: its f32 hist trees are not the port's bits."""
import copy
import json

import numpy as np
import pytest

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu.models import updaters as ref_updaters
from xgboost_tpu_torch.models import updaters
from xgboost_tpu_torch.models.tree import RegTree


def _data(R=1200, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) * np.nan_to_num(X[:, 1])
         + 0.3 * rng.normal(size=R)).astype(np.float32)
    return X, y


def _json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _model(params=None, rounds=4, seed=0):
    """A reference model's JSON bytes and its training data."""
    X, y = _data(seed=seed)
    p = {"objective": "reg:squarederror", "max_depth": 4, "eta": 0.5,
         **(params or {})}
    if p["objective"] == "binary:logistic":
        y = (y > 0).astype(np.float32)
    if p["objective"].startswith("multi:"):
        y = np.digitize(y, [-0.3, 0.3]).astype(np.float32)
    ref = xtb.train(p, xtb.DMatrix(X, label=y), rounds, verbose_eval=False)
    return bytes(ref.save_raw("json")), X, y


def _trees(raw):
    port = xtt.Booster(device="cpu")
    port.load_model(bytearray(raw))
    ref = xtb.Booster()
    ref.load_model(bytearray(raw))
    return port.trees, ref.trees


@pytest.mark.parametrize("refresh_leaf", [True, False])
def test_refresh_tree_is_the_references(refresh_leaf):
    raw, X, y = _model()
    port_trees, ref_trees = _trees(raw)
    X2, y2 = _data(seed=1)
    rng = np.random.default_rng(2)
    g = rng.normal(size=len(X2)).astype(np.float32)
    h = rng.random(len(X2)).astype(np.float32)
    for a, b in zip(port_trees, ref_trees):
        a = updaters.refresh_tree(a, X2, g, h, eta=0.3, lambda_=1.0,
                                  alpha=0.1, refresh_leaf=refresh_leaf)
        b = ref_updaters.refresh_tree(b, X2, g, h, eta=0.3, lambda_=1.0,
                                      alpha=0.1, refresh_leaf=refresh_leaf)
        assert a.to_json_dict(6, 0) == b.to_json_dict(6, 0)


@pytest.mark.parametrize("gamma,max_depth", [(0.0, 0), (0.5, 0), (5.0, 0),
                                             (0.0, 2), (1e9, 0)])
def test_prune_tree_is_the_references(gamma, max_depth):
    raw, X, y = _model()
    port_trees, ref_trees = _trees(raw)
    for a, b in zip(port_trees, ref_trees):
        a2, na = updaters.prune_tree(a, gamma=gamma, eta=0.5,
                                     max_depth=max_depth)
        b2, nb = ref_updaters.prune_tree(b, gamma=gamma, eta=0.5,
                                         max_depth=max_depth)
        assert na == nb
        assert isinstance(a2, RegTree)
        assert a2.to_json_dict(6, 0) == b2.to_json_dict(6, 0)
        if gamma >= 1e9:
            assert a2.n_nodes == 1


def test_route_masks_and_sync_are_the_references():
    raw, X, y = _model()
    port_trees, ref_trees = _trees(raw)
    for a, b in zip(port_trees, ref_trees):
        np.testing.assert_array_equal(updaters._route_masks(a, X),
                                      ref_updaters._route_masks(b, X))
    trees, info, wts = updaters.sync_trees(port_trees, [0] * 4, [1.0] * 4)
    assert trees is port_trees and info == [0] * 4 and wts == [1.0] * 4


UPDATES = {
    "refresh": {"updater": "refresh"},
    "refresh_keep_leaves": {"updater": "refresh", "refresh_leaf": 0},
    "prune": {"updater": "prune", "gamma": 2.0},
    "prune_depth": {"updater": "prune", "max_depth": 2},
    "refresh_prune": {"updater": "refresh,prune", "gamma": 1.0},
    "refresh_prune_sync": {"updater": "refresh,prune,sync", "gamma": 1.0,
                           "refresh_leaf": "0"},
    "logistic": {"updater": "refresh,prune", "gamma": 0.5,
                 "objective": "binary:logistic"},
    "softprob": {"updater": "refresh", "objective": "multi:softprob",
                 "num_class": 3},
    "forest": {"updater": "refresh,prune", "num_parallel_tree": 2,
               "gamma": 0.5, "subsample": 0.8},
}


@pytest.mark.parametrize("name", sorted(UPDATES))
def test_process_type_update_model_is_the_references(name):
    upd = dict(UPDATES[name])
    base = {k: upd.pop(k) for k in ("objective", "num_class",
                                    "num_parallel_tree", "subsample")
            if k in upd}
    raw, _, _ = _model(base)
    X2, y2 = _data(seed=1)
    if base.get("objective") == "binary:logistic":
        y2 = (y2 > 0).astype(np.float32)
    elif "num_class" in base:
        y2 = np.digitize(y2, [-0.3, 0.3]).astype(np.float32)
    params = {"objective": "reg:squarederror", "max_depth": 4, "eta": 0.5,
              **base, "process_type": "update", **upd}
    out = {}
    for pkg, kw in ((xtb, {}), (xtt, {"device": "cpu"})):
        bst = pkg.train(params, pkg.DMatrix(X2, label=y2, **kw), 4,
                        xgb_model=bytearray(raw), verbose_eval=False, **kw)
        assert bst.num_boosted_rounds() == 4
        out[pkg.__name__] = _json(bst)
    assert out["xgboost_tpu_torch"] == out["xgboost_tpu"]


def test_update_starting_past_round_zero_is_the_references():
    """A fresh cache at round 2 rebuilds the margin of rounds 0-1."""
    raw, X, y = _model(rounds=4)
    got = {}
    for pkg, kw in ((xtb, {}), (xtt, {"device": "cpu"})):
        bst = pkg.Booster(**kw)
        bst.load_model(bytearray(raw))
        bst.set_param({"process_type": "update", "updater": "refresh",
                       "max_depth": 4, "eta": 0.5})
        d = pkg.DMatrix(X[::2], label=y[::2], **kw)
        bst.update(d, 2)
        bst.update(d, 3)
        got[pkg.__name__] = _json(bst)
    assert got["xgboost_tpu_torch"] == got["xgboost_tpu"]


def test_refresh_recomputes_leaves_on_new_data():
    """(the reference's test_refresh_recomputes_leafs_on_new_data)"""
    raw, X, y = _model(rounds=5)
    X2, y2 = _data(seed=1)
    bst = xtt.Booster(device="cpu")
    bst.load_model(bytearray(raw))
    before = [t.left_children.copy() for t in bst.trees]
    d2 = xtt.DMatrix(X2, label=y2, device="cpu")
    p0 = bst.predict(d2)
    bst.set_param({"process_type": "update", "updater": "refresh",
                   "eta": 0.5})
    for it in range(5):
        bst.update(d2, it)
    for a, t in zip(before, bst.trees):
        np.testing.assert_array_equal(a, t.left_children)
    assert np.mean((bst.predict(d2) - y2) ** 2) < np.mean((p0 - y2) ** 2)


def test_refresh_leaf_false_keeps_predictions():
    raw, X, y = _model(rounds=3)
    bst = xtt.Booster(device="cpu")
    bst.load_model(bytearray(raw))
    d = xtt.DMatrix(X, label=y, device="cpu")
    p0 = bst.predict(d)
    bst.set_param({"process_type": "update", "updater": "refresh",
                   "refresh_leaf": "0"})
    for it in range(3):
        bst.update(d, it)
    np.testing.assert_allclose(bst.predict(d), p0, rtol=1e-6)


def test_prune_collapses_low_gain_splits():
    raw, X, y = _model({"max_depth": 6}, rounds=3)
    bst = xtt.Booster(device="cpu")
    bst.load_model(bytearray(raw))
    leaves = lambda b: [int((t.left_children == -1).sum())  # noqa: E731
                        for t in b.trees]
    before = leaves(bst)
    d = xtt.DMatrix(X, label=y, device="cpu")
    bst.set_param({"process_type": "update", "updater": "prune",
                   "gamma": 1e6})
    for it in range(3):
        bst.update(d, it)
    assert all(a == 1 for a in leaves(bst)) and all(b > 1 for b in before)
    assert np.isfinite(bst.predict(d)).all()


def test_update_errors_are_the_references():
    raw, X, y = _model(rounds=2)
    for pkg, kw in ((xtb, {}), (xtt, {"device": "cpu"})):
        bst = pkg.Booster(**kw)
        bst.load_model(bytearray(raw))
        d = pkg.DMatrix(X, label=y, **kw)
        bst.set_param("process_type", "update")
        with pytest.raises(ValueError, match="requires updater"):
            bst.update(d, 0)
        bst.set_param("updater", "refresh,grow_histmaker")
        with pytest.raises(ValueError, match="unsupported updater"):
            bst.update(d, 0)
        bst.set_param("updater", "refresh")
        bst.update(d, 0)
        bst.update(d, 1)
        with pytest.raises(ValueError, match="exceeds"):
            bst.update(d, 2)
        with pytest.raises(NotImplementedError, match="custom objective"):
            bst.update(d, 0, fobj=lambda m, dm: (m, m))
        with pytest.raises(NotImplementedError, match="boost"):
            bst.boost(d, np.zeros(len(y)), np.ones(len(y)))
    with pytest.raises(ValueError, match="process_type"):
        xtt.Booster({"process_type": "sideways"}, device="cpu")._configure()


def test_update_keeps_a_copy_of_the_model_intact():
    raw, X, y = _model(rounds=2)
    bst = xtt.Booster(device="cpu")
    bst.load_model(bytearray(raw))
    keep = copy.deepcopy(bst.trees)
    upd = xtt.train({"process_type": "update", "updater": "refresh",
                     "max_depth": 4}, xtt.DMatrix(X, label=y, device="cpu"),
                    2, xgb_model=bst, verbose_eval=False, device="cpu")
    assert upd.num_boosted_rounds() == 2
    cfg = json.loads(upd.save_config())["learner"]["gradient_booster"]
    assert cfg["gbtree_train_param"]["process_type"] == "update"
    assert cfg["gbtree_train_param"]["updater"] == "refresh"
    # the booster given as xgb_model keeps its trees
    for a, b in zip(keep, bst.trees):
        assert a.to_json_dict(6, 0) == b.to_json_dict(6, 0)
    assert any(a.to_json_dict(6, 0) != b.to_json_dict(6, 0)
               for a, b in zip(keep, upd.trees))
