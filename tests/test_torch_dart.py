"""Port parity for booster="dart" (gbtree.cc Dart; reference core.py:
1281-1306, :1620-1679): the drop draws, the gradient on the margin without
the dropped trees, the rescale of the new and dropped trees, the weighted
stacking of leaf values, and the model's DART layout, held against
xgboost_tpu on the same numpy input.

Tolerances: under deterministic_histogram=1 the model JSON, weight_drop
included, is byte-identical to the reference's; predictions of a model
loaded across the packages are equal.  A continuation is byte-identical to
the reference's continuation: in both packages it rebuilds the margin as
the sum of the weighted trees, which is not the drop rounds' running
margin, so neither equals its own uninterrupted run bitwise."""
import json
import os

import numpy as np
import pytest

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt

HERE = os.path.dirname(os.path.abspath(__file__))
DART = {"booster": "dart", "rate_drop": 0.3, "max_depth": 3, "max_bin": 32,
        "eta": 0.3, "deterministic_histogram": 1, "seed": 3,
        "objective": "binary:logistic"}


def _data(R=1200, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    z = (np.nan_to_num(X[:, 0]) + 0.8 * np.nan_to_num(X[:, 1])
         * (X[:, 2] > 0) - 0.5 * np.nan_to_num(X[:, 3]) ** 2
         + 0.3 * rng.normal(size=R)).astype(np.float32)
    return X, z


def _labels(z, objective):
    if objective == "binary:logistic":
        return (z > 0).astype(np.float32)
    if objective.startswith("multi:"):
        return np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    return z


def _json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _both(params, rounds=8, **dm):
    X, z = _data()
    y = _labels(z, params["objective"])
    ref = xtb.train(params, xtb.DMatrix(X, label=y, **dm), rounds,
                    verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu", **dm),
                    rounds, verbose_eval=False, device="cpu")
    return X, y, ref, got


CASES = {
    "uniform_tree": {},
    "uniform_forest": {"normalize_type": "forest"},
    "weighted_tree": {"sample_type": "weighted"},
    "weighted_forest": {"sample_type": "weighted",
                        "normalize_type": "forest"},
    "one_drop": {"rate_drop": 0.05, "one_drop": 1},
    "skip_drop": {"skip_drop": 0.5},
    "parallel_trees": {"num_parallel_tree": 2, "subsample": 0.8,
                       "colsample_bynode": 0.8},
    "softprob": {"objective": "multi:softprob", "num_class": 3},
    "squarederror": {"objective": "reg:squarederror", "base_score": 0.1},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_deterministic_dart_model_is_the_references(name):
    params = dict(DART, **CASES[name])
    X, y, ref, got = _both(params)
    raw = got.save_raw_dict()
    gb = raw["learner"]["gradient_booster"]
    assert gb["name"] == "dart" and "gbtree" in gb
    assert len(gb["weight_drop"]) == len(got.trees)
    # dropout really fired (or, with skip_drop, was skipped on some rounds)
    assert any(w != 1.0 for w in gb["weight_drop"])
    assert _json(got) == _json(ref)
    np.testing.assert_array_equal(
        got.predict(xtt.DMatrix(X, device="cpu"), output_margin=True),
        np.asarray(ref.predict(xtb.DMatrix(X), output_margin=True)))


def test_drop_selection_is_the_references():
    """The drop sets of every round, for both sample types."""
    for extra in ({}, {"sample_type": "weighted", "one_drop": 1}):
        port = xtt.Booster(dict(DART, **extra), device="cpu")
        ref = xtb.Booster(dict(DART, **extra))
        port._configure()
        ref._configure()
        for n in (1, 5, 17):
            w = list(np.linspace(0.2, 1.0, n))
            port.trees, port.tree_weights = [None] * n, list(w)
            ref.trees, ref.tree_weights = [None] * n, list(w)
            for it in range(6):
                assert [int(i) for i in port._select_dart_drops(it)] == \
                    [int(i) for i in ref._select_dart_drops(it)]


def test_custom_objective_called_once_a_drop_round_on_the_reduced_margin():
    seen = {"port": [], "ref": []}

    def make(key):
        def fobj(margin, dmat):
            seen[key].append(np.array(margin))
            y = dmat.get_label()
            p = 1.0 / (1.0 + np.exp(-margin))
            return p - y, np.maximum(p * (1.0 - p), 1e-6)
        return fobj

    X, z = _data()
    y = (z > 0).astype(np.float32)
    params = dict(DART, rate_drop=0.5)
    ref = xtb.train(params, xtb.DMatrix(X, label=y), 6, obj=make("ref"),
                    verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), 6,
                    obj=make("port"), verbose_eval=False, device="cpu")
    assert len(seen["port"]) == len(seen["ref"]) == 6
    for a, b in zip(seen["port"], seen["ref"]):
        np.testing.assert_array_equal(a, b)
    assert _json(got) == _json(ref)
    # the margins a drop round gave the objective are not the full model's
    full = got[0:5].predict(xtt.DMatrix(X, device="cpu"), output_margin=True)
    assert not np.array_equal(seen["port"][5], full)


def test_boost_raises_on_a_drop_round():
    X, z = _data(R=300)
    y = (z > 0).astype(np.float32)
    d = xtt.DMatrix(X, label=y, device="cpu")
    bst = xtt.train(dict(DART, rate_drop=1.0), d, 1, verbose_eval=False,
                    device="cpu")
    g, h = np.zeros(300, np.float32), np.ones(300, np.float32)
    with pytest.raises(NotImplementedError, match="DART"):
        bst.boost(d, g, h, iteration=1)
    ref = xtb.train(dict(DART, rate_drop=1.0), xtb.DMatrix(X, label=y), 1,
                    verbose_eval=False)
    with pytest.raises(NotImplementedError, match="DART"):
        ref.boost(xtb.DMatrix(X, label=y), g, h, iteration=1)
    # a round that drops nothing boosts
    calm = xtt.train(dict(DART, rate_drop=0.0), d, 1, verbose_eval=False,
                     device="cpu")
    calm.boost(d, g, h, iteration=1)
    assert calm.num_boosted_rounds() == 2


@pytest.mark.parametrize("form", ["booster", "json_bytes"])
def test_continuation_is_the_references(form):
    X, z = _data()
    y = (z > 0).astype(np.float32)
    models = {}
    for pkg, kw in ((xtb, {}), (xtt, {"device": "cpu"})):
        half = pkg.train(DART, pkg.DMatrix(X, label=y, **kw), 4,
                         verbose_eval=False, **kw)
        model = half if form == "booster" else half.save_raw("json")
        cont = pkg.train(DART, pkg.DMatrix(X, label=y, **kw), 4,
                         xgb_model=model, verbose_eval=False, **kw)
        assert cont.num_boosted_rounds() == 8
        models[pkg.__name__] = _json(cont)
    assert models["xgboost_tpu_torch"] == models["xgboost_tpu"]


@pytest.mark.parametrize("fmt", ["json", "ubj"])
def test_dart_files_load_across_the_packages(fmt, tmp_path):
    X, y, ref, got = _both(DART)
    ref_path, port_path = (str(tmp_path / f"ref.{fmt}"),
                           str(tmp_path / f"port.{fmt}"))
    ref.save_model(ref_path)
    got.save_model(port_path)
    into_port = xtt.Booster(model_file=ref_path, device="cpu")
    into_ref = xtb.Booster(model_file=port_path)
    assert into_port.tree_weights == ref.tree_weights
    assert into_ref.tree_weights == got.tree_weights
    want = np.asarray(ref.predict(xtb.DMatrix(X)))
    np.testing.assert_array_equal(
        into_port.predict(xtt.DMatrix(X, device="cpu")), want)
    np.testing.assert_array_equal(np.asarray(into_ref.predict(
        xtb.DMatrix(X))), got.predict(xtt.DMatrix(X, device="cpu")))
    assert _json(into_port) == _json(ref)


def test_golden_dart_model_margins():
    """A model written by dmlc/xgboost itself (trained with rate_drop=0, so
    it pins the tree format; tests/test_golden_models.py)."""
    gold = os.path.join(HERE, "data", "models")
    bst = xtt.Booster(model_file=os.path.join(gold, "dart.json"),
                      device="cpu")
    X = np.load(os.path.join(gold, "golden_X.npy"))
    got = bst.predict(xtt.DMatrix(X, device="cpu"), output_margin=True)
    np.testing.assert_allclose(got, np.load(os.path.join(
        gold, "dart_margin.npy")), rtol=1e-5, atol=1e-5)


def test_dart_config_slicing_and_serialize():
    X, y, ref, got = _both(DART, rounds=6)
    cfg, cfg_ref = json.loads(got.save_config()), json.loads(
        ref.save_config())
    gb, gb_ref = (cfg["learner"]["gradient_booster"],
                  cfg_ref["learner"]["gradient_booster"])
    assert gb["name"] == "dart"
    assert cfg["learner"]["learner_train_param"]["booster"] == "dart"
    assert gb["dart_train_param"] == gb_ref["dart_train_param"] == {
        "rate_drop": "0.3"}
    assert gb["gbtree_train_param"] == gb_ref["gbtree_train_param"]
    # a slice keeps its trees' weights and predicts as the reference's
    part, part_ref = got[1:4], ref[1:4]
    assert part.tree_weights == part_ref.tree_weights == \
        got.tree_weights[1:4]
    np.testing.assert_array_equal(
        part.predict(xtt.DMatrix(X, device="cpu"), output_margin=True),
        np.asarray(part_ref.predict(xtb.DMatrix(X), output_margin=True)))
    # serialize: config and model restore the DART booster
    back = xtt.Booster(device="cpu")
    back.unserialize(got.serialize())
    assert back.booster_kind == "dart" and back.rate_drop == 0.3
    assert _json(back) == _json(got)
    into_ref = xtb.Booster()
    into_ref.unserialize(got.serialize())
    assert json.dumps(into_ref.save_raw_dict()) == _json(ref)


def test_dart_eval_set_matches_predict_after_drop_rounds():
    """An evaluation cache rebuilds from scratch after a rescale."""
    X, z = _data()
    y = (z > 0).astype(np.float32)
    d = xtt.DMatrix(X, label=y, device="cpu")
    dv = xtt.DMatrix(X[:400], label=y[:400], device="cpu")
    res, res_ref = {}, {}
    bst = xtt.train(DART, d, 6, evals=[(dv, "v")], evals_result=res,
                    verbose_eval=False, device="cpu")
    xtb.train(DART, xtb.DMatrix(X, label=y), 6,
              evals=[(xtb.DMatrix(X[:400], label=y[:400]), "v")],
              evals_result=res_ref, verbose_eval=False)
    np.testing.assert_allclose(res["v"]["logloss"], res_ref["v"]["logloss"],
                               rtol=1e-6)
    cache = bst._caches[id(dv)]
    bst._sync_margin(cache)
    assert cache.weights_version == bst._weights_version > 0
    # the cache starts from the base margin, predict adds it last
    np.testing.assert_allclose(
        cache.margin[:400, 0].numpy(),
        bst.predict(dv, output_margin=True), rtol=1e-6, atol=1e-6)


def test_dart_cv_and_estimator_are_the_references():
    X, z = _data(R=900)
    y = (z > 0).astype(np.float32)
    got = xtt.cv(DART, xtt.DMatrix(X, label=y, device="cpu"), 5, nfold=3,
                 as_pandas=False, seed=1, device="cpu")
    ref = xtb.cv(DART, xtb.DMatrix(X, label=y), 5, nfold=3, as_pandas=False,
                 seed=1)
    assert sorted(got) == sorted(ref)
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6)
    kw = dict(booster="dart", rate_drop=0.3, n_estimators=6, max_depth=3,
              max_bin=32, deterministic_histogram=1)
    a = xtt.XGBClassifier(device="cpu", **kw).fit(X, y)
    b = xtb.XGBClassifier(**kw).fit(X, y)
    assert _json(a.get_booster()) == json.dumps(
        b.get_booster().save_raw_dict())
    np.testing.assert_array_equal(a.predict_proba(X),
                                  np.asarray(b.predict_proba(X)))
