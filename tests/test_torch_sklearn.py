"""Port parity for the scikit-learn estimators and the plotting functions:
each estimator with ``device="cpu"`` and deterministic_histogram=1 against
xgboost_tpu's on the same numpy input (byte-identical models, equal
predictions, probabilities, importances, eval logs and best iterations);
get_params/set_params, sklearn's clone and pickling; XGBRanker with
``group`` and ``qid``; plot_importance's bars and to_graphviz's source."""
import json
import pickle

import numpy as np
import pytest

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt

DET = dict(max_depth=3, max_bin=32, n_estimators=4,
           deterministic_histogram=1)


def _data(R=400, F=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    z = (np.nan_to_num(X[:, 0]) + 0.7 * np.nan_to_num(X[:, 1])
         * (X[:, 2] > 0) + 0.3 * rng.normal(size=R)).astype(np.float32)
    return X, z


def _json(model) -> str:
    return json.dumps(model.get_booster().save_raw_dict())


def _pair(cls_name, **kw):
    return (getattr(xtt, cls_name)(device="cpu", **kw),
            getattr(xtb, cls_name)(**kw))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


TARGETS = {
    "XGBRegressor": lambda z: z,
    "XGBRFRegressor": lambda z: z,
    "XGBClassifier": lambda z: (z > 0).astype(np.int64),
    "XGBRFClassifier": lambda z: (z > 0).astype(np.int64),
    "multiclass": lambda z: np.digitize(z, [-0.5, 0.5]),
}


@pytest.mark.parametrize("case", sorted(TARGETS))
def test_estimator_is_the_references(case):
    cls_name = "XGBClassifier" if case == "multiclass" else case
    X, z = _data()
    y = TARGETS[case](z)
    Xv, zv = _data(R=150, seed=1)
    yv = TARGETS[case](zv)
    port, ref = _pair(cls_name, random_state=3, **DET)
    kw = dict(eval_set=[(X, y), (Xv, yv)])
    port.fit(X, y, **kw)
    ref.fit(X, y, **kw)
    assert _json(port) == _json(ref)
    _same(port.predict(Xv), ref.predict(Xv))
    _same(port.predict(Xv, output_margin=True),
          ref.predict(Xv, output_margin=True))
    if hasattr(port, "predict_proba"):
        _same(port.predict_proba(Xv), ref.predict_proba(Xv))
        _same(port.classes_, ref.classes_)
    _same(port.feature_importances_, ref.feature_importances_)
    assert port.evals_result() == ref.evals_result()
    assert set(port.evals_result()) == {"validation_0", "validation_1"}
    _same(port.apply(Xv), ref.apply(Xv))
    _same(port.intercept_, ref.intercept_)


@pytest.mark.parametrize("classes", [["no", "yes"], [10, 20, 30]])
def test_classes_are_encoded_and_decoded_as_the_reference(classes):
    X, z = _data()
    y = np.asarray(classes)[np.digitize(z, [-0.5, 0.5][:len(classes) - 1])]
    port, ref = _pair("XGBClassifier", **DET)
    port.fit(X, y)
    ref.fit(X, y)
    assert _json(port) == _json(ref)
    _same(port.classes_, np.asarray(classes))
    _same(port.predict(X), ref.predict(X))
    _same(port.predict_proba(X), ref.predict_proba(X))


def test_multiclass_softmax_probabilities_are_the_references():
    X, z = _data()
    y = np.digitize(z, [-0.5, 0.5])
    port, ref = _pair("XGBClassifier", objective="multi:softmax", **DET)
    port.fit(X, y)
    ref.fit(X, y)
    _same(port.predict(X), ref.predict(X))
    _same(port.predict_proba(X), ref.predict_proba(X))


@pytest.mark.parametrize("importance_type", ["weight", "gain", "cover",
                                             "total_gain", "total_cover"])
def test_feature_importances_by_type(importance_type):
    X, z = _data()
    port, ref = _pair("XGBRegressor", importance_type=importance_type, **DET)
    port.fit(X, z)
    ref.fit(X, z)
    _same(port.feature_importances_, ref.feature_importances_)
    assert port.feature_importances_.sum() == pytest.approx(1.0)


def test_early_stopping_best_iteration_is_the_references():
    X, z = _data(R=400, seed=6)
    y = (z + np.random.default_rng(8).normal(size=400) > 0).astype(int)
    Xv, zv = _data(R=200, seed=7)
    yv = (zv > 0).astype(int)
    kw = dict(DET, n_estimators=40, max_depth=5, learning_rate=0.6,
              early_stopping_rounds=3, eval_metric="logloss")
    port, ref = _pair("XGBClassifier", **kw)
    port.fit(X, y, eval_set=[(Xv, yv)])
    ref.fit(X, y, eval_set=[(Xv, yv)])
    assert port.best_iteration == ref.best_iteration < 39
    assert port.best_score == ref.best_score
    _same(port.predict_proba(Xv), ref.predict_proba(Xv))
    assert port.evals_result() == ref.evals_result()
    _same(port.predict(Xv, iteration_range=(0, 2)),
          ref.predict(Xv, iteration_range=(0, 2)))


@pytest.mark.parametrize("form", ["group", "qid"])
def test_ranker_is_the_references(form):
    rng = np.random.default_rng(4)
    sizes = rng.integers(5, 15, size=20)
    R = int(sizes.sum())
    X = rng.normal(size=(R, 6)).astype(np.float32)
    rel = np.clip(np.round(X[:, 0] + 0.5 * rng.normal(size=R) + 1), 0,
                  3).astype(np.float32)
    qid = np.repeat(np.arange(len(sizes)), sizes)
    fit_kw = {"group": sizes} if form == "group" else {"qid": qid}
    ev_kw = ({"eval_group": [sizes]} if form == "group"
             else {"eval_qid": [qid]})
    port, ref = _pair("XGBRanker", eval_metric="ndcg@5", **DET)
    port.fit(X, rel, eval_set=[(X, rel)], **fit_kw, **ev_kw)
    ref.fit(X, rel, eval_set=[(X, rel)], **fit_kw, **ev_kw)
    assert _json(port) == _json(ref)
    _same(port.predict(X), ref.predict(X))
    assert port.evals_result() == ref.evals_result()
    _same(port.feature_importances_, ref.feature_importances_)


def test_get_and_set_params_are_the_references():
    port, ref = _pair("XGBClassifier", max_depth=4, custom_knob=2)
    got, want = port.get_params(), ref.get_params()
    assert got.pop("device") == "cpu" and want.pop("device") is None
    assert {k: v for k, v in got.items() if k != "missing"} == \
        {k: v for k, v in want.items() if k != "missing"}
    port.set_params(max_depth=2, other_knob=1)
    assert port.max_depth == 2 and port.get_params()["other_knob"] == 1
    assert xtt.XGBRegressor().device is None  # the card, as everywhere


@pytest.mark.parametrize("cls_name", ["XGBRegressor", "XGBClassifier",
                                      "XGBRanker", "XGBRFRegressor",
                                      "XGBRFClassifier"])
def test_sklearn_clone(cls_name):
    base = pytest.importorskip("sklearn.base")
    est = getattr(xtt, cls_name)(device="cpu", max_depth=2, n_estimators=3)
    twin = base.clone(est)
    assert type(twin) is type(est) and twin is not est
    got, want = twin.get_params(), est.get_params()
    assert np.isnan(got.pop("missing")) and np.isnan(want.pop("missing"))
    assert got == want
    assert twin.max_depth == 2 and twin.device == "cpu"


def test_sklearn_tags_allow_nan():
    pytest.importorskip("sklearn")
    tags = xtt.XGBRegressor(device="cpu").__sklearn_tags__()
    assert tags.input_tags.allow_nan


@pytest.mark.parametrize("cls_name", ["XGBRegressor", "XGBClassifier"])
def test_pickled_estimator_predicts_identically(cls_name):
    X, z = _data()
    y = z if cls_name == "XGBRegressor" else (z > 0).astype(int)
    est = getattr(xtt, cls_name)(device="cpu", **DET).fit(X, y)
    back = pickle.loads(pickle.dumps(est))
    _same(back.predict(X), est.predict(X))
    assert _json(back) == _json(est)
    assert not back.get_booster()._caches


def test_save_and_load_model(tmp_path):
    X, z = _data()
    est = xtt.XGBRegressor(device="cpu", **DET).fit(X, z)
    path = tmp_path / "m.json"
    est.save_model(path)
    back = xtt.XGBRegressor(device="cpu")
    back.load_model(path)
    _same(back.predict(X), est.predict(X))
    ref = xtb.XGBRegressor()
    ref.load_model(str(path))
    _same(ref.predict(X), est.predict(X))


@pytest.mark.parametrize("importance_type,max_num", [("weight", None),
                                                     ("gain", 3),
                                                     ("total_cover", None)])
def test_plot_importance_bars_are_the_references(importance_type, max_num):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    X, z = _data()
    port, ref = _pair("XGBRegressor", **DET)
    port.fit(X, z)
    ref.fit(X, z)
    axes = [pkg.plot_importance(m, importance_type=importance_type,
                                max_num_features=max_num)
            for pkg, m in ((xtt, port), (xtb, ref))]
    try:
        bars = [[(p.get_width(), p.get_y()) for p in ax.patches]
                for ax in axes]
        labels = [[t.get_text() for t in ax.get_yticklabels()]
                  for ax in axes]
        texts = [[t.get_text() for t in ax.texts] for ax in axes]
        assert bars[0] == bars[1] and bars[0]
        assert labels[0] == labels[1] and texts[0] == texts[1]
    finally:
        plt.close("all")


@pytest.mark.parametrize("num_trees", [0, 3])
def test_to_graphviz_source_is_the_references(tmp_path, num_trees):
    pytest.importorskip("graphviz")
    X, z = _data()
    port, ref = _pair("XGBRegressor", **DET)
    port.fit(X, z)
    ref.fit(X, z)
    fmap = tmp_path / "fmap.txt"
    fmap.write_text("0\tfirst\tq\n1\tsecond\tq\n")
    kw = dict(num_trees=num_trees, rankdir="LR", fmap=str(fmap),
              leaf_node_params={"color": "green"})
    got = xtt.to_graphviz(port, **kw)
    want = xtb.to_graphviz(ref, **kw)
    assert got.source == want.source
    assert "first" in got.source


def test_plotting_refuses_what_is_not_a_booster():
    pytest.importorskip("matplotlib")
    with pytest.raises(ValueError):
        xtt.plot_importance(object())
