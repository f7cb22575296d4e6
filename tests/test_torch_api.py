"""Port parity for the train/Booster surface around the boosting loop:
continued training (``xgb_model`` as a Booster, a path or bytes), a custom
objective (``obj``), ``Booster.boost``, a custom metric, ``pred_leaf``,
``save_raw`` and ``set_param``, held against xgboost_tpu on the same numpy
input.  Under deterministic_histogram=1 the models are byte-identical to
the reference's; the leaf ids are equal; metric logs agree to 1e-6 (the
reference prints them with ``%g``)."""
import json

import numpy as np
import pytest

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu.ops.predict import predict_leaf_ids as ref_leaf_ids

DET = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32,
       "eta": 0.3, "deterministic_histogram": 1, "subsample": 0.8,
       "seed": 2}


def _data(R=1500, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    z = (np.nan_to_num(X[:, 0]) + 0.8 * np.nan_to_num(X[:, 1])
         * (X[:, 2] > 0) + 0.4 * rng.normal(size=R)).astype(np.float32)
    return X, z


def _json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _dm(X, **kw):
    return xtt.DMatrix(X, device="cpu", **kw)


@pytest.mark.parametrize("form", ["booster", "ubj_bytes", "json_path",
                                  "ubj_path"])
def test_continuation_is_the_uninterrupted_run(form, tmp_path):
    """5 + 5 rounds with subsample=0.8 equal 10 rounds byte for byte (the
    continuation counts rounds from the loaded model, so rounds 5-9 draw
    the same rows), and equal the reference's own continuation."""
    X, z = _data()
    y = (z > 0).astype(np.float32)
    d = _dm(X, label=y)
    full = xtt.train(DET, d, 10, verbose_eval=False, device="cpu")
    half = xtt.train(DET, d, 5, verbose_eval=False, device="cpu")
    if form == "booster":
        model = half
    elif form == "ubj_bytes":
        model = half.save_raw("ubj")
    else:
        model = str(tmp_path / ("m." + form.split("_")[0]))
        half.save_model(model)
    # a fresh DMatrix: the continued booster's cache catches up first
    cont = xtt.train(DET, _dm(X, label=y), 5, verbose_eval=False,
                     device="cpu", xgb_model=model)
    assert cont.num_boosted_rounds() == 10
    assert half.num_boosted_rounds() == 5  # the Booster form is copied
    assert _json(cont) == _json(full)
    dr = xtb.DMatrix(X, label=y)
    ref = xtb.train(DET, dr, 5, verbose_eval=False,
                    xgb_model=xtb.train(DET, dr, 5, verbose_eval=False))
    assert _json(cont) == _json(ref)


def _squared(margin, dmat):
    return margin - dmat.get_label(), np.ones_like(margin)


def test_custom_objective_is_the_builtin_and_the_references():
    X, z = _data()
    params = dict(DET, objective="reg:squarederror", base_score=0.5)
    builtin = xtt.train(params, _dm(X, label=z), 4, verbose_eval=False,
                        device="cpu")
    custom = xtt.train(params, _dm(X, label=z), 4, verbose_eval=False,
                       device="cpu", obj=_squared)
    ref = xtb.train(params, xtb.DMatrix(X, label=z), 4, verbose_eval=False,
                    obj=_squared)
    assert _json(custom) == _json(builtin) == _json(ref)


def test_custom_objective_sees_class_margins():
    """With num_class the custom objective gets (R, K) margins and may
    return (R, K) pairs: the softmax gradient computed by hand grows the
    built-in objective's trees."""
    X, z = _data(R=600)
    y = np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    params = {"objective": "multi:softprob", "num_class": 3, "max_depth": 3,
              "max_bin": 16, "deterministic_histogram": 1}
    seen = []

    def softmax_obj(margin, dmat):
        seen.append(margin.shape)
        e = np.exp(margin - margin.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        onehot = np.eye(3, dtype=np.float32)[dmat.get_label().astype(int)]
        return p - onehot, np.maximum(2 * p * (1 - p), 1e-16)

    got = xtt.train(params, _dm(X, label=y), 2, verbose_eval=False,
                    device="cpu", obj=softmax_obj)
    ref = xtb.train(params, xtb.DMatrix(X, label=y), 2, verbose_eval=False,
                    obj=softmax_obj)
    assert seen == [(600, 3)] * 4  # two runs of two rounds
    assert _json(got) == _json(ref)


def test_boost_matches_update_and_reference():
    """boost() with the pairs a custom objective returned round by round
    grows the same model as update(), in both packages."""
    X, z = _data()
    params = dict(DET, objective="reg:squarederror", base_score=0.5)
    pairs = []

    def recorded(margin, dmat):
        pairs.append(_squared(margin, dmat))
        return pairs[-1]

    upd = xtt.train(params, _dm(X, label=z), 3, verbose_eval=False,
                    device="cpu", obj=recorded)
    d, dr = _dm(X, label=z), xtb.DMatrix(X, label=z)
    bst = xtt.Booster(params, cache=[d], device="cpu")
    ref = xtb.Booster(params, cache=[dr])
    for i, (g, h) in enumerate(pairs):
        bst.boost(d, g, h, i)
        ref.boost(dr, g, h, i)
    assert _json(bst) == _json(upd) == _json(ref)


def _mae(margin, dmat):
    return "mae", float(np.mean(np.abs(margin[:, 0] - dmat.get_label())))


def test_custom_metric_log_is_the_references():
    X, z = _data()
    params = dict(DET, objective="reg:squarederror", base_score=0.5)
    logs = []
    for pkg, kw in ((xtb, {}), (xtt, {"device": "cpu"})):
        d = pkg.DMatrix(X, label=z, **kw)
        log: dict = {}
        pkg.train(params, d, 3, evals=[(d, "train")], evals_result=log,
                  verbose_eval=False, custom_metric=_mae, **kw)
        logs.append(log)
    assert list(logs[1]["train"]) == ["rmse", "mae"]
    for m in ("rmse", "mae"):
        np.testing.assert_allclose(logs[1]["train"][m], logs[0]["train"][m],
                                   rtol=1e-6)


def test_early_stopping_watches_the_custom_metric():
    X, z = _data()
    params = dict(DET, objective="reg:squarederror", base_score=0.5,
                  eta=1.0, max_depth=6)
    dtr, dva = _dm(X[:1000], label=z[:1000]), _dm(X[1000:], label=z[1000:])
    log: dict = {}
    bst = xtt.train(params, dtr, 30, evals=[(dva, "valid")],
                    evals_result=log, early_stopping_rounds=2,
                    verbose_eval=False, device="cpu", custom_metric=_mae)
    mae = log["valid"]["mae"]
    assert bst.best_iteration == int(np.argmin(mae))
    assert len(mae) == bst.best_iteration + 3 < 30


@pytest.mark.parametrize("num_class", [0, 3])
def test_pred_leaf_is_the_references(num_class):
    X, z = _data(R=800)
    params = {"max_depth": 4, "max_bin": 32, "deterministic_histogram": 1}
    if num_class:
        params.update(objective="multi:softprob", num_class=num_class)
        y = np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    else:
        params["objective"] = "binary:logistic"
        y = (z > 0).astype(np.float32)
    got = xtt.train(params, _dm(X, label=y), 3, verbose_eval=False,
                    device="cpu")
    ref = xtb.train(params, xtb.DMatrix(X, label=y), 3, verbose_eval=False)
    leaves = got.predict(_dm(X), pred_leaf=True)
    assert leaves.dtype == np.int32
    assert leaves.shape == (800, 3 * max(num_class, 1))
    s, _, depth = ref._stacked(slice(0, len(ref.trees)))
    want = np.asarray(ref_leaf_ids(X, s["feat"], s["thr"], s["dleft"],
                                   s["left"], s["right"], depth=depth))
    np.testing.assert_array_equal(leaves, want)
    np.testing.assert_array_equal(
        leaves, ref.predict(xtb.DMatrix(X), pred_leaf=True))
    # one round's trees, and the empty range's (R, 0)
    tpr = max(num_class, 1)
    np.testing.assert_array_equal(
        got.predict(_dm(X), pred_leaf=True, iteration_range=(1, 2)),
        leaves[:, tpr: 2 * tpr])
    assert got.predict(_dm(X), pred_leaf=True,
                       iteration_range=(3, 3)).shape == (800, 0)
    # the leaves' values summed in tree order, from zero, then the base
    # margin: predict(output_margin=True)'s order, bit for bit
    margin = np.zeros((800, tpr), np.float32)
    for t, (tree, g) in enumerate(zip(got.trees, got.tree_info)):
        margin[:, g] += tree.split_conditions[leaves[:, t]]
    margin += got.base_score[None, :]
    want = got.predict(_dm(X), output_margin=True, strict_shape=True)
    np.testing.assert_array_equal(margin.view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("raw_format", ["json", "ubj"])
def test_save_raw_round_trips(raw_format):
    X, z = _data(R=600)
    y = (z > 0).astype(np.float32)
    got = xtt.train(DET, _dm(X, label=y), 3, verbose_eval=False,
                    device="cpu")
    raw = got.save_raw(raw_format)
    assert isinstance(raw, bytearray)
    back = xtt.Booster(device="cpu")
    back.load_model(raw)
    assert _json(back) == _json(got)
    np.testing.assert_array_equal(back.predict(_dm(X)), got.predict(_dm(X)))
    ref = xtb.Booster()
    ref.load_model(raw)
    np.testing.assert_array_equal(ref.predict(xtb.DMatrix(X)),
                                  got.predict(_dm(X)))
    if raw_format == "json":
        assert json.loads(bytes(raw)) == got.save_raw_dict()


def test_set_param_and_copy():
    X, z = _data(R=600)
    y = (z > 0).astype(np.float32)
    d = _dm(X, label=y)
    bst = xtt.train(DET, d, 2, verbose_eval=False, device="cpu")
    twin = bst.copy()
    bst.set_param({"eta": 0.1})
    bst.update(d, 2)
    assert bst.num_boosted_rounds() == 3 and twin.num_boosted_rounds() == 2
    assert twin.params["eta"] == 0.3 and bst.params["eta"] == 0.1
    np.testing.assert_array_equal(twin.base_score, bst.base_score)
    bst.set_param("max_depth", 2)
    bst.update(d, 3)
    assert bst.trees[-1].max_depth <= 2
