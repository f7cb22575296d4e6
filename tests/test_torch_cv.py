"""Port parity for cross-validation and the callbacks: cv's folds (the
reference's index sets, plain, stratified, shuffled or not, and given),
each fold's model under deterministic_histogram=1 byte-identical to the
reference's and the results dict equal exactly; DMatrix.slice;
LearningRateScheduler, TrainingCheckPoint, EarlyStopping (save_best,
min_delta, cv's (mean, std) scores, its state) and EvaluationMonitor's
show_stdv, held against xgboost_tpu on the same numpy input."""
import json
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu import training as ref_training
from xgboost_tpu_torch import training as port_training

DET = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 32,
       "eta": 0.3, "deterministic_histogram": 1}


def _data(R=480, F=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    z = (np.nan_to_num(X[:, 0]) + 0.7 * np.nan_to_num(X[:, 1])
         * (X[:, 2] > 0) + 0.3 * rng.normal(size=R)).astype(np.float32)
    return X, z


def _json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _both(X, **kw):
    return xtb.DMatrix(X, **kw), xtt.DMatrix(X, device="cpu", **kw)


FOLDINGS = {
    "plain": dict(stratified=False, shuffle=False),
    "shuffled": dict(stratified=False, shuffle=True),
    "stratified": dict(stratified=True, shuffle=False),
    "stratified_shuffled": dict(stratified=True, shuffle=True),
}


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("folding", sorted(FOLDINGS) + ["given"])
def test_folds_are_the_references(folding, seed):
    X, z = _data(R=97)
    X[:, 4] = np.arange(97)  # a row's id, to read the index sets back
    y = np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    dr, dp = _both(X, label=y)
    folds = None
    kw = dict(stratified=False, shuffle=True)
    if folding == "given":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(97)
        folds = [(np.setdiff1d(np.arange(97), perm[k::4]), perm[k::4])
                 for k in range(4)]
    else:
        kw = FOLDINGS[folding]
    nfold = 4
    ref = ref_training._make_folds(dr, nfold, DET, seed, kw["shuffle"],
                                   kw["stratified"], folds)
    port = port_training._make_folds(dp, nfold, DET, seed, kw["shuffle"],
                                     kw["stratified"], folds, "cpu")
    assert len(ref) == len(port) == nfold
    for a, b in zip(ref, port):
        for da, db in ((a.dtrain, b.dtrain), (a.dtest, b.dtest)):
            ids_a = da.host_dense()[:, 4]
            ids_b = db.host_dense()[:, 4]
            assert np.array_equal(ids_a, ids_b)
            assert np.array_equal(da.get_label(), db.get_label())
        assert b.bst.device.type == "cpu"
    # every row in exactly one test fold
    test_ids = np.sort(np.concatenate([p.dtest.host_dense()[:, 4]
                                       for p in port]))
    assert np.array_equal(test_ids, np.arange(97))


class _Packs:
    """Records the port's folds (the model cv hands the callbacks)."""

    def before_training(self, model):
        self.packs = model.packs
        return model

    def after_training(self, model):
        return model

    def before_iteration(self, model, epoch, evals_log):
        return False

    def after_iteration(self, model, epoch, evals_log):
        return False


@pytest.mark.parametrize("params,folding", [
    (dict(DET, eval_metric=["logloss", "auc"]), "shuffled"),
    (dict(DET, subsample=0.8, seed=3, colsample_bynode=0.8), "stratified"),
    (dict(DET, objective="reg:squarederror"), "plain"),
])
def test_cv_folds_and_results_are_the_references(params, folding):
    X, z = _data()
    y = z if params["objective"].startswith("reg") else \
        (z > 0).astype(np.float32)
    dr, dp = _both(X, label=y)
    kw = FOLDINGS[folding]
    rounds = 4
    rec = _Packs()
    got = xtt.cv(params, dp, rounds, nfold=3, seed=2, as_pandas=False,
                 callbacks=[rec], device="cpu", **kw)
    want = xtb.cv(params, dr, rounds, nfold=3, seed=2, as_pandas=False, **kw)
    assert got == want
    # the reference's own fold loop, in its order
    packs = ref_training._make_folds(dr, 3, params, 2, kw["shuffle"],
                                     kw["stratified"], None)
    for i in range(rounds):
        for p in packs:
            p.update(i, None)
    assert [_json(p.bst) for p in rec.packs] == \
        [_json(p.bst) for p in packs]


def test_cv_metrics_argument_and_custom_metric():
    X, z = _data()
    y = (z > 0).astype(np.float32)
    dr, dp = _both(X, label=y)

    def mae(margin, dmat):
        return "mae", float(np.mean(np.abs(margin[:, 0] - dmat.get_label())))

    for metrics in (("auc",), ("error", "logloss")):
        got = xtt.cv(DET, dp, 2, nfold=2, metrics=metrics, as_pandas=False,
                     custom_metric=mae, device="cpu")
        want = xtb.cv(DET, dr, 2, nfold=2, metrics=metrics, as_pandas=False,
                      custom_metric=mae)
        assert got == want
        assert "test-mae-mean" in got


def test_cv_as_pandas_is_the_references_frame():
    pd = pytest.importorskip("pandas")
    X, z = _data()
    dr, dp = _both(X, label=z)
    got = xtt.cv(dict(DET, objective="reg:squarederror"), dp, 2, nfold=3,
                 device="cpu")
    want = xtb.cv(dict(DET, objective="reg:squarederror"), dr, 2, nfold=3)
    assert isinstance(got, pd.DataFrame)
    assert got.equals(want)


def test_cv_as_pandas_returns_the_dict_without_pandas(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pandas(name, *a, **kw):
        if name == "pandas":
            raise ImportError("no pandas here")
        return real(name, *a, **kw)

    X, z = _data(R=200)
    dp = xtt.DMatrix(X, label=z, device="cpu")
    monkeypatch.setattr(builtins, "__import__", no_pandas)
    got = xtt.cv(dict(DET, objective="reg:squarederror"), dp, 2, nfold=2,
                 device="cpu")
    assert isinstance(got, dict) and len(got["test-rmse-mean"]) == 2


@pytest.mark.parametrize("early", [1, 2])
def test_cv_early_stopping_is_the_references(early):
    X, z = _data(R=300, seed=4)
    y = (z + np.random.default_rng(9).normal(size=300) > 0).astype(
        np.float32)
    dr, dp = _both(X, label=y)
    params = dict(DET, max_depth=5, eta=1.0)
    got = xtt.cv(params, dp, 25, nfold=3, early_stopping_rounds=early,
                 as_pandas=False, device="cpu")
    want = xtb.cv(params, dr, 25, nfold=3, early_stopping_rounds=early,
                  as_pandas=False)
    assert got == want
    assert len(got["test-logloss-mean"]) < 25  # it stopped


def test_cv_verbose_lines_with_stdv_are_the_references():
    X, z = _data(R=200)
    dr, dp = _both(X, label=z > 0)
    lines = {"port": [], "ref": []}
    xtt.cv(DET, dp, 3, nfold=2, as_pandas=False, device="cpu",
           callbacks=[xtt.EvaluationMonitor(show_stdv=True,
                                            logger=lines["port"].append)])
    xtb.cv(DET, dr, 3, nfold=2, as_pandas=False,
           callbacks=[xtb.EvaluationMonitor(show_stdv=True,
                                            logger=lines["ref"].append)])
    assert lines["port"] == lines["ref"]
    assert "+" in lines["port"][0]


def _slice_source(kind):
    rng = np.random.default_rng(3)
    R, F = 60, 4
    X, z = _data(R=R, F=F, seed=3)
    kw = dict(label=z, weight=rng.random(R).astype(np.float32) + 0.5,
              base_margin=rng.normal(size=R).astype(np.float32),
              feature_names=[f"c{i}" for i in range(F)],
              feature_types=["q"] * F,
              feature_weights=np.arange(1, F + 1, dtype=np.float32))
    if kind == "groups":
        kw["qid"] = np.repeat(np.arange(12), 5)
    if kind == "bounds":
        kw["label_lower_bound"] = np.abs(z)
        kw["label_upper_bound"] = np.where(z > 0, np.inf, np.abs(z) + 1)
    if kind == "csr":
        X = sp.csr_matrix(np.where(np.abs(np.nan_to_num(X)) < 0.5, 0,
                                   np.nan_to_num(X)))
    if kind == "multi":
        kw["label"] = np.stack([z, -z], axis=1)
        kw["base_margin"] = rng.normal(size=(R, 2)).astype(np.float32)
    return X, kw


@pytest.mark.parametrize("kind", ["dense", "groups", "bounds", "csr",
                                  "multi"])
def test_slice_is_the_references(kind):
    X, kw = _slice_source(kind)
    dr, dp = _both(X, **kw)
    idx = np.array([3, 4, 5, 11, 12, 30, 31, 32, 33, 59])
    a, b = dr.slice(idx), dp.slice(idx)
    assert b.device == dp.device
    assert np.array_equal(a.host_dense(), b.host_dense(), equal_nan=True)
    assert np.array_equal(a.get_label(), b.get_label())
    assert np.array_equal(a.get_weight(), b.get_weight())
    assert np.array_equal(a.info.base_margin, b.base_margin)
    for name in ("label_lower_bound", "label_upper_bound", "group_ptr"):
        want = getattr(a.info, name)
        got = getattr(b, name)
        assert (want is None and got is None) or np.array_equal(want, got)
    assert np.array_equal(a.info.feature_weights, b.feature_weights)
    assert a.feature_names == b.feature_names
    assert a.feature_types == b.feature_types
    if kind == "groups":  # rows 3-5, 11-12, 30-33, 59: five groups
        assert b.group_ptr.tolist() == [0, 2, 3, 5, 9, 10]


def test_slice_keeps_a_weight_a_group_with_its_group():
    X, kw = _slice_source("groups")
    del kw["weight"]
    d = xtt.DMatrix(X, device="cpu", **kw)
    d.set_weight(np.arange(1, 13, dtype=np.float32))  # one a group
    s = d.slice(np.array([3, 4, 5, 11, 12, 30, 31, 59]))
    assert s.group_ptr.tolist() == [0, 2, 3, 5, 7, 8]
    assert s.get_weight().tolist() == [1.0, 2.0, 3.0, 7.0, 12.0]


def test_slice_carries_the_frames_categories():
    """A sliced frame keeps its category values, so that a model trained on
    the slice recodes another frame's codes as one trained on the whole."""
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(2)
    R = 300
    colour = rng.choice(["red", "green", "blue", "grey"], size=R)
    frame = pd.DataFrame({"x": rng.normal(size=R).astype(np.float32),
                          "colour": pd.Categorical(colour)})
    y = ((colour == "red") | (frame["x"].to_numpy() > 1)).astype(np.float32)
    d = xtt.DMatrix(frame, label=y, device="cpu")
    s = d.slice(np.arange(0, R, 2))
    assert s.cat_categories == d.cat_categories
    assert s.get_categories() == d.get_categories()
    params = dict(DET, max_bin=8)
    bst = xtt.train(params, s, 3, verbose_eval=False, device="cpu")
    recoded = pd.DataFrame({"x": frame["x"], "colour": pd.Categorical(
        colour, categories=["grey", "red", "blue", "green"])})
    assert np.array_equal(
        bst.predict(xtt.DMatrix(recoded, device="cpu")),
        bst.predict(xtt.DMatrix(frame, device="cpu")))


def test_constant_learning_rate_scheduler_is_no_scheduler():
    X, z = _data()
    dp = xtt.DMatrix(X, label=z > 0, device="cpu")
    plain = xtt.train(DET, dp, 4, verbose_eval=False, device="cpu")
    sched = xtt.train(DET, dp, 4, verbose_eval=False, device="cpu",
                      callbacks=[xtt.LearningRateScheduler([0.3] * 4)])
    assert _json(sched) == _json(plain)


@pytest.mark.parametrize("rates", ["list", "function"])
def test_learning_rate_schedule_is_the_references(rates):
    X, z = _data()
    dr, dp = _both(X, label=z > 0)
    sched = [0.5, 0.3, 0.2, 0.1, 0.05] if rates == "list" else \
        (lambda epoch: 0.4 * 0.7 ** epoch)
    got = xtt.train(DET, dp, 5, verbose_eval=False, device="cpu",
                    callbacks=[xtt.LearningRateScheduler(sched)])
    want = xtb.train(DET, dr, 5, verbose_eval=False,
                     callbacks=[xtb.LearningRateScheduler(sched)])
    assert _json(got) == _json(want)
    res_p = xtt.cv(DET, dp, 3, nfold=2, as_pandas=False, device="cpu",
                   callbacks=[xtt.LearningRateScheduler(sched)])
    res_r = xtb.cv(DET, dr, 3, nfold=2, as_pandas=False,
                   callbacks=[xtb.LearningRateScheduler(sched)])
    assert res_p == res_r


@pytest.mark.parametrize("as_pickle", [False, True])
def test_training_checkpoints_reload_to_the_same_model(tmp_path, as_pickle):
    X, z = _data()
    dr, dp = _both(X, label=z > 0)
    cb = xtt.TrainingCheckPoint(tmp_path / "port", name="m",
                                as_pickle=as_pickle, interval=2)
    bst = xtt.train(DET, dp, 5, verbose_eval=False, device="cpu",
                    callbacks=[cb])
    files = sorted(os.listdir(tmp_path / "port"))
    ext = "pkl" if as_pickle else "json"
    assert files == [f"m_{i}.{ext}" for i in (0, 2, 4)]
    for i in (0, 2, 4):
        path = tmp_path / "port" / f"m_{i}.{ext}"
        if as_pickle:
            with open(path, "rb") as fh:
                back = pickle.load(fh)
        else:
            back = xtt.Booster(model_file=path, device="cpu")
        assert _json(back) == _json(bst[: i + 1])
        assert np.array_equal(back.predict(dp), bst[: i + 1].predict(dp))
    if not as_pickle:
        xtb.train(DET, dr, 5, verbose_eval=False, callbacks=[
            xtb.TrainingCheckPoint(str(tmp_path / "ref"), name="m",
                                   interval=2)])
        for i in (0, 2, 4):
            with open(tmp_path / "ref" / f"m_{i}.json") as fh:
                want = json.load(fh)
            with open(tmp_path / "port" / f"m_{i}.json") as fh:
                assert json.load(fh) == want


@pytest.mark.parametrize("save_best,min_delta", [(False, 0.0), (True, 0.0),
                                                 (True, 0.002),
                                                 (False, 0.01)])
def test_early_stopping_is_the_references(save_best, min_delta):
    X, z = _data(R=400, seed=6)
    y = (z + np.random.default_rng(8).normal(size=400) > 0).astype(
        np.float32)
    Xv, zv = _data(R=200, seed=7)
    yv = (zv > 0).astype(np.float32)
    dr, dp = _both(X, label=y)
    vr, vp = _both(Xv, label=yv)
    params = dict(DET, max_depth=5, eta=0.6)
    out = {}
    for name, pkg, d, v in (("port", xtt, dp, vp), ("ref", xtb, dr, vr)):
        res: dict = {}
        es = pkg.EarlyStopping(rounds=3, save_best=save_best,
                               min_delta=min_delta)
        kw = {"device": "cpu"} if pkg is xtt else {}
        bst = pkg.train(params, d, 40, evals=[(v, "valid")],
                        evals_result=res, verbose_eval=False,
                        callbacks=[es], **kw)
        out[name] = (bst, res, es)
    (bp, rp, ep), (br, rr, er) = out["port"], out["ref"]
    assert rp == rr
    assert bp.best_iteration == br.best_iteration
    assert bp.num_boosted_rounds() == br.num_boosted_rounds()
    assert _json(bp) == _json(br)
    assert ep.state_dict() == er.state_dict()
    if save_best:
        assert bp.num_boosted_rounds() == bp.best_iteration + 1
    else:
        assert bp.num_boosted_rounds() < 40


def test_early_stopping_state_round_trip():
    es = xtt.EarlyStopping(rounds=2)
    es.best_scores, es.current_rounds = [0.5, 0.4], 1
    back = xtt.EarlyStopping(rounds=2)
    back.load_state(json.loads(json.dumps(es.state_dict())))
    assert back.best_scores == [0.5, 0.4] and back.current_rounds == 1
    assert xtt.TrainingCallback().state_dict() is None


@pytest.mark.parametrize("metric,want", [
    ("auc", True), ("ndcg@5", True), ("map@3-", True), ("auc:extra", True),
    ("pre@2:x", True), ("logloss", False), ("rmse:x", False)])
def test_early_stopping_maximises_as_the_reference(metric, want):
    assert xtt.EarlyStopping(1)._is_maximize(metric) is want
    assert xtb.EarlyStopping(1)._is_maximize(metric) is want


def test_early_stopping_on_cv_means():
    """A (mean, std) score stops on the mean; save_best never slices cv's
    model."""
    class Packed:
        _is_cv = True
        best_iteration = None

        def set_attr(self, **kw):
            pass

    es = xtt.EarlyStopping(rounds=1, save_best=True)
    m = Packed()
    log = {"test": {"rmse": [(0.5, 0.1)]}}
    assert not es.after_iteration(m, 0, log)
    log["test"]["rmse"].append((0.6, 0.0))
    assert es.after_iteration(m, 1, log)
    assert m.best_iteration == 0 and m.best_score == 0.5
    assert es.after_training(m) is m


def test_evaluation_monitor_period_and_stdv():
    lines = []
    mon = xtt.EvaluationMonitor(period=2, show_stdv=False,
                                logger=lines.append)
    log = {"test": {"rmse": [(0.123456, 0.01)]}}
    for epoch in range(3):
        mon.after_iteration(None, epoch, log)
    mon.after_training(None)
    assert lines == ["[0]\ttest-rmse:0.12346", "[2]\ttest-rmse:0.12346"]
    ref_lines = []
    ref = xtb.EvaluationMonitor(period=2, logger=ref_lines.append)
    for epoch in range(3):
        ref.after_iteration(None, epoch, log)
    ref.after_training(None)
    assert lines == ref_lines
