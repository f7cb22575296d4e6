"""Port parity for the Booster's configuration and model surface:
``save_config``/``load_config`` (the reference's layout, string values),
``serialize``/``unserialize`` across the two packages, pickling, round
slicing, ``get_score``, ``inplace_predict``, ``get_dump(fmap=)``, the
device grammar and the global config, held against xgboost_tpu on the same
numpy input.  Under deterministic_histogram=1 a continuation after a
round trip through either package's buffer is byte-identical to the
uninterrupted run."""
import json
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu_torch.context import DeviceOrd
from xgboost_tpu_torch.convert import booster_to_dict
from xgboost_tpu_torch.params import TrainParam, reject_unsupported
from xgboost_tpu_torch.utils.device import resolve_device

DET = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 32,
       "eta": 0.3, "deterministic_histogram": 1, "device": "cpu"}


def _data(R=600, F=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    z = (np.nan_to_num(X[:, 0]) + 0.7 * np.nan_to_num(X[:, 1])
         * (X[:, 2] > 0) + 0.3 * rng.normal(size=R)).astype(np.float32)
    return X, z


def _json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


# (params, label kind): each reader of a string-valued parameter that
# load_config hands back, one case each
CASES = {
    "binary": (dict(DET, eval_metric=["logloss", "auc"]), "binary"),
    "constraints": (dict(DET, monotone_constraints=(1, 0, -1, 0, 0),
                         interaction_constraints=[[0, 1], [2, 3, 4]]),
                    "binary"),
    "sampling": (dict(DET, seed=7, subsample=0.8, colsample_bynode=0.8,
                      num_parallel_tree=2), "binary"),
    "multiclass": (dict(DET, objective="multi:softprob", num_class=3),
                   "class"),
    "quantile": (dict(DET, objective="reg:quantileerror",
                      quantile_alpha=[0.2, 0.5, 0.8]), "reg"),
    "n_devices": (dict(DET, n_devices=1, tree_method="hist"), "binary"),
}


def _labels(z, kind):
    if kind == "binary":
        return (z > 0).astype(np.float32)
    if kind == "class":
        return np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    return z


def _pair(name, rounds):
    params, kind = CASES[name]
    X, z = _data()
    y = _labels(z, kind)
    dr = xtb.DMatrix(X, label=y)
    dp = xtt.DMatrix(X, label=y, device="cpu")
    ref = xtb.train(params, dr, rounds, verbose_eval=False)
    port = xtt.train(params, dp, rounds, verbose_eval=False)
    return params, X, y, dr, dp, ref, port


# the reference cannot load these configurations of its own: its
# _configure takes n_devices as an int only, and its quantile objective
# cannot parse quantile_alpha's string (ROADMAP Queue 3)
REF_CANNOT_LOAD = {"n_devices", "quantile"}


def _sections(config: str) -> dict:
    """A configuration without the model's state (learner_model_param)."""
    c = json.loads(config)
    del c["learner"]["learner_model_param"]
    return c


def _without_device(config: str) -> dict:
    c = json.loads(config)
    dev = c["learner"]["generic_param"].pop("device")
    return c, dev


@pytest.mark.parametrize("name", sorted(CASES))
def test_save_config_is_the_references_but_for_the_device(name):
    params, X, y, dr, dp, ref, port = _pair(name, 3)
    want = ref.save_config()
    got = port.save_config()
    assert json.loads(got)["learner"]["generic_param"]["device"] == "cpu"
    # the same parameters write the same text, the device included
    assert got == want
    bare = {k: v for k, v in params.items() if k != "device"}
    ref2 = xtb.train(bare, dr, 3, verbose_eval=False)
    port2 = xtt.train(bare, dp, 3, verbose_eval=False, device="cpu")
    c_ref, d_ref = _without_device(ref2.save_config())
    c_port, d_port = _without_device(port2.save_config())
    assert (d_ref, d_port) == ("tpu", "cpu")
    assert c_port == c_ref


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_packages_config_loads_into_the_other(name):
    params, X, y, dr, dp, ref, port = _pair(name, 2)
    into_port = xtt.Booster(device="cpu")
    into_port.load_config(ref.save_config())
    # a loaded parameter set writes the configuration it was read from
    assert _sections(into_port.save_config()) == _sections(ref.save_config())
    assert into_port.device == torch.device("cpu")
    again = xtt.Booster(device="cpu")
    again.load_config(port.save_config())
    assert again.params == into_port.params
    if name in REF_CANNOT_LOAD:
        return
    into_ref = xtb.Booster()
    into_ref.load_config(port.save_config())
    assert into_port.params == into_ref.params
    assert _sections(into_ref.save_config()) == _sections(ref.save_config())


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_serialize_continuation_is_byte_identical(name, direction):
    """3 rounds, serialize, a fresh booster of the other package, 3 more
    rounds with no parameters but the restored ones (strings): the
    uninterrupted 6 rounds' JSON, byte for byte, in both packages."""
    params, X, y, dr, dp, ref, port = _pair(name, 3)
    full = _json(xtb.train(params, dr, 6, verbose_eval=False))
    assert _json(xtt.train(params, dp, 6, verbose_eval=False)) == full
    if direction == "ref_to_port":
        restored = xtt.Booster(device="cpu")
        restored.unserialize(ref.serialize())
        cont = xtt.train({}, dp, 3, verbose_eval=False, xgb_model=restored)
    elif name in REF_CANNOT_LOAD:
        # the port's own buffer, then
        restored = xtt.Booster(device="cpu")
        restored.unserialize(port.serialize())
        cont = xtt.train({}, dp, 3, verbose_eval=False, xgb_model=restored)
    else:
        restored = xtb.Booster()
        restored.unserialize(port.serialize())
        cont = xtb.train({}, dr, 3, verbose_eval=False, xgb_model=restored)
    # the restored parameters are the configuration's strings (num_class
    # is also the model's, an int)
    for key, v in params.items():
        if key in ("eval_metric", "device", "num_class"):
            continue
        assert isinstance(restored.params[key], str), key
    assert _json(cont) == full


def test_eval_metric_list_survives_the_config():
    params, X, y, dr, dp, ref, port = _pair("binary", 2)
    b = xtt.Booster(device="cpu")
    b.unserialize(port.serialize())
    assert b.params["eval_metric"] == ["logloss", "auc"]
    assert b.eval_set([(dp, "train")], 1) == ref.eval_set([(dr, "train")], 1)


def test_train_param_reads_the_configs_strings():
    """monotone and interaction constraints, refresh_leaf and the ints as
    load_config gives them."""
    p = TrainParam.from_dict({"monotone_constraints": "[1, 0, -1]",
                              "interaction_constraints": "[[0, 1], [2]]",
                              "refresh_leaf": "0", "max_depth": "4",
                              "eta": "0.1"})
    assert p.monotone_constraints == (1, 0, -1)
    assert p.interaction_constraints == ((0, 1), (2,))
    assert p.refresh_leaf is False and p.max_depth == 4 and p.eta == 0.1


@pytest.mark.parametrize("params", [{"n_devices": "1"}, {"n_devices": 1},
                                    {"tree_method": "hist"},
                                    {"tree_method": "auto"},
                                    {"booster": "gbtree"},
                                    {"process_type": "default"}])
def test_unsupported_keys_compare_parsed_defaults(params):
    reject_unsupported(params)


@pytest.mark.parametrize("params", [{"n_devices": "2"}, {"n_devices": True},
                                    {"tree_method": "approx"}])
def test_unsupported_values_still_raise(params):
    with pytest.raises(NotImplementedError):
        reject_unsupported(params)


def test_lockstep_does_not_survive_a_config_round_trip():
    """Leading-underscore keys are outside the known keys, in both
    packages."""
    params = dict(CASES["multiclass"][0], _lockstep=1)
    X, z = _data()
    y = _labels(z, "class")
    port = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), 1,
                     verbose_eval=False)
    ref = xtb.train(params, xtb.DMatrix(X, label=y), 1, verbose_eval=False)
    b = xtt.Booster(device="cpu")
    b.unserialize(port.serialize())
    r = xtb.Booster()
    r.unserialize(ref.serialize())
    assert "_lockstep" not in b.params and "_lockstep" not in r.params


@pytest.mark.parametrize("name", ["binary", "multiclass"])
def test_pickle_round_trip_predicts_identically(name):
    params, X, y, dr, dp, ref, port = _pair(name, 3)
    port.eval_set([(dp, "train")])  # a cache with tensors
    state = port.__getstate__()
    assert set(state) == {"raw", "device"}
    assert isinstance(state["raw"], bytes) and state["device"] == "cpu"
    back = pickle.loads(pickle.dumps(port))
    assert back.device == torch.device("cpu") and not back._caches
    assert np.array_equal(back.predict(dp), port.predict(dp))
    assert _json(back) == _json(port)


def test_pickle_keeps_early_stoppings_best():
    X, z = _data()
    dp = xtt.DMatrix(X, label=z > 0, device="cpu")
    bst = xtt.train(DET, dp, 30, evals=[(dp, "train")],
                    early_stopping_rounds=2, verbose_eval=False)
    back = pickle.loads(pickle.dumps(bst))
    assert back.best_iteration == bst.best_iteration
    assert back.best_score == pytest.approx(bst.best_score)


def test_card_pickle_raises_without_a_card_naming_the_cpu_route(monkeypatch):
    params, X, y, dr, dp, ref, port = _pair("binary", 2)
    state = dict(port.__getstate__(), device="cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blank = xtt.Booster.__new__(xtt.Booster)
    with pytest.raises(RuntimeError,
                       match=r'Booster\(device="cpu"\)\.unserialize'):
        blank.__setstate__(state)
    # the CPU route restores the same model
    b = xtt.Booster(device="cpu")
    b.unserialize(state["raw"])
    assert _json(b) == _json(port)


@pytest.mark.parametrize("name", ["binary", "sampling", "multiclass"])
@pytest.mark.parametrize("lo,hi", [(0, 2), (1, 3), (2, 5), (3, None),
                                   (None, 4)])
def test_slice_is_the_references_and_the_iteration_range(name, lo, hi):
    params, X, y, dr, dp, ref, port = _pair(name, 5)
    got = port[lo:hi]
    assert _json(got) == _json(ref[lo:hi])
    a, b = lo or 0, 5 if hi is None else hi
    assert got.num_boosted_rounds() == b - a
    want = port.predict(dp, output_margin=True, iteration_range=(a, b))
    assert np.array_equal(got.predict(dp, output_margin=True), want)
    assert np.array_equal(ref[lo:hi].predict(dr, output_margin=True), want)


def test_copy_is_the_whole_slice():
    params, X, y, dr, dp, ref, port = _pair("sampling", 4)
    c = port.copy()
    assert _json(c) == _json(port[0:4]) == _json(port)
    assert c.trees is not port.trees


def test_slice_takes_no_step_and_no_index():
    params, X, y, dr, dp, ref, port = _pair("binary", 3)
    with pytest.raises(ValueError):
        port[0:3:2]
    with pytest.raises(TypeError):
        port[1]


IMPORTANCE = ["weight", "gain", "cover", "total_gain", "total_cover"]


@pytest.mark.parametrize("importance_type", IMPORTANCE)
@pytest.mark.parametrize("name", ["binary", "multiclass", "quantile"])
def test_get_score_is_the_references(name, importance_type):
    params, X, y, dr, dp, ref, port = _pair(name, 3)
    assert port.get_score(importance_type=importance_type) == \
        ref.get_score(importance_type=importance_type)


@pytest.mark.parametrize("importance_type", IMPORTANCE)
def test_get_score_of_vector_leaves_is_the_references(importance_type):
    """The same vector-leaf model in both packages (grown by the port,
    loaded into the reference) scores the same, to the last bit."""
    X, z = _data()
    Y = np.stack([z, np.nan_to_num(X[:, 3]), -z], axis=1).astype(np.float32)
    port = xtt.train({"multi_strategy": "multi_output_tree", "max_depth": 3,
                      "max_bin": 32, "num_target": 3},
                     xtt.DMatrix(X, label=Y, device="cpu"), 3,
                     verbose_eval=False, device="cpu")
    ref = xtb.Booster()
    ref.load_model_dict(booster_to_dict(port))
    got = port.get_score(importance_type=importance_type)
    assert got and got == ref.get_score(importance_type=importance_type)


def test_get_score_names_features_and_refuses_unknown_types():
    params, X, y, dr, dp, ref, port = _pair("binary", 2)
    names = [f"col {i}" for i in range(X.shape[1])]
    bst = xtt.train(DET, xtt.DMatrix(X, label=y, feature_names=names,
                                     device="cpu"), 2, verbose_eval=False)
    assert set(bst.get_score()) <= set(names)
    with pytest.raises(ValueError):
        bst.get_score(importance_type="frequency")


def _inputs(X):
    csr = sp.csr_matrix(np.nan_to_num(X))
    return {"numpy": X, "csr": csr, "tensor": torch.from_numpy(X)}


@pytest.mark.parametrize("kind", ["numpy", "csr", "tensor"])
@pytest.mark.parametrize("name", ["binary", "multiclass"])
def test_inplace_predict_is_predict_bit_for_bit(name, kind):
    params, X, y, dr, dp, ref, port = _pair(name, 4)
    data = _inputs(X)[kind]
    dm = xtt.DMatrix(data, device="cpu")
    for pt, om in (("value", False), ("margin", True)):
        got = port.inplace_predict(data, predict_type=pt)
        want = port.predict(dm, output_margin=om)
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert np.array_equal(
            got, ref.inplace_predict(X if kind != "csr" else data,
                                     predict_type=pt))
    rng = np.random.default_rng(1)
    bm = rng.normal(size=(X.shape[0],) if name == "binary"
                    else (X.shape[0], 3)).astype(np.float32)
    got = port.inplace_predict(data, base_margin=bm, iteration_range=(1, 3))
    dm.set_base_margin(bm)
    assert np.array_equal(got, port.predict(dm, iteration_range=(1, 3)))


def test_inplace_predict_takes_the_missing_value_and_refuses_types():
    params, X, y, dr, dp, ref, port = _pair("binary", 2)
    Xm = np.where(np.isnan(X), -999.0, X).astype(np.float32)
    assert np.array_equal(port.inplace_predict(Xm, missing=-999.0),
                          port.predict(dp))
    with pytest.raises(ValueError):
        port.inplace_predict(X, predict_type="leaf")


@pytest.mark.parametrize("dump_format", ["text", "json"])
@pytest.mark.parametrize("with_stats", [False, True])
def test_get_dump_with_a_feature_map_is_the_references(tmp_path, dump_format,
                                                      with_stats):
    params, X, y, dr, dp, ref, port = _pair("binary", 3)
    fmap = tmp_path / "featmap.txt"
    # tab-separated, a name with a space, a feature left unnamed, an id
    # past the matrix's width
    fmap.write_text("0\tage in years\tq\n2\tincome\tq\n6\textra\ti\n")
    got = port.get_dump(fmap=str(fmap), with_stats=with_stats,
                        dump_format=dump_format)
    want = ref.get_dump(fmap=str(fmap), with_stats=with_stats,
                        dump_format=dump_format)
    assert got == want
    assert any("age in years" in t for t in got)
    assert port.get_dump(with_stats=with_stats, dump_format=dump_format) == \
        ref.get_dump(with_stats=with_stats, dump_format=dump_format)


@pytest.mark.parametrize("spec,want", [
    ("cpu", DeviceOrd("cpu", None)), ("tpu", DeviceOrd("cuda", None)),
    ("gpu", DeviceOrd("cuda", None)), ("cuda", DeviceOrd("cuda", None)),
    ("cuda:1", DeviceOrd("cuda", 1)), ("tpu:0", DeviceOrd("cuda", 0)),
    ("GPU:2", DeviceOrd("cuda", 2)), (" cpu ", DeviceOrd("cpu", None))])
def test_device_grammar(spec, want):
    d = DeviceOrd.parse(spec)
    assert d == want
    assert d.torch_device() == (torch.device(want.type) if want.ordinal is None
                                else torch.device(want.type, want.ordinal))


@pytest.mark.parametrize("spec", ["xpu", "cuda:", "cuda:-1", "sycl:0", ""])
def test_device_grammar_refuses(spec):
    with pytest.raises(ValueError):
        DeviceOrd.parse(spec)


def test_the_default_without_a_card_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in (None, "gpu", "tpu", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xtt.Booster({"device": "tpu"})
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("spec,want", [("gpu", torch.device("cuda")),
                                       ("tpu", torch.device("cuda")),
                                       ("cuda:0", torch.device("cuda", 0))])
def test_accelerator_spellings_reach_the_card(monkeypatch, spec, want):
    """With a card (faked: no tensor is made), the reference's spellings
    land on cuda; an ordinal past the cards is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert xtt.Booster({"device": spec}).device == want
    assert xtt.Booster({"device": spec}, device="cpu").device == \
        torch.device("cpu")
    with pytest.raises(ValueError, match="does not exist"):
        resolve_device("cuda:1")


def test_a_references_tpu_config_lands_on_the_card(monkeypatch):
    params, X, y, dr, dp, ref, port = _pair("binary", 1)
    bare = {k: v for k, v in DET.items() if k != "device"}
    config = xtb.train(bare, dr, 1, verbose_eval=False).save_config()
    assert '"device": "tpu"' in config
    b = xtt.Booster(device="cpu")
    b.load_config(config)
    assert b.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    c = xtt.Booster({"device": "cpu"})
    c.load_config(config)
    assert c.device == torch.device("cuda")


def test_validate_parameters_refuses_unknown_keys_as_the_reference():
    X, z = _data(R=64)
    params = dict(DET, validate_parameters=1, colsample_by_tree=0.5)
    with pytest.raises(ValueError, match="colsample_by_tree"):
        xtt.train(params, xtt.DMatrix(X, label=z > 0, device="cpu"), 1,
                  verbose_eval=False)
    with pytest.raises(ValueError, match="colsample_by_tree"):
        xtb.train(params, xtb.DMatrix(X, label=z > 0), 1, verbose_eval=False)
    ok = dict(params, _lockstep=0)
    del ok["colsample_by_tree"]
    xtt.train(ok, xtt.DMatrix(X, label=z > 0, device="cpu"), 1,
              verbose_eval=False)


def test_disable_default_eval_metric_as_the_reference():
    params, X, y, dr, dp, ref, port = _pair("binary", 1)
    p = dict(DET, disable_default_eval_metric=1)
    got = xtt.train(p, dp, 1, verbose_eval=False).eval_set([(dp, "d")])
    want = xtb.train(p, dr, 1, verbose_eval=False).eval_set([(dr, "d")])
    assert got == want == "[0]"


def test_global_config_is_the_references_and_thread_local():
    import threading

    assert xtt.get_config() == xtb.get_config()
    with xtt.config_context(verbosity=0):
        assert xtt.get_config()["verbosity"] == 0
        seen = []
        t = threading.Thread(
            target=lambda: seen.append(xtt.get_config()["verbosity"]))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen == [1]
    assert xtt.get_config()["verbosity"] == 1
    with pytest.raises(ValueError):
        xtt.set_config(no_such_key=1)
