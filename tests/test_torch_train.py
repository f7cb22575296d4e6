"""Port parity end to end: xgboost_tpu_torch trains, saves, loads and
predicts like xgboost_tpu on the same numpy input, models cross-load between
the two packages, and the port imports neither JAX nor the reference."""
import ast
import json
import os

import numpy as np
import pytest
import torch  # noqa: F401  (read by the skipif condition strings)

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu import metric as ref_metric
from xgboost_tpu_torch import metric
from xgboost_tpu_torch.convert import booster_from_dict, booster_to_dict

HERE = os.path.dirname(os.path.abspath(__file__))
PORT = os.path.join(os.path.dirname(HERE), "xgboost_tpu_torch")


def _data(R=1500, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    z = np.nan_to_num(X[:, 0]) + 0.8 * np.nan_to_num(X[:, 1]) * (X[:, 2] > 0)
    return X, z


def _port_dm(X, **kw):
    return xtt.DMatrix(X, device="cpu", **kw)


@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_train_matches_reference(objective):
    X, z = _data()
    y = (z > 0).astype(np.float32) if objective == "binary:logistic" else z
    params = {"objective": objective, "max_depth": 4, "max_bin": 32,
              "eta": 0.3, "eval_metric": ["rmse", "logloss"]
              if objective == "binary:logistic" else ["rmse"]}
    ref_log, log = {}, {}
    ref = xtb.train(params, xtb.DMatrix(X, label=y), 5,
                    evals=[(xtb.DMatrix(X, label=y), "train")],
                    evals_result=ref_log, verbose_eval=False)
    got = xtt.train(params, _port_dm(X, label=y), 5,
                    evals=[(_port_dm(X, label=y), "train")],
                    evals_result=log, verbose_eval=False, device="cpu")
    assert len(got.trees) == len(ref.trees) == 5
    for a, b in zip(got.trees, ref.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
        np.testing.assert_array_equal(a.left_children, b.left_children)
    np.testing.assert_allclose(got.predict(_port_dm(X)),
                               ref.predict(xtb.DMatrix(X)), atol=1e-4)
    np.testing.assert_allclose(got.base_score, ref.base_score, rtol=1e-6)
    for m in log["train"]:
        np.testing.assert_allclose(log["train"][m], ref_log["train"][m],
                                   rtol=1e-4)


def test_golden_binary_model_margins():
    """A model written by dmlc/xgboost itself (tests/test_golden_models.py)."""
    gold = os.path.join(HERE, "data", "models")
    bst = xtt.Booster(model_file=os.path.join(gold, "binary.json"),
                      device="cpu")
    X = np.load(os.path.join(gold, "golden_X.npy"))
    got = bst.predict(_port_dm(X), output_margin=True)
    np.testing.assert_allclose(got, np.load(os.path.join(
        gold, "binary_margin.npy")), rtol=1e-5, atol=1e-5)


def _trained_pair(tmp_path):
    X, z = _data(seed=4)
    y = (z > 0).astype(np.float32)
    params = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16}
    port = xtt.train(params, _port_dm(X, label=y), 4, verbose_eval=False,
                     device="cpu")
    ref = xtb.train(params, xtb.DMatrix(X, label=y), 4, verbose_eval=False)
    return X, port, ref


def test_port_model_loads_in_reference(tmp_path):
    X, port, _ = _trained_pair(tmp_path)
    path = str(tmp_path / "port.json")
    port.save_model(path)
    ref = xtb.Booster()
    ref.load_model(path)
    np.testing.assert_array_equal(
        ref.predict(xtb.DMatrix(X), output_margin=True),
        port.predict(_port_dm(X), output_margin=True))
    via_dict = xtb.Booster()
    via_dict.load_model_dict(booster_to_dict(port))
    np.testing.assert_array_equal(via_dict.predict(xtb.DMatrix(X)),
                                  ref.predict(xtb.DMatrix(X)))


def test_reference_model_loads_in_port(tmp_path):
    X, _, ref = _trained_pair(tmp_path)
    want = ref.predict(xtb.DMatrix(X), output_margin=True)
    port = booster_from_dict(ref.save_raw_dict(), device="cpu")
    np.testing.assert_array_equal(
        port.predict(_port_dm(X), output_margin=True), want)
    path = str(tmp_path / "ref.json")
    ref.save_model(path)
    loaded = xtt.Booster(model_file=path, device="cpu")
    np.testing.assert_array_equal(
        loaded.predict(_port_dm(X), output_margin=True), want)
    assert json.loads(json.dumps(booster_to_dict(port))) == \
        booster_to_dict(port)


@pytest.mark.parametrize("ext", ["json", "ubj"])
def test_save_load_round_trip(tmp_path, ext):
    X, port, _ = _trained_pair(tmp_path)
    path = str(tmp_path / f"m.{ext}")
    port.save_model(path)
    again = xtt.Booster(model_file=path, device="cpu")
    np.testing.assert_array_equal(again.predict(_port_dm(X)),
                                  port.predict(_port_dm(X)))
    raw = open(path, "rb").read()
    from_bytes = xtt.Booster(device="cpu")
    from_bytes.load_model(raw)
    np.testing.assert_array_equal(from_bytes.predict(_port_dm(X)),
                                  port.predict(_port_dm(X)))


def test_base_margin_and_weights():
    X, z = _data(seed=5)
    y = (z > 0).astype(np.float32)
    w = np.random.default_rng(5).random(len(y)).astype(np.float32) + 0.5
    bm = np.full(len(y), 0.25, np.float32)
    params = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16}
    ref = xtb.train(params, xtb.DMatrix(X, label=y, weight=w, base_margin=bm),
                    3, verbose_eval=False)
    got = xtt.train(params, _port_dm(X, label=y, weight=w, base_margin=bm), 3,
                    verbose_eval=False, device="cpu")
    np.testing.assert_allclose(
        got.predict(_port_dm(X, base_margin=bm), output_margin=True),
        ref.predict(xtb.DMatrix(X, base_margin=bm), output_margin=True),
        atol=1e-4)


@pytest.mark.parametrize("name", ["rmse", "logloss", "error", "error@0.7",
                                  "auc"])
def test_metrics_match_reference(name):
    rng = np.random.default_rng(6)
    p = rng.random(500)
    p[:50] = p[50:100]  # ties
    y = (rng.random(500) < p).astype(np.float32)
    w = rng.random(500).astype(np.float32)
    for wt in (None, w):
        fn, _ = metric.create_metric(name)
        ref_fn, _ = ref_metric.create_metric(name)
        assert fn(p, y, wt) == pytest.approx(ref_fn(p, y, wt), rel=1e-12)


def test_early_stopping_and_monitor():
    X, z = _data(seed=7)
    y = (z > 0).astype(np.float32)
    lines = []
    d = _port_dm(X, label=y)
    bst = xtt.train({"objective": "binary:logistic", "max_depth": 2,
                     "eta": 1.0, "eval_metric": "error"}, d, 10,
                    evals=[(d, "train")], early_stopping_rounds=2,
                    verbose_eval=False, device="cpu",
                    callbacks=[xtt.EvaluationMonitor(logger=lines.append)])
    assert bst.best_iteration is not None
    assert bst.attr("best_iteration") == str(bst.best_iteration)
    assert lines[0].startswith("[0]\ttrain-error:")


@pytest.mark.parametrize("params,exc", [
    ({"n_devices": 2}, NotImplementedError),
    # no updater given: the reference's ValueError
    ({"process_type": "update"}, ValueError),
    ({"grow_policy": "lossguide", "max_leaves": 8,
      "deterministic_histogram": 1}, NotImplementedError),
    ({"num_target": 2, "multi_strategy": "multi_output_tree",
      "deterministic_histogram": 1}, NotImplementedError),
    ({"tree_method": "exact", "deterministic_histogram": 1},
     NotImplementedError),
    ({"objective": "multi:softprob", "num_class": 3,
      "multi_strategy": "multi_output_tree",
      "monotone_constraints": "(1,0,0,0,0,0)"}, NotImplementedError),
    ({"objective": "rank:lambdamart"}, NotImplementedError),
])
def test_unsupported_parameters_raise(params, exc):
    X, z = _data(R=64)
    with pytest.raises(exc):
        xtt.train(params, _port_dm(X, label=z), 1, verbose_eval=False,
                  device="cpu")


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the behaviour on a host without a GPU")
def test_default_device_is_cuda_and_raises_without_gpu():
    X, z = _data(R=64)
    d = _port_dm(X, label=z)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xtt.train({}, d, 1, verbose_eval=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xtt.DMatrix(X)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xtt.Booster()


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    sources = [os.path.join(d, f) for d, _, fs in os.walk(PORT)
               for f in fs if f.endswith(".py")]
    sources.append(os.path.join(os.path.dirname(HERE), "chip_smoke.py"))
    # the card-only tests run where only PyTorch is installed
    sources.append(os.path.join(HERE, "test_torch_hist_cuda.py"))
    sources.append(os.path.join(HERE, "test_torch_boosters_cuda.py"))
    sources.append(os.path.join(HERE, "test_torch_treeshap_cuda.py"))
    sources.append(os.path.join(HERE, "test_torch_extmem_cuda.py"))
    # train_distributed's and run_distributed's workers import them
    sources.append(os.path.join(HERE, "torch_extmem_parts.py"))
    sources.append(os.path.join(HERE, "torch_launcher_workers.py"))
    sources += [os.path.join(os.path.dirname(HERE), "scripts", f)
                for f in ("chip_phase19.py", "chip_phase20.py",
                          "chip_phase21.py", "chip_phase22.py")]
    assert any(p.endswith(os.path.join("xgboost_tpu_torch", "tracker.py"))
               for p in sources)
    assert any(p.endswith(os.path.join("xgboost_tpu_torch", "launcher.py"))
               for p in sources)
    assert len(sources) > 20
    assert any(p.endswith(os.path.join("ops", "quantise.py"))
               for p in sources)
    for path in sources:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "xgboost_tpu"), (path, mod)


def test_port_imports_no_frame_library_at_module_level():
    """The card's machine has no pandas, pyarrow, sklearn, matplotlib or
    graphviz: no module of the port and not chip_smoke.py may import them
    when it is imported (a frame is read through its own methods; the
    estimators and plotting import them when called)."""
    sources = [os.path.join(d, f) for d, _, fs in os.walk(PORT)
               for f in fs if f.endswith(".py")]
    sources.append(os.path.join(os.path.dirname(HERE), "chip_smoke.py"))
    for path in sources:
        tree = ast.parse(open(path).read(), filename=path)
        for node in tree.body:
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in (
                    "pandas", "pyarrow", "sklearn", "matplotlib",
                    "graphviz"), (path, mod)
