"""Port parity for data-parallel training across ranks: two in-memory
ranks (threads, each on its own row shard) of the port against two of
the reference on the same shards, and ``train_distributed``'s gloo worker
processes against the in-memory ranks.

Tolerances:
- deterministic_histogram: the model JSON is byte-identical to the
  reference's two-rank model, on every rank.  Both packages refuse the
  best-first grower (lossguide with max_leaves) and vector leaves under
  deterministic_histogram, so those two run on the f32 path below.
- f32 histogram: the same tree structures and predictions within 1e-4,
  as the in-core f32 parity tests hold (tests/test_torch_train.py,
  test_torch_bestfirst.py): the two packages sum f32 gradients in other
  orders; every rank of the port holds the same bytes.
- metrics: the global value on every rank, equal to the reference's bit
  for bit (the same f64 partial sums, reduced in rank order).

The shards are uneven (1,100 and 900 rows), so the ragged gathers and the
ranks' padding differ."""
import ast
import inspect
import json
import textwrap
import time

import numpy as np
import pytest

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu import metric as ref_metric
from xgboost_tpu.utils import native as ref_native
from xgboost_tpu_torch import distributed as tdist
from xgboost_tpu_torch import launcher
from xgboost_tpu_torch import metric as port_metric
from xgboost_tpu_torch.parallel import ProcessHistTreeGrower

from test_torch_collective import ranks

CUT = 1100  # rank 0's rows; rank 1 holds the rest


@pytest.fixture(scope="module", autouse=True)
def _reference_native_scan():
    """The reference picks its split scan when it first traces it, and its
    native library loads on the first ask: a rank thread that asks while
    another rank is loading it is told no (xgboost_tpu/utils/native.py
    load_ffi) and traces the XLA scan, which sums in another order.
    Loaded here, in the main thread, the reference's ranks take the scan
    its one-process training takes, as the port's ranks do."""
    ref_native.load_ffi()


def _data(n=2000, f=6, seed=0, task="binary"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    z = np.nan_to_num(X[:, 0]) + 0.8 * np.nan_to_num(X[:, 1]) * (X[:, 2] > 0)
    if task == "binary":
        y = (z > 0).astype(np.float32)
    elif task == "multiclass":
        y = np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    elif task == "targets":
        y = np.stack([z, np.nan_to_num(X[:, 3]) - z], axis=1).astype(
            np.float32)
    else:
        y = z.astype(np.float32)
    return X, y


def _shards(X, y, **extra):
    """Two uneven row shards, each with its rows of ``extra``'s arrays."""
    parts = []
    for lo, hi in ((0, CUT), (CUT, len(X))):
        kw = {k: v[lo:hi] for k, v in extra.items()}
        parts.append((X[lo:hi], y[lo:hi], kw))
    return parts


def _port_json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _ref_json(bst) -> str:
    return json.dumps(json.loads(bst.save_raw("json").decode()))


def _train(pkg, group, params, shards, rounds=4, dm_kw=None, **train_kw):
    """Train on ``shards`` with ``pkg`` in two in-memory ranks (the port
    on the CPU); each rank's (booster, evals_result)."""
    dev = {} if pkg is xtb else {"device": "cpu"}

    def fn(r):
        X, y, kw = shards[r]
        d = pkg.DMatrix(X, label=y, **kw, **(dm_kw or {}), **dev)
        hist = {}
        bst = pkg.train(params, d, rounds, evals=[(d, "train")],
                        evals_result=hist, verbose_eval=False, **dev,
                        **train_kw)
        return bst, hist

    return ranks(pkg, group, fn)


DET = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32,
       "eta": 0.3, "deterministic_histogram": 1}

# name -> (params over DET, task, DMatrix extras (arrays), DMatrix kwargs)
_DET_CASES = {
    "binary": ({}, "binary", {}, {}),
    "softprob3": ({"objective": "multi:softprob", "num_class": 3},
                  "multiclass", {}, {}),
    "max_leaves": ({"max_leaves": 7, "max_depth": 5}, "binary", {}, {}),
    "categorical": ({"max_cat_to_onehot": 4}, "categorical", {},
                    {"feature_types": ["q"] * 4 + ["c"] * 2,
                     "enable_categorical": True}),
    "sampling": ({"subsample": 0.7, "colsample_bynode": 0.8, "seed": 3},
                 "binary", {}, {}),
    "approx": ({"tree_method": "approx"}, "binary", {}, {}),
    "weights": ({}, "binary", {"weight": True}, {}),
    "absoluteerror": ({"objective": "reg:absoluteerror"}, "regression", {},
                      {}),
    "dart": ({"booster": "dart", "rate_drop": 0.3, "seed": 5}, "binary", {},
             {}),
}


def _case_data(task, extras):
    X, y = _data(task="binary" if task == "categorical" else task)
    if task == "categorical":
        rng = np.random.default_rng(4)
        codes = rng.integers(0, 9, size=(len(X), 2)).astype(np.float32)
        codes[rng.random(codes.shape) < 0.05] = np.nan
        X = np.concatenate([X[:, :4], codes], axis=1)
        y = ((np.nan_to_num(X[:, 0]) > 0) ^ (codes[:, 0] % 3 == 1)).astype(
            np.float32)
    arrays = {}
    if extras.get("weight"):
        arrays["weight"] = (np.abs(np.nan_to_num(X[:, 3])) + 0.5).astype(
            np.float32)
    return X, y, arrays


@pytest.mark.parametrize("case", list(_DET_CASES))
def test_deterministic_two_ranks_are_the_references_bytes(case):
    extra, task, extras, dm_kw = _DET_CASES[case]
    X, y, arrays = _case_data(task, extras)
    shards = _shards(X, y, **arrays)
    params = dict(DET, **extra)
    got = _train(xtt, f"det-{case}-port", params, shards, dm_kw=dm_kw)
    want = _train(xtb, f"det-{case}-ref", params, shards, dm_kw=dm_kw)
    assert _port_json(got[0][0]) == _port_json(got[1][0])
    assert _port_json(got[0][0]) == _ref_json(want[0][0])
    assert got[0][1] == got[1][1] == want[0][1]


@pytest.mark.parametrize("extra,task", [
    ({"grow_policy": "lossguide", "max_leaves": 6}, "binary"),
    ({"multi_strategy": "multi_output_tree", "num_target": 2,
      "objective": "reg:squarederror"},
     "targets"),
])
def test_deterministic_refusals_are_the_references(extra, task):
    """Best-first growth and vector leaves refuse deterministic_histogram
    in both packages, across ranks as in one process."""
    X, y = _data(task=task)
    shards = _shards(X, y)
    params = dict(DET, **extra)
    for pkg in (xtt, xtb):
        with pytest.raises(NotImplementedError):
            _train(pkg, f"refuse-{task}-{pkg.__name__}", params, shards)


F32 = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32,
       "eta": 0.3}


@pytest.mark.parametrize("extra,task", [
    ({}, "binary"),
    ({"grow_policy": "lossguide", "max_leaves": 8, "max_depth": 0},
     "binary"),
    ({"multi_strategy": "multi_output_tree", "num_target": 2,
      "objective": "reg:squarederror"},
     "targets"),
], ids=["depthwise", "lossguide", "multi_output_tree"])
def test_f32_two_ranks_match_the_reference(extra, task):
    X, y = _data(task=task)
    shards = _shards(X, y)
    params = dict(F32, **extra)
    got = _train(xtt, f"f32-{task}-{len(extra)}-port", params, shards)
    want = _train(xtb, f"f32-{task}-{len(extra)}-ref", params, shards)
    assert _port_json(got[0][0]) == _port_json(got[1][0])
    g, w = got[0][0], want[0][0]
    assert len(g.trees) == len(w.trees)
    for a, b in zip(g.trees, w.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
        np.testing.assert_array_equal(a.left_children, b.left_children)
        np.testing.assert_array_equal(a.right_children, b.right_children)
    np.testing.assert_allclose(g.predict(xtt.DMatrix(X, device="cpu")),
                               w.predict(xtb.DMatrix(X)), atol=1e-4)


def _mean_margin(margin, dmat):
    return "mean-margin", float(np.mean(margin))


def test_global_metrics_and_custom_metric_on_every_rank():
    """Every rank logs the global metrics and the ranks' mean of a custom
    metric, the reference's values (trained models byte-identical)."""
    X, y = _data()
    shards = _shards(X, y)
    params = dict(DET, eval_metric=["auc", "aucpr", "logloss", "rmse",
                                    "error"])
    got = _train(xtt, "metrics-port", params, shards, rounds=3,
                 custom_metric=_mean_margin)
    want = _train(xtb, "metrics-ref", params, shards, rounds=3,
                  custom_metric=_mean_margin)
    assert got[0][1] == got[1][1] == want[0][1] == want[1][1]
    assert set(got[0][1]["train"]) == {"auc", "aucpr", "logloss", "rmse",
                                       "error", "mean-margin"}


def _metric_inputs(rank):
    """One rank's predictions, labels, weights and query groups."""
    rng = np.random.default_rng(50 + rank)
    n = 300 + 80 * rank
    p = rng.random(n)
    p[: 20] = p[20: 40]  # ties
    y = (rng.random(n) < p).astype(np.float32)
    w = (rng.random(n) + 0.5).astype(np.float32)
    sizes = [7, 13, 20] * (n // 40) + [n - 40 * (n // 40)]
    gp = np.concatenate([[0], np.cumsum([s for s in sizes if s])])
    rel = np.floor(rng.random(n) * 4).astype(np.float32)
    probs = rng.random((n, 3))
    probs /= probs.sum(1, keepdims=True)
    cls = np.floor(rng.random(n) * 3).astype(np.float32)
    t = (rng.random(n) * 10).astype(np.float32) * np.where(
        rng.random(n) < 0.7, 1, -1)
    return dict(p=p, y=y, w=w, gp=gp, rel=rel, probs=probs, cls=cls, t=t)


# name -> the metric's arguments from a rank's inputs
_METRICS = {
    "auc": lambda d: ((d["p"], d["y"], d["w"]), {}),
    "aucpr": lambda d: ((d["p"], d["y"], d["w"]), {}),
    "aucpr-groups": lambda d: ((d["p"], d["y"], None),
                               {"group_ptr": d["gp"]}),
    "logloss": lambda d: ((d["p"], d["y"], d["w"]), {}),
    "rmse": lambda d: ((d["p"], d["y"], d["w"]), {}),
    "error": lambda d: ((d["p"], d["y"], None), {}),
    "mlogloss": lambda d: ((d["probs"], d["cls"], d["w"]), {}),
    "auc-multiclass": lambda d: ((d["probs"], d["cls"], None), {}),
    "ndcg@5": lambda d: ((d["p"], d["rel"], None), {"group_ptr": d["gp"]}),
    "map": lambda d: ((d["p"], d["rel"], None), {"group_ptr": d["gp"]}),
    "pre@3": lambda d: ((d["p"], d["rel"], None), {"group_ptr": d["gp"]}),
    "ams@0.15": lambda d: ((d["p"], d["y"], d["w"]), {}),
    "cox-nloglik": lambda d: ((d["p"] + 0.1, d["t"], None), {}),
}


def _global_metric(pkg, mod, name):
    base = name.split("-")[0] if name.endswith(("-groups", "-multiclass")) \
        else name
    fn, _ = mod.create_metric(base)

    def rank_value(r):
        args, kw = _METRICS[name](_metric_inputs(r))
        with mod.distributed_reduction():
            return fn(*args, **kw)

    return ranks(pkg, f"metric-{name}-{pkg.__name__}", rank_value)


@pytest.mark.parametrize("name", list(_METRICS))
def test_distributed_metric_is_the_references(name):
    got = _global_metric(xtt, port_metric, name)
    want = _global_metric(xtb, ref_metric, name)
    assert got[0] == got[1]
    assert got == want


@pytest.mark.parametrize("printer", [0, 1])
def test_evaluation_monitor_prints_on_one_rank(printer):
    X, y = _data()
    shards = _shards(X, y)
    lines = {0: [], 1: []}

    def fn(r):
        d = xtt.DMatrix(shards[r][0], label=shards[r][1], device="cpu")
        xtt.train(DET, d, 2, evals=[(d, "train")], verbose_eval=False,
                  device="cpu", callbacks=[xtt.EvaluationMonitor(
                      rank=printer, logger=lines[r].append)])

    ranks(xtt, f"monitor-{printer}", fn)
    assert len(lines[printer]) == 2 and lines[printer][0].startswith("[0]")
    assert lines[1 - printer] == []


def test_train_distributed_gloo_workers_are_the_in_memory_ranks():
    """Two gloo worker processes on the CPU give the bytes and the history
    of the in-memory ranks on the same shards."""
    X, y = _data()
    shards = _shards(X, y)
    params = dict(DET, device="cpu", eval_metric=["logloss", "auc"])
    t0 = time.time()
    out = xtt.train_distributed(params, [(X_, y_) for X_, y_, _ in shards],
                                num_boost_round=4, eval_train=True,
                                timeout=300)
    assert time.time() - t0 < 240
    mem = _train(xtt, "gloo-vs-memory", params, shards)
    assert _port_json(out["booster"]) == _port_json(mem[0][0])
    assert out["history"] == json.loads(json.dumps(mem[0][1]))


def _failing_part():
    raise RuntimeError("this worker's data cannot be read")


def test_train_distributed_worker_failure_fails_fast():
    X, y = _data(n=800)
    t0 = time.time()
    with pytest.raises(RuntimeError, match="distributed training failed") \
            as err:
        xtt.train_distributed(dict(DET, device="cpu"),
                              [(X[:400], y[:400]), _failing_part],
                              num_boost_round=2, timeout=300)
    assert time.time() - t0 < 120, "the failure did not end the job"
    assert "cannot be read" in str(err.value)


def test_train_distributed_failing_part_aborts_its_peer():
    """The reference's check (tests/test_distributed_driver.py:61): a
    worker whose callable part fails signals the tracker, which aborts
    its peer (exit 255) waiting in the distributed sketch; the job raises
    at once with the failing worker's traceback."""
    X, y = _data(n=800)
    t0 = time.time()
    with pytest.raises(RuntimeError, match="distributed training failed") \
            as err:
        xtt.train_distributed(dict(DET, device="cpu"),
                              [(X[:400], y[:400]), _failing_part],
                              num_boost_round=2, timeout=300)
    assert time.time() - t0 < 120, "the failure did not end the job"
    msg = str(err.value)
    assert "aborted by tracker fan-out" in msg
    assert "Traceback" in msg and "in _failing_part" in msg
    assert sorted(rc for _l, rc, _t in err.value.__cause__.failures) \
        == [1, 255]


def test_train_distributed_rejects_empty_parts():
    with pytest.raises(ValueError):
        xtt.train_distributed({"device": "cpu"}, [], num_boost_round=1)


def test_worker_script_imports_only_the_port():
    """The worker that train_distributed starts (the launcher's script,
    then its worker function) imports the standard library and
    xgboost_tpu_torch, nothing else."""
    mods = set()
    for src in (launcher._CHILD,
                textwrap.dedent(inspect.getsource(tdist._train_worker))):
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                mods.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                mods.add("xgboost_tpu_torch" if node.level
                         else node.module.split(".")[0])
    assert mods == {"pickle", "sys", "xgboost_tpu_torch"}


@pytest.mark.parametrize("builders", ["every rank", "rank 0 alone"])
def test_quantile_dmatrix_in_a_group_keeps_its_own_cuts(builders):
    """A QuantileDMatrix made inside a group is sketched on its rank's rows,
    as the reference's is (its training cache asks for the shared cuts,
    reference core.py:305): each rank's cuts are the reference's on the
    same shard, and a matrix that rank 0 alone builds (a validation set)
    joins no collective."""
    shards = _shards(*_data())

    def cuts(pkg):
        dev = {} if pkg is xtb else {"device": "cpu"}

        def fn(r):
            if builders == "rank 0 alone" and r:
                return None
            X, y, _ = shards[r]
            return pkg.QuantileDMatrix(X, label=y, max_bin=32,
                                       **dev)._ellpack.cuts

        return ranks(pkg, f"qdm-{builders}-{pkg.__name__}", fn)

    for got, want in zip(cuts(xtt), cuts(xtb)):
        if want is None:
            assert got is None
            continue
        for field in ("cut_ptrs", "cut_values", "min_vals"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))


# what the port does not train across ranks (ROADMAP Queue 3 item 8,
# Queue 1 item 9b.5): each raises on every rank rather than train a rank's
# rows alone
_REFUSED = {
    "gblinear": lambda d: xtt.train({"booster": "gblinear"}, d, 1,
                                    verbose_eval=False, device="cpu"),
    "mesh": lambda d: ProcessHistTreeGrower(
        3, None, mesh=object()),
}


def _one_batch(pkg, X, y):
    """A ``pkg.DataIter`` of one batch."""

    class OneBatch(pkg.DataIter):
        def __init__(self):
            super().__init__()
            self._done = False

        def next(self, input_data):
            if self._done:
                return 0
            self._done = True
            input_data(data=X, label=y)
            return 1

        def reset(self):
            self._done = False

    return OneBatch()


@pytest.mark.parametrize("case", list(_REFUSED))
def test_unported_paths_raise_across_ranks(case):
    X, y = _data(n=400)

    def fn(r):
        d = xtt.DMatrix(X[r::2], label=y[r::2], device="cpu")
        with pytest.raises(NotImplementedError, match="item 9"):
            _REFUSED[case](d)
        return True

    assert ranks(xtt, f"refused-{case}", fn) == [True, True]


def _lifted(pkg, case, X, y, model):
    """What the port refused across ranks before, in ``pkg``, on the rows
    given: the trained booster."""
    dev = {} if pkg is xtb else {"device": "cpu"}
    ext = {} if pkg is xtb else {"device": "cpu", "compress": False}
    if case == "exact":
        return pkg.train({"tree_method": "exact"},
                         pkg.DMatrix(X, label=y, **dev), 1,
                         verbose_eval=False, **dev)
    if case == "update":
        return pkg.train({"process_type": "update", "updater": "refresh",
                          "max_bin": 32}, pkg.DMatrix(X, label=y, **dev),
                         2, verbose_eval=False, xgb_model=model, **dev)
    if case == "extmem_matrix":
        d = pkg.ExtMemQuantileDMatrix(_one_batch(pkg, X, y), max_bin=32,
                                      **ext)
        return pkg.train(DET, d, 2, verbose_eval=False, **dev)
    cfg = pkg.ExtMemConfig(lambda smap, rank, world: _one_batch(pkg, X, y),
                           max_bin=32, **({} if pkg is xtb else
                                          {"compress": False}))
    return pkg.train(DET, cfg, 2, verbose_eval=False, **dev)


@pytest.mark.parametrize("case", ["exact", "update", "extmem_matrix",
                                  "extmem_config"])
def test_lifted_paths_train_across_ranks(case):
    """exact, process_type="update", out-of-core matrices and ExtMemConfig
    train across ranks: the same bytes on every rank, the reference's at
    the same ranks (deterministic histograms where there are any)."""
    X, y = _data(n=400)
    models = {pkg: pkg.train(dict(DET, objective="reg:squarederror"),
                             pkg.DMatrix(X, label=y, **dev), 2,
                             verbose_eval=False, **dev)
              for pkg, dev in ((xtt, {"device": "cpu"}), (xtb, {}))}

    def run(pkg):
        def fn(r):
            bst = _lifted(pkg, case, X[r::2], y[r::2], models[pkg])
            return _port_json(bst) if pkg is xtt else _ref_json(bst)

        return ranks(pkg, f"lifted-{case}-{pkg.__name__}", fn)

    got, want = run(xtt), run(xtb)
    assert got[0] == got[1] == want[0]


def test_pages_built_in_one_process_refuse_ranks():
    """An out-of-core matrix made before the ranks formed trains across
    them as the reference's does: every rank streams all of its pages, so
    each level sums the matrix once a rank (the ranks' bytes equal, and
    the reference's)."""
    X, y = _data(n=400)

    def run(pkg):
        dev = {} if pkg is xtb else {"device": "cpu"}
        ext = {} if pkg is xtb else {"device": "cpu", "compress": False}
        d = pkg.ExtMemQuantileDMatrix(_one_batch(pkg, X, y), max_bin=32,
                                      **ext)

        def fn(r):
            bst = pkg.train(DET, d, 2, verbose_eval=False, **dev)
            return _port_json(bst) if pkg is xtt else _ref_json(bst)

        return ranks(pkg, f"prebuilt-pages-{pkg.__name__}", fn)

    got, want = run(xtt), run(xtb)
    assert got[0] == got[1] == want[0]
