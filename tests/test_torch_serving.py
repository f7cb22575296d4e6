"""The port's serving engine (xgboost_tpu_torch/serving/) on the CPU: every
case of tests/test_serving.py with ``device="cpu"``, and the same models,
saved as JSON by one package and loaded into both, served by the
reference's engine and the port's with the same bits."""
import threading
import time

import numpy as np
import pytest

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu.ops.predict import bucket_rows as ref_bucket_rows
from xgboost_tpu.serving import ServingEngine as RefEngine
from xgboost_tpu_torch.ops.predict import bucket_rows, bucket_width
from xgboost_tpu_torch.serving import (MicroBatcher, ModelRegistry,
                                       ServeConfig, ServingEngine)


def _dm(X, **kw):
    return xtt.DMatrix(X, device="cpu", **kw)


def _train(seed=0, rounds=5, objective="binary:logistic", n=256, f=6,
           **params):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    if objective.startswith("multi"):
        y = rng.integers(0, params.get("num_class", 3), size=n).astype(
            np.float32)
    else:
        y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    bst = xtt.train(dict({"objective": objective, "max_depth": 4}, **params),
                    _dm(X, label=y), rounds, verbose_eval=False, device="cpu")
    return bst, X, y


def _engine(**kw):
    return ServingEngine(device="cpu", **kw)


# ====================================================================
# bucket policy

def test_bucket_policy():
    assert [bucket_rows(n) for n in (1, 8, 9, 100, 4096)] == [
        8, 8, 16, 128, 4096]
    assert bucket_rows(4097) == 8192
    assert bucket_rows(9000) == 12288  # multiples of 4096 past the ceiling
    assert bucket_width(3) == 4 and bucket_width(17) == 32


def test_bucket_rows_matches_reference():
    n = np.arange(1, 20_001)
    assert [bucket_rows(int(i)) for i in n] == [ref_bucket_rows(int(i))
                                                for i in n]


def test_predict_reuses_programs_across_row_counts():
    """Row counts in one bucket share one program: the port's
    Booster.predict keeps none, so the engine's gauge is checked."""
    bst, X, _ = _train(seed=3)
    with _engine(use_batcher=False) as eng:
        eng.add_model("m", bst, warmup=False)
        eng.predict("m", X[:33])  # prepares the 64-row bucket
        before = eng.compile_cache_size()
        for r in (34, 40, 64):  # all bucket to 64
            eng.predict("m", X[:r])
        assert eng.compile_cache_size() == before
        assert eng.metrics_snapshot()["compiles_steady"] == 1


# ====================================================================
# engine basics

def test_engine_matches_booster_predict():
    bst, X, _ = _train(seed=1)
    with _engine(max_delay_us=200, warmup_buckets=(8, 64)) as eng:
        eng.add_model("m", bst)
        for r in (1, 7, 33, 64):
            ref = bst.predict(_dm(X[:r]))
            np.testing.assert_array_equal(eng.predict("m", X[:r]), ref)
            np.testing.assert_array_equal(
                eng.predict("m", X[:r], direct=True), ref)
        ref_m = bst.predict(_dm(X[:16]), output_margin=True)
        np.testing.assert_array_equal(
            eng.predict("m", X[:16], output_margin=True), ref_m)


def test_engine_multiclass_shape():
    bst, X, _ = _train(seed=2, objective="multi:softprob", num_class=3)
    with _engine(use_batcher=False, warmup_buckets=(16,)) as eng:
        eng.add_model("mc", bst)
        out = eng.predict("mc", X[:10])
        assert out.shape == (10, 3)
        np.testing.assert_array_equal(out, bst.predict(_dm(X[:10])))


def test_engine_softmax_argmax_output():
    """multi:softmax's transform is an argmax, (R,) already (the
    reference's engine squeezes a second axis it does not have)."""
    bst, X, _ = _train(seed=2, objective="multi:softmax", num_class=3)
    with _engine(max_delay_us=100, warmup_buckets=(16,)) as eng:
        eng.add_model("mc", bst)
        for direct in (False, True):
            out = eng.predict("mc", X[:10], direct=direct)
            np.testing.assert_array_equal(out, bst.predict(_dm(X[:10])))


def test_engine_loads_model_files(tmp_path):
    bst, X, _ = _train(seed=4)
    ref = bst.predict(_dm(X[:20]))
    for ext in ("json", "ubj"):
        path = str(tmp_path / f"m.{ext}")
        bst.save_model(path)
        with _engine(use_batcher=False) as eng:
            eng.add_model(f"m_{ext}", path, warmup=False)
            np.testing.assert_array_equal(
                eng.predict(f"m_{ext}", X[:20]), ref)


def test_engine_input_validation_and_error_metric():
    bst, X, _ = _train(seed=5)
    with _engine(use_batcher=False) as eng:
        eng.add_model("m", bst, warmup=False)
        with pytest.raises(ValueError, match="feature shape mismatch"):
            eng.predict("m", X[:4, :3])
        with pytest.raises(KeyError):
            eng.predict("ghost", X[:4])
        assert eng.metrics.snapshot()["models"]["m"]["errors"] == 1
        # 1-D input is a single row
        assert eng.predict("m", X[0]).shape == (1,)
        # base_margin cannot ride a coalesced batch -> explicit rejection
        with pytest.raises(ValueError, match="base_margin"):
            eng.predict("m", _dm(X[:4], base_margin=np.zeros(4, np.float32)))
    with pytest.raises(RuntimeError, match="closed"):
        eng.predict("m", X[:4])


def test_serve_config_validation():
    with pytest.raises(ValueError):
        ServeConfig(max_batch=0)
    with pytest.raises(ValueError):
        ServingEngine(max_delay_us=-1)
    # default warm-up covers every bucket the admission policy can produce
    assert ServeConfig(max_batch=64).resolved_warmup_buckets() == (
        8, 16, 32, 64)
    assert ServeConfig(max_batch=1).resolved_warmup_buckets() == (8,)
    assert ServeConfig(max_batch=9000).resolved_warmup_buckets()[-3:] == (
        4096, 8192, 12288)
    assert ServeConfig(max_batch=64, warmup_buckets=(8,)
                       ).resolved_warmup_buckets() == (8,)


# ====================================================================
# registry: versions, pinning, LRU

def test_registry_versions_and_pinning():
    b1, X, _ = _train(seed=6, rounds=3)
    b2, _, _ = _train(seed=6, rounds=6)
    with _engine(use_batcher=False) as eng:
        v1 = eng.add_model("m", b1, warmup=False)
        v2 = eng.add_model("m", b2, warmup=False)
        assert (v1, v2) == (1, 2)
        p1 = b1.predict(_dm(X[:16]))
        p2 = b2.predict(_dm(X[:16]))
        np.testing.assert_array_equal(eng.predict("m", X[:16]), p2)  # latest
        eng.pin("m", v1)  # rollback knob
        np.testing.assert_array_equal(eng.predict("m", X[:16]), p1)
        np.testing.assert_array_equal(
            eng.predict("m", X[:16], version=v2), p2)  # explicit wins
        eng.unpin("m")
        np.testing.assert_array_equal(eng.predict("m", X[:16]), p2)


def test_registry_lru_eviction():
    reg = ModelRegistry(max_models=2)
    boosters = [_train(seed=s, rounds=2, n=64)[0] for s in range(3)]
    reg.register("a", boosters[0])
    reg.register("b", boosters[1])
    reg.get("a")  # a is now more recently used than b
    reg.register("c", boosters[2])  # evicts b
    assert reg.names() == ["a", "c"] and reg.evictions == 1
    # every version of b was evicted, so the name itself is gone
    with pytest.raises(KeyError, match="unknown model"):
        reg.get("b")


def test_registry_evicting_latest_keeps_older_resolvable():
    reg = ModelRegistry(max_models=2)
    b0, _, _ = _train(seed=0, rounds=2, n=64)
    b1, _, _ = _train(seed=1, rounds=2, n=64)
    reg.register("m", b0)  # v1
    reg.register("m", b1)  # v2
    reg.get("m", 1)  # v2 becomes the LRU victim
    reg.register("other", b0)  # evicts (m, 2)
    assert reg.versions("m") == [1]
    _, v = reg.get("m")  # must fall back to the surviving version
    assert v == 1


def test_registry_pinned_never_evicted():
    reg = ModelRegistry(max_models=2)
    boosters = [_train(seed=s, rounds=2, n=64)[0] for s in range(3)]
    reg.register("a", boosters[0])
    reg.pin("a", 1)
    reg.register("b", boosters[1])
    reg.register("c", boosters[2])  # must evict b, not pinned a
    assert reg.names() == ["a", "c"]
    reg.register("d", boosters[2])  # evicts c
    reg.register("e", boosters[2])  # evicts d
    assert "a" in reg.names()
    # all-pinned registry refuses further loads loudly
    reg2 = ModelRegistry(max_models=1)
    reg2.register("x", boosters[0])
    reg2.pin("x", 1)
    with pytest.raises(RuntimeError, match="all pinned"):
        reg2.register("y", boosters[1])
    assert reg.resident_bytes() > 0


def test_eviction_releases_programs():
    """An evicted snapshot's programs leave the gauge at once (on the card:
    its graphs, static buffers and pinned staging are freed)."""
    boosters = [_train(seed=s, rounds=2, n=64) for s in range(2)]
    with _engine(use_batcher=False, max_models=1,
                 warmup_buckets=(8, 16)) as eng:
        base = eng.compile_cache_size()
        eng.add_model("a", boosters[0][0])
        assert eng.compile_cache_size() == base + 4
        eng.add_model("b", boosters[1][0])  # evicts a, prepares b's four
        assert eng.compile_cache_size() == base + 4
        assert eng.metrics_snapshot()["compiles_warmup"] == 8
        eng.registry.remove("b")
        assert eng.compile_cache_size() == base


def test_evicted_snapshot_is_freed():
    """Nothing of the engine keeps an evicted snapshot (and its device
    tensors) alive, the batcher's worker included."""
    import weakref

    bst, X, _ = _train(seed=12, rounds=2, n=64)
    with _engine(max_delay_us=0, warmup_buckets=(8,)) as eng:
        eng.add_model("m", bst)
        eng.predict("m", X[:3])
        snap = weakref.ref(eng.registry.get("m")[0])
        eng.registry.remove("m")
        deadline = time.monotonic() + 5
        while snap() is not None and time.monotonic() < deadline:
            time.sleep(0.01)  # the worker drops its batch after replying
        assert snap() is None


# ====================================================================
# snapshot semantics

def test_snapshot_immutable_under_continued_training():
    bst, X, y = _train(seed=7, rounds=3)
    with _engine(use_batcher=False) as eng:
        eng.add_model("m", bst, warmup=False)
        snap_preds_before = eng.predict("m", X[:32])
        # mutate the live booster: continue training 3 more rounds
        d = _dm(X, label=y)
        for it in (3, 4, 5):
            bst.update(d, it)
        after = bst.predict(_dm(X[:32]))
        served = eng.predict("m", X[:32])
        np.testing.assert_array_equal(served, snap_preds_before)
        assert not np.array_equal(served, after)  # booster moved on
        # re-registering picks up the new trees as a new version
        eng.add_model("m", bst, warmup=False)
        np.testing.assert_array_equal(eng.predict("m", X[:32]), after)


def test_snapshot_rejects_gblinear():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    bst = xtt.train({"booster": "gblinear", "objective": "binary:logistic"},
                    _dm(X, label=y), 2, verbose_eval=False, device="cpu")
    with pytest.raises(NotImplementedError, match="gblinear"):
        bst.inference_snapshot()


def test_snapshot_margin_matches_booster():
    import torch

    bst, X, _ = _train(seed=13, objective="multi:softprob", num_class=3)
    snap = bst.inference_snapshot()
    Xt = torch.from_numpy(X[:5])
    margin = snap.margin(Xt)
    np.testing.assert_array_equal(
        (margin + torch.from_numpy(snap.base_score)).numpy(),
        bst.predict(_dm(X[:5]), output_margin=True))
    init = torch.ones((5, 3))  # accumulated into, tree by tree
    np.testing.assert_allclose(snap.margin(Xt, init).numpy(),
                               (margin + init).numpy(), rtol=1e-6)


def test_capture_records_launches_and_replays_count_them():
    """A wrapper called under ``capturing`` launches nothing; each replay
    of the graph counts the kernels it recorded."""
    from xgboost_tpu_torch.ops import hist_cuda

    hist_cuda.reset_launches()
    try:
        with hist_cuda.capturing() as names:
            hist_cuda.launched("sigmoid", None, 0)
        assert names == ["sigmoid"] and hist_cuda.launches["sigmoid"] == 0
        hist_cuda.replayed(names)
        hist_cuda.replayed(names)
        hist_cuda.launched("sigmoid", None, 0)
        assert hist_cuda.launches["sigmoid"] == 3
        assert hist_cuda.thread_launches()["sigmoid"] == 3
    finally:
        hist_cuda.reset_launches()


def test_zero_tree_model_is_served():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(40, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    bst = xtt.train({"objective": "binary:logistic"}, _dm(X, label=y), 0,
                    verbose_eval=False, device="cpu")
    snap = bst.inference_snapshot()
    assert snap.stacked is None and snap.nbytes == 0
    with _engine(max_delay_us=100, warmup_buckets=(8,)) as eng:
        eng.add_model("z", bst)
        for margin in (False, True):
            np.testing.assert_array_equal(
                eng.predict("z", X[:5], output_margin=margin),
                bst.predict(_dm(X[:5]), output_margin=margin))


# ====================================================================
# micro-batcher

def test_batcher_coalesces_and_splits():
    """Requests queued while the worker is busy coalesce into ONE batch and
    split back per caller in FIFO order."""
    entered, release = threading.Event(), threading.Event()
    calls = []

    def execute(key, X, ctx):
        entered.set()
        release.wait(10)
        calls.append(len(X))
        return X * 2.0

    mb = MicroBatcher(execute, max_batch=100, max_delay_us=0)
    try:
        f0 = mb.submit("k", np.full((1, 2), 1.0))
        assert entered.wait(10)  # worker is now blocked inside batch 1
        fs = [mb.submit("k", np.full((i + 1, 2), float(i)))
              for i in range(4)]
        release.set()
        np.testing.assert_array_equal(f0.result(10), np.full((1, 2), 2.0))
        for i, f in enumerate(fs):
            np.testing.assert_array_equal(
                f.result(10), np.full((i + 1, 2), 2.0 * i))
    finally:
        mb.close()
    assert calls == [1, 10]  # batch 2 coalesced all four queued requests


def test_batcher_max_batch_admission():
    calls = []

    def execute(key, X, ctx):
        calls.append(len(X))
        return X

    mb = MicroBatcher(execute, max_batch=4, max_delay_us=500_000)
    try:
        # 2+2 rows reach max_batch -> launches immediately, not after 500ms
        t0 = time.perf_counter()
        f1 = mb.submit("k", np.zeros((2, 1)))
        f2 = mb.submit("k", np.zeros((2, 1)))
        f1.result(10), f2.result(10)
        assert time.perf_counter() - t0 < 0.4
        # one oversized request still runs (as its own batch)
        f3 = mb.submit("k", np.zeros((9, 1)))
        assert f3.result(10).shape == (9, 1)
    finally:
        mb.close()
    assert 9 in calls


def test_batcher_propagates_errors_to_all_waiters():
    def execute(key, X, ctx):
        raise RuntimeError("kaboom")

    mb = MicroBatcher(execute, max_batch=10, max_delay_us=0)
    try:
        fs = [mb.submit("k", np.zeros((1, 1))) for _ in range(3)]
        for f in fs:
            with pytest.raises(RuntimeError, match="kaboom"):
                f.result(10)
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit("k", np.zeros((1, 1)))


# ====================================================================
# concurrency acceptance: bitwise equality + no programs after warm-up

def _hammer(jobs, n_threads):
    """Run ``jobs`` (callables) round-robin from ``n_threads`` threads;
    re-raise the first worker failure."""
    errors = []
    barrier = threading.Barrier(n_threads)

    def worker(tid):
        try:
            barrier.wait(10)
            for j in jobs[tid::n_threads]:
                j()
        except BaseException as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]


def test_concurrent_single_model_bitwise_no_retrace():
    """>= 4 threads hammer one model through the batcher; every result is
    bitwise the single-threaded reference and the program gauge does not
    move after warm-up."""
    bst, X, _ = _train(seed=8)
    row_counts = [1, 5, 8, 33, 64]  # all bucket to 8 or 64
    refs = {r: np.asarray(bst.predict(_dm(X[:r]))) for r in row_counts}
    with _engine(max_delay_us=500, max_batch=64,
                 warmup_buckets=(8, 16, 32, 64)) as eng:
        eng.add_model("m", bst)  # warms all buckets, margin + transformed
        cache_before = eng.compile_cache_size()

        def make_job(r):
            def job():
                out = eng.predict("m", X[:r])
                assert np.array_equal(out, refs[r]), f"mismatch at rows={r}"
            return job

        jobs = [make_job(r) for r in row_counts * 12]  # 60 requests
        _hammer(jobs, n_threads=6)

        assert eng.compile_cache_size() == cache_before
        snap = eng.metrics_snapshot()
        assert snap["compiles_steady"] == 0
        m = snap["models"]["m"]
        assert m["requests"] == len(jobs) and m["errors"] == 0
        assert m["rows"] == sum(row_counts) * 12
        assert m["batches"] >= 1
        lat = m["latency_ms"]
        assert all(lat[q] is not None for q in ("p50", "p95", "p99"))
        assert lat["p50"] <= lat["p95"] <= lat["p99"]


def test_concurrent_many_models_bitwise_no_retrace():
    models = {f"m{s}": _train(seed=20 + s, rounds=3) for s in range(3)}
    refs = {name: np.asarray(bst.predict(_dm(X[:32])))
            for name, (bst, X, _) in models.items()}
    with _engine(max_delay_us=300, max_batch=32,
                 warmup_buckets=(8, 16, 32)) as eng:
        for name, (bst, _, _) in models.items():
            eng.add_model(name, bst)
        cache_before = eng.compile_cache_size()

        def make_job(name):
            X = models[name][1]

            def job():
                assert np.array_equal(eng.predict(name, X[:32]), refs[name])
            return job

        jobs = [make_job(name) for name in models for _ in range(10)]
        _hammer(jobs, n_threads=5)

        assert eng.compile_cache_size() == cache_before
        snap = eng.metrics_snapshot()
        assert snap["compiles_steady"] == 0
        assert snap["resident_models"] == 3
        for name in models:
            assert snap["models"][name]["requests"] == 10
            assert snap["models"][name]["errors"] == 0


def test_direct_and_batched_paths_agree_bitwise():
    bst, X, _ = _train(seed=9)
    with _engine(max_delay_us=200, warmup_buckets=(32,)) as eng:
        eng.add_model("m", bst)
        np.testing.assert_array_equal(
            eng.predict("m", X[:17]), eng.predict("m", X[:17], direct=True))


# ====================================================================
# metrics & observer

def test_metrics_snapshot_shape_and_observer(capsys, monkeypatch):
    bst, X, _ = _train(seed=10, f=9)
    with _engine(max_delay_us=100) as eng:
        eng.add_model("m", bst, warmup=False)
        for r in (3, 9, 30):
            eng.predict("m", X[:r])
        snap = eng.metrics_snapshot()
        m = snap["models"]["m"]
        assert m["rows"] == 42 and m["requests"] == 3
        assert sum(m["batch_size_hist"].values()) == m["batches"]
        assert m["rows_per_s"] is None or m["rows_per_s"] > 0
        assert snap["compiles_warmup"] == 0  # warmup=False: all steady
        assert snap["compiles_steady"] > 0
        assert snap["resident_bytes"] > 0
        assert snap["queue_depth"] == 0  # drained
        from xgboost_tpu_torch.utils import observer

        monkeypatch.setattr(observer, "enabled", lambda: True)
        eng.metrics.export(tag="t")
        err = capsys.readouterr().err
        assert "[observer] t:" in err and "[observer] t.m:" in err
    from xgboost_tpu_torch.telemetry import render_prometheus

    text = render_prometheus()
    for name in ("xtb_serve_requests_total", "xtb_serve_batch_rows_bucket",
                 "xtb_serve_latency_seconds_count", "xtb_serve_queue_peak",
                 'xtb_compiles_steady{scope="serve"}'):
        assert name in text


def test_serve_execute_span_records_phase():
    from xgboost_tpu_torch.telemetry import spans

    bst, X, _ = _train(seed=11)
    before = spans.phase_totals().get("serve.execute", {"count": 0})["count"]
    spans.enable()
    try:
        with _engine(use_batcher=False, warmup_buckets=(8,)) as eng:
            eng.add_model("m", bst)
            eng.predict("m", X[:3])
    finally:
        spans.disable()
    # warm-up's two programs and the request
    assert spans.phase_totals()["serve.execute"]["count"] == before + 3


# ====================================================================
# review regressions

def test_engine_recodes_categorical_dmatrix():
    """A served DMatrix whose pandas category ordering differs from the
    training frame's recodes onto the train-time codes, as
    Booster.predict does."""
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(0)
    n = 600
    colors = ["red", "green", "blue", "yellow"]
    col = rng.choice(colors, size=n)
    num = rng.normal(size=n).astype(np.float32)
    y = ((col == "red") | (col == "blue")).astype(np.float32) + 0.01 * num
    d = _dm(pd.DataFrame({
        "c": pd.Categorical(col, categories=colors), "x": num,
    }), label=y, enable_categorical=True)
    bst = xtt.train({"objective": "reg:squarederror", "max_depth": 4,
                     "max_cat_to_onehot": 1}, d, 6, verbose_eval=False,
                    device="cpu")
    # same data, categories declared reversed -> different physical codes
    d_flip = _dm(pd.DataFrame({
        "c": pd.Categorical(col, categories=colors[::-1]), "x": num,
    }), enable_categorical=True)
    ref = bst.predict(d_flip)
    with _engine(use_batcher=False) as eng:
        eng.add_model("m", bst, warmup=False)
        np.testing.assert_array_equal(eng.predict("m", d_flip), ref)
        snap, _ = eng.registry.get("m")
        assert snap.get_categories() == bst.get_categories()
        # a category unseen in training still fails loudly
        d_bad = _dm(pd.DataFrame({
            "c": pd.Categorical(["purple"] * 4, categories=["purple"]),
            "x": num[:4],
        }), enable_categorical=True)
        with pytest.raises(ValueError, match="not seen in training"):
            eng.predict("m", d_bad)


def test_batcher_worker_survives_prepare_failure():
    """An exception while preparing a batch (a ragged concatenate) fans out
    to the batch's callers and leaves the worker alive."""
    entered, release = threading.Event(), threading.Event()

    def execute(key, X, ctx):
        entered.set()
        release.wait(10)
        return X

    mb = MicroBatcher(execute, max_batch=100, max_delay_us=0)
    try:
        f0 = mb.submit("k", np.zeros((1, 2)))
        assert entered.wait(10)  # worker blocked: next submits coalesce
        bad = [mb.submit("k", np.zeros((2, 2))),
               mb.submit("k", np.zeros((2, 3)))]  # ragged widths
        release.set()
        assert f0.result(10).shape == (1, 2)
        for f in bad:
            with pytest.raises(ValueError):
                f.result(10)
        # the worker is still serving
        assert mb.submit("k", np.zeros((3, 2))).result(10).shape == (3, 2)
    finally:
        mb.close()


def test_registry_reregister_keeps_pin():
    reg = ModelRegistry(max_models=2)
    boosters = [_train(seed=s, rounds=2, n=64)[0] for s in range(3)]
    reg.register("m", boosters[0], version=1)
    reg.pin("m", 1)
    reg.register("m", boosters[1], version=1)  # hot-swap the pinned version
    reg.register("a", boosters[2])
    reg.register("b", boosters[2])  # capacity pressure: must not evict (m,1)
    snap, v = reg.get("m")
    assert v == 1 and "m" in reg.names()


def test_registry_remove_latest_keeps_older_versions():
    reg = ModelRegistry(max_models=4)
    b1 = _train(seed=0, rounds=2, n=64)[0]
    b2 = _train(seed=1, rounds=2, n=64)[0]
    reg.register("m", b1)  # v1
    reg.register("m", b2)  # v2
    reg.remove("m", 2)
    snap, v = reg.get("m")  # must fall back to the surviving version
    assert v == 1
    assert reg.register("m", b2) == 2  # numbering continues, no overwrite


def test_execute_serves_current_snapshot_after_hot_swap():
    """A coalesced batch resolves its snapshot at execute time: requests
    queued before a same-version hot swap are served by the replacement."""
    b1, X, _ = _train(seed=0, rounds=2)
    b2, _, _ = _train(seed=30, rounds=4)
    with _engine(use_batcher=False) as eng:
        eng.add_model("m", b1, version=1, warmup=False)
        stale_ctx = (eng.registry.get("m", 1)[0], False)
        eng.registry.register("m", b2, version=1)  # hot swap under v1
        out = eng._execute(("m", 1, False), X[:8], stale_ctx)
        np.testing.assert_array_equal(out[:, 0], b2.predict(_dm(X[:8])))


def test_execute_falls_back_when_features_change():
    """A replacement with another feature count does not serve a batch
    validated against the submit-time snapshot."""
    b1, X, _ = _train(seed=0, rounds=2)
    b2, _, _ = _train(seed=1, rounds=2, f=4)
    with _engine(use_batcher=False) as eng:
        eng.add_model("m", b1, version=1, warmup=False)
        stale_ctx = (eng.registry.get("m", 1)[0], False)
        eng.registry.register("m", b2, version=1)
        out = eng._execute(("m", 1, False), X[:8], stale_ctx)
        np.testing.assert_array_equal(out[:, 0], b1.predict(_dm(X[:8])))


def test_serving_is_lazy_and_exports():
    import xgboost_tpu_torch.serving as srv

    assert xtt.serving is srv
    for name in ("ServingEngine", "ServeConfig", "ModelRegistry",
                 "InferenceSnapshot", "MicroBatcher", "ServingMetrics",
                 "WorkerDiedError", "QueueFullError"):
        assert name in srv.__all__ and hasattr(srv, name)


# ====================================================================
# the reference's engine and the port's: the same bits

_ROWS = (1, 7, 33, 64, 4097)
_MODELS = {
    # name: (params, rounds, package that trains and saves it)
    "binary": ({"objective": "binary:logistic", "max_depth": 4}, 4, "port"),
    "squarederror": ({"objective": "reg:squarederror", "max_depth": 4}, 4,
                     "reference"),
    "softprob": ({"objective": "multi:softprob", "num_class": 3,
                  "max_depth": 3}, 3, "port"),
    "categorical": ({"objective": "reg:squarederror", "max_depth": 4,
                     "max_cat_to_onehot": 1}, 4, "reference"),
    "dart": ({"objective": "binary:logistic", "booster": "dart",
              "rate_drop": 0.3, "max_depth": 3}, 4, "port"),
    "multi_output": ({"objective": "reg:squarederror", "max_depth": 3,
                      "num_target": 3,
                      "multi_strategy": "multi_output_tree"}, 3,
                     "reference"),
}


def _model_data(name, n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    X[rng.random(size=X.shape) < 0.05] = np.nan
    kw = {}
    if name == "categorical":
        X[:, 0] = rng.integers(0, 6, size=n)
        X[rng.random(size=n) < 0.05, 0] = np.nan
        kw = {"feature_types": ["c", "q", "q", "q", "q"],
              "enable_categorical": True}
    z = np.nan_to_num(X[:, 1]) + 0.5 * np.nan_to_num(X[:, 2])
    if name == "softprob":
        y = np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    elif name == "multi_output":
        y = np.stack([z, z * z, -z], axis=1).astype(np.float32)
    elif name == "categorical":
        y = (np.nan_to_num(X[:, 0]) % 3 + z).astype(np.float32)
    elif name in ("binary", "dart"):
        y = (z > 0).astype(np.float32)
    else:
        y = z.astype(np.float32)
    return X, y, kw


@pytest.fixture(scope="module")
def cross_engines(tmp_path_factory):
    """Both packages' engines, each serving the six models from the same
    JSON files; and the rows each model is asked about."""
    tmp = tmp_path_factory.mktemp("cross")
    rows = {}
    ref_eng = RefEngine(max_delay_us=200, max_batch=8192,
                        warmup_buckets=(8,))
    port_eng = ServingEngine(max_delay_us=200, max_batch=8192,
                             warmup_buckets=(8,), device="cpu")
    for i, (name, (params, rounds, saver)) in enumerate(_MODELS.items()):
        X, y, kw = _model_data(name, 1500, seed=40 + i)
        if saver == "port":
            bst = xtt.train(params, _dm(X, label=y, **kw), rounds,
                            verbose_eval=False, device="cpu")
        else:
            bst = xtb.train(params, xtb.DMatrix(X, label=y, **kw), rounds,
                            verbose_eval=False)
        path = str(tmp / f"{name}.json")
        bst.save_model(path)
        ref_eng.add_model(name, path)
        port_eng.add_model(name, path)
        rows[name] = _model_data(name, max(_ROWS), seed=80 + i)[0]
    yield ref_eng, port_eng, rows
    ref_eng.close()
    port_eng.close()


@pytest.mark.parametrize("direct", [False, True], ids=["batched", "direct"])
@pytest.mark.parametrize("name", list(_MODELS))
def test_engine_matches_reference_engine_bitwise(cross_engines, name,
                                                 direct):
    ref_eng, port_eng, rows = cross_engines
    X = rows[name]
    for r in _ROWS:
        for margin in (False, True):
            want = ref_eng.predict(name, X[:r], output_margin=margin,
                                   direct=direct)
            got = port_eng.predict(name, X[:r], output_margin=margin,
                                   direct=direct)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{r} rows")
