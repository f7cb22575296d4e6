"""Serving degradation in the port (tests/test_serving_faults.py with
``device="cpu"``): the engine must never wedge a caller.

Failure modes under test: the micro-batcher worker
thread dying (submit fails fast with the original cause, pending futures
resolve exceptionally), bounded-queue load shedding (QueueFullError +
xtb_serve_shed_total), and per-request deadlines (predict raises
TimeoutError inside its SLO window instead of outliving it).
"""
import json
import threading
import time

import numpy as np
import pytest

import xgboost_tpu_torch as xtt
from xgboost_tpu_torch.reliability import FaultInjected, faults
from xgboost_tpu_torch.serving import (MicroBatcher, QueueFullError,
                                       ServingEngine, ServingMetrics,
                                       WorkerDiedError)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear()
    yield
    faults.clear()


def _train(seed=0, n=300, f=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    bst = xtt.train({"objective": "binary:logistic", "max_depth": 3},
                    xtt.DMatrix(X, label=y, device="cpu"), 3,
                    verbose_eval=False, device="cpu")
    return bst, X


def _wait_dead(batcher, timeout=5.0):
    deadline = time.monotonic() + timeout
    while batcher.worker_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not batcher.worker_alive(), "worker did not die"


# =========================================================================
# worker-death liveness


def test_submit_fails_fast_after_worker_death():
    """Satellite: a dead worker must turn submit() into an immediate error
    carrying the original worker exception as the cause — never a future
    that no one will resolve."""
    b = MicroBatcher(lambda k, X, c: X, max_delay_us=0)
    faults.install({"faults": [{"site": "serve.worker", "kind": "exception",
                                "message": "worker bug"}]})
    # wake the worker so it passes the seam and dies
    try:
        b.submit("k", np.zeros((2, 2), np.float32)).result(timeout=5)
    except Exception:
        pass  # served or failed depending on who won the race — both fine
    _wait_dead(b)
    t0 = time.monotonic()
    with pytest.raises(WorkerDiedError) as ei:
        b.submit("k", np.zeros((2, 2), np.float32))
    assert time.monotonic() - t0 < 1.0  # fail FAST, no deadline needed
    assert isinstance(ei.value.__cause__, FaultInjected)
    assert "worker bug" in str(ei.value.__cause__)
    b.close()


def test_pending_requests_fail_when_worker_dies():
    """Requests already queued when the worker dies resolve exceptionally
    (they would otherwise hang their callers forever)."""
    gate = threading.Event()

    def execute(key, X, ctx):
        gate.wait(10.0)
        return X

    b = MicroBatcher(execute, max_batch=2, max_delay_us=0)
    f1 = b.submit("a", np.zeros((2, 2), np.float32))  # drained, running
    time.sleep(0.1)
    f2 = b.submit("b", np.zeros((2, 2), np.float32))  # queued behind it
    # die on the NEXT loop iteration (after batch "a" completes)
    faults.install({"faults": [{"site": "serve.worker",
                                "kind": "exception"}]})
    gate.set()
    assert f1.result(timeout=10) is not None  # in-flight batch completes
    with pytest.raises(WorkerDiedError):
        f2.result(timeout=10)  # pending one fails, promptly
    _wait_dead(b)
    b.close()


def test_engine_predict_raises_and_counts_after_worker_death():
    bst, X = _train()
    eng = ServingEngine(max_delay_us=100, warmup_buckets=(8,), device="cpu")
    eng.add_model("m", bst)
    assert eng.predict("m", X[:8]).shape == (8,)
    faults.install({"faults": [{"site": "serve.worker", "kind": "exception",
                                "message": "killed"}]})
    try:
        eng.predict("m", X[:8])  # wakes the worker into the seam
    except Exception:
        pass
    _wait_dead(eng._batcher)
    errors_before = eng.metrics.snapshot()["models"]["m"]["errors"]
    with pytest.raises(WorkerDiedError):
        eng.predict("m", X[:8])
    assert (eng.metrics.snapshot()["models"]["m"]["errors"]
            == errors_before + 1)
    eng.close()  # dead worker: close() must return, not hang


def test_direct_predict_survives_dead_worker():
    """direct=True bypasses the batcher: a degraded engine can still serve
    inline while the operator investigates."""
    bst, X = _train(seed=1)
    eng = ServingEngine(max_delay_us=100, warmup_buckets=(8,), device="cpu")
    eng.add_model("m", bst)
    faults.install({"faults": [{"site": "serve.worker", "kind": "exception"}]})
    try:
        eng.predict("m", X[:8])
    except Exception:
        pass
    _wait_dead(eng._batcher)
    faults.clear()
    out = eng.predict("m", X[:8], direct=True)
    assert out.shape == (8,) and np.all(np.isfinite(out))
    eng.close()


# =========================================================================
# bounded queue / load shedding


def test_queue_bound_sheds_and_counts():
    gate = threading.Event()

    def execute(key, X, ctx):
        gate.wait(10.0)
        return X

    m = ServingMetrics()
    b = MicroBatcher(execute, max_batch=4, max_delay_us=0, max_queue_rows=8,
                     metrics=m)
    f1 = b.submit(("mod",), np.zeros((4, 2), np.float32))
    time.sleep(0.05)  # let the worker drain f1 into a running batch
    f2 = b.submit(("mod",), np.zeros((8, 2), np.float32))  # fills the bound
    with pytest.raises(QueueFullError):
        b.submit(("mod",), np.zeros((1, 2), np.float32))
    snap = m.snapshot()
    assert snap["models"]["mod"]["shed"] == 1
    gate.set()
    f1.result(10)
    f2.result(10)
    b.close()
    from xgboost_tpu_torch.telemetry import render_prometheus

    assert 'xtb_serve_shed_total{model="mod"}' in render_prometheus()


def test_oversized_single_request_admitted_on_empty_queue():
    """The bound sheds BACKLOG, not capability: one request larger than
    max_queue_rows still runs when nothing is queued."""
    b = MicroBatcher(lambda k, X, c: X, max_batch=4, max_delay_us=0,
                     max_queue_rows=8)
    out = b.submit("k", np.zeros((32, 2), np.float32)).result(timeout=10)
    assert out.shape == (32, 2)
    b.close()


# =========================================================================
# per-request deadline


def test_predict_deadline_raises_within_slo():
    bst, X = _train(seed=2)
    eng = ServingEngine(max_delay_us=100, warmup_buckets=(8,),
                        request_timeout_s=0.3, device="cpu")
    eng.add_model("m", bst)
    gate = threading.Event()
    real = eng._batcher._execute

    def stalled(key, Xb, ctx):
        gate.wait(10.0)
        return real(key, Xb, ctx)

    eng._batcher._execute = stalled
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="deadline"):
        eng.predict("m", X[:8])
    assert time.monotonic() - t0 < 2.0
    snap = eng.metrics.snapshot()["models"]["m"]
    assert snap["deadline"] == 1 and snap["errors"] == 1
    gate.set()
    eng._batcher._execute = real
    # engine recovers once the stall clears
    assert eng.predict("m", X[:8]).shape == (8,)
    eng.close()
    from xgboost_tpu_torch.telemetry import render_prometheus

    assert 'xtb_serve_deadline_total{model="m"}' in render_prometheus()


def test_serve_config_validates_degradation_knobs():
    from xgboost_tpu_torch.serving import ServeConfig

    with pytest.raises(ValueError):
        ServeConfig(request_timeout_s=0.0)
    with pytest.raises(ValueError):
        ServeConfig(max_queue_rows=0)
    cfg = ServeConfig(request_timeout_s=1.5, max_queue_rows=100)
    assert cfg.request_timeout_s == 1.5 and cfg.max_queue_rows == 100


# =========================================================================
# the plan itself


def test_fault_plan_matchers_and_counts(monkeypatch):
    plan = faults.install(json.dumps({"faults": [
        {"site": "serve.worker", "kind": "exception", "at": 2},
        {"site": "serve.worker", "kind": "delay", "seconds": 0.0,
         "times": 2, "rank": 1}]}))
    assert faults.active() is plan
    assert faults.maybe_inject("serve.worker", rank=0) is None  # hit 0
    spec = faults.maybe_inject("serve.worker", rank=lambda: 1)  # hit 1
    assert spec.kind == "delay"
    with pytest.raises(FaultInjected, match="serve.worker"):
        faults.maybe_inject("serve.worker", rank=1)  # hit 2: `at` wins
    assert faults.maybe_inject("serve.worker", rank=1).kind == "delay"
    assert faults.maybe_inject("serve.worker", rank=1) is None  # used up
    assert plan.fired() == 3 and plan.fired("other.site") == 0
    from xgboost_tpu_torch.telemetry import render_prometheus

    assert ('xtb_faults_injected_total{site="serve.worker",kind="delay"} 2'
            in render_prometheus())
    faults.clear()
    monkeypatch.setenv(faults.ENV_VAR, json.dumps(
        [{"site": "serve.worker", "kind": "exception"}]))
    assert faults.active().specs[0].kind == "exception"


def test_fault_plan_rejects_unknown_kinds_and_keys():
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultSpec(site="serve.worker", kind="melt")
    with pytest.raises(ValueError, match="unknown fault-spec keys"):
        faults.FaultPlan.from_dict([{"site": "serve.worker",
                                     "kind": "exception", "when": 1}])
