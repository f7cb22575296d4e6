"""Serving observability: per-model counters, queue depth, batch-size
histogram and latency quantiles (port of xgboost_tpu/serving/metrics.py).

Lock-cheap: counters under a mutex, latencies in a fixed ring buffer, so
the hot path pays O(1) a request.  ``snapshot()`` renders the state as a
plain dict, in the reference's shape; ``utils/observer.py`` can stream it.

Every mutation also feeds the process-default registry
(telemetry/registry.py) under the reference's names:
``xtb_serve_requests_total{model=}``, ``xtb_serve_rows_total``,
``xtb_serve_errors_total``, ``xtb_serve_batches_total``,
``xtb_serve_batch_rows`` (histogram), ``xtb_serve_latency_seconds``
(histogram), ``xtb_serve_exec_seconds_total``, ``xtb_serve_shed_total``,
``xtb_serve_deadline_total``, ``xtb_serve_queue_rows`` /
``xtb_serve_queue_peak`` (gauges) and ``xtb_compiles_warmup`` /
``xtb_compiles_steady{scope="serve"}``.  The registry's series are
process-cumulative (every engine adds to them); each ServingMetrics
instance reports its own engine.  Here a "compile" is a serve program
prepared: a CUDA graph captured on the card, an eager program on the CPU.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from ..ops.predict import round_up_pow2
from ..telemetry.registry import get_registry
from ..utils import observer

_RING = 2048  # latency samples kept per model (reservoir of the recent past)

# pow2 row buckets 1..4096 then +Inf: the admission policy's natural shape
_BATCH_BUCKETS = tuple(float(1 << i) for i in range(13))
# request latencies: 10us .. ~40s exponential
_LATENCY_BUCKETS = tuple(1e-5 * (4.0 ** i) for i in range(12))


class _Instruments:
    """Registry families for the serving subsystem (created once per
    process, shared by every engine)."""

    _singleton = None

    def __init__(self) -> None:
        reg = get_registry()
        self.requests = reg.counter(
            "xtb_serve_requests_total", "predict requests", ("model",))
        self.rows = reg.counter(
            "xtb_serve_rows_total", "rows predicted", ("model",))
        self.errors = reg.counter(
            "xtb_serve_errors_total", "failed predict requests", ("model",))
        self.batches = reg.counter(
            "xtb_serve_batches_total", "coalesced batches executed",
            ("model",))
        self.shed = reg.counter(
            "xtb_serve_shed_total",
            "requests shed at admission (queue full)", ("model",))
        self.deadline = reg.counter(
            "xtb_serve_deadline_total",
            "requests abandoned at their deadline", ("model",))
        self.exec_seconds = reg.counter(
            "xtb_serve_exec_seconds_total",
            "device-execute seconds (batch granularity)", ("model",))
        self.batch_rows = reg.histogram(
            "xtb_serve_batch_rows", "rows per coalesced batch", ("model",),
            buckets=_BATCH_BUCKETS)
        self.latency = reg.histogram(
            "xtb_serve_latency_seconds", "request latency", ("model",),
            buckets=_LATENCY_BUCKETS)
        self.queue_rows = reg.gauge(
            "xtb_serve_queue_rows", "rows waiting in the micro-batcher")
        self.queue_peak = reg.gauge(
            "xtb_serve_queue_peak", "high-water mark of queued rows")
        self.compiles_warmup = reg.counter(
            "xtb_compiles_warmup",
            "programs compiled during engine warm-up", ("scope",)
        ).labels("serve")
        self.compiles_steady = reg.counter(
            "xtb_compiles_steady",
            "backend compiles after warm-up (SLO: 0)", ("scope",)
        ).labels("serve")

    @classmethod
    def get(cls) -> "_Instruments":
        if cls._singleton is None:
            cls._singleton = cls()
        return cls._singleton


class _ModelStats:
    __slots__ = ("requests", "rows", "errors", "batches", "batch_hist",
                 "lat_ns", "lat_idx", "lat_n", "exec_ns", "batched_rows",
                 "shed", "deadline",
                 "reg_requests", "reg_rows", "reg_errors", "reg_batches",
                 "reg_exec_seconds", "reg_batch_rows", "reg_latency",
                 "reg_shed", "reg_deadline")

    def __init__(self, name: str, instruments: _Instruments) -> None:
        self.requests = 0
        self.rows = 0
        self.errors = 0
        self.batches = 0
        self.shed = 0
        self.deadline = 0
        self.batch_hist: Dict[int, int] = {}  # pow2 batch-rows bucket -> count
        self.lat_ns = np.zeros(_RING, np.int64)  # request latency ring
        self.lat_idx = 0
        self.lat_n = 0
        self.exec_ns = 0  # total device-execute time (batch granularity)
        self.batched_rows = 0  # rows covered by exec_ns (direct rows are not)
        ins = instruments  # this model's registry children, resolved once
        self.reg_requests = ins.requests.labels(name)
        self.reg_rows = ins.rows.labels(name)
        self.reg_errors = ins.errors.labels(name)
        self.reg_batches = ins.batches.labels(name)
        self.reg_exec_seconds = ins.exec_seconds.labels(name)
        self.reg_batch_rows = ins.batch_rows.labels(name)
        self.reg_latency = ins.latency.labels(name)
        self.reg_shed = ins.shed.labels(name)
        self.reg_deadline = ins.deadline.labels(name)

    def add_latency(self, ns: int) -> None:
        self.lat_ns[self.lat_idx] = ns
        self.lat_idx = (self.lat_idx + 1) % _RING
        self.lat_n = min(self.lat_n + 1, _RING)
        self.reg_latency.observe(ns / 1e9)

    def quantiles_ms(self):
        if self.lat_n == 0:
            return {"p50": None, "p95": None, "p99": None}
        lat = self.lat_ns[: self.lat_n] / 1e6
        p50, p95, p99 = np.percentile(lat, [50, 95, 99])
        return {"p50": float(p50), "p95": float(p95), "p99": float(p99)}


class ServingMetrics:
    """Thread-safe metrics registry shared by engine + batcher."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._models: Dict[str, _ModelStats] = {}
        self._queue_rows = 0  # rows waiting in the micro-batcher (gauge)
        self._queue_peak = 0
        self._compiles_warmup = 0  # programs compiled during warm-up
        self._compiles_steady = 0  # programs compiled after warm-up (SLO: 0)
        self._ins = _Instruments.get()

    # compiles_* kept assignable/incrementable attributes for API compat
    # (engine.warmup does `metrics.compiles_warmup += n`); positive deltas
    # flow into the process-wide registry counters
    @property
    def compiles_warmup(self) -> int:
        return self._compiles_warmup

    @compiles_warmup.setter
    def compiles_warmup(self, v: int) -> None:
        with self._lock:
            d = int(v) - self._compiles_warmup
            self._compiles_warmup = int(v)
        if d > 0:
            self._ins.compiles_warmup.inc(d)

    @property
    def compiles_steady(self) -> int:
        return self._compiles_steady

    @compiles_steady.setter
    def compiles_steady(self, v: int) -> None:
        with self._lock:
            d = int(v) - self._compiles_steady
            self._compiles_steady = int(v)
        if d > 0:
            self._ins.compiles_steady.inc(d)

    def _stats(self, model: str) -> _ModelStats:
        s = self._models.get(model)
        if s is None:
            s = self._models.setdefault(model,
                                        _ModelStats(model, self._ins))
        return s

    # ------------------------------------------------------------- hot path
    def observe_request(self, model: str, rows: int, latency_ns: int) -> None:
        with self._lock:
            s = self._stats(model)
            s.requests += 1
            s.rows += int(rows)
            s.add_latency(int(latency_ns))
        s.reg_requests.inc()
        s.reg_rows.inc(int(rows))

    def observe_batch(self, model: str, rows: int, n_requests: int,
                      exec_ns: int) -> None:
        with self._lock:
            s = self._stats(model)
            s.batches += 1
            s.exec_ns += int(exec_ns)
            s.batched_rows += int(rows)
            b = round_up_pow2(rows)
            s.batch_hist[b] = s.batch_hist.get(b, 0) + 1
        s.reg_batches.inc()
        s.reg_exec_seconds.inc(exec_ns / 1e9)
        s.reg_batch_rows.observe(float(rows))

    def observe_error(self, model: str) -> None:
        with self._lock:
            s = self._stats(model)
            s.errors += 1
        s.reg_errors.inc()

    def observe_shed(self, model: str) -> None:
        """A request rejected at admission (bounded-queue load shedding)."""
        with self._lock:
            s = self._stats(model)
            s.shed += 1
        s.reg_shed.inc()

    def observe_deadline(self, model: str) -> None:
        """A caller gave up at its deadline (slow or dead worker)."""
        with self._lock:
            s = self._stats(model)
            s.deadline += 1
        s.reg_deadline.inc()

    def queue_delta(self, d_rows: int) -> None:
        with self._lock:
            prev = self._queue_rows
            self._queue_rows = max(0, prev + int(d_rows))
            self._queue_peak = max(self._queue_peak, self._queue_rows)
            # the process gauge accumulates DELTAS so several engines sum
            # instead of overwriting each other (each engine's contribution
            # is its clamped local depth, so the sum stays >= 0 and exact);
            # published under the lock so a preempted stale writer cannot
            # interleave.  The peak is raised via the atomic set_max — a
            # read-then-set pair here could regress it across engines.
            self._ins.queue_rows.inc(self._queue_rows - prev)
            self._ins.queue_peak.set_max(self._ins.queue_rows.get())

    def note_steady_compiles(self, n: int) -> None:
        """Record serve programs prepared outside warm-up: the
        no-recompile SLO counter (a warm engine keeps it at zero).  The
        engine counts the programs a batch itself prepared; one prepared
        while another thread's warmup() runs is credited to warm-up."""
        with self._lock:
            self._compiles_steady += int(n)
        if n > 0:
            self._ins.compiles_steady.inc(int(n))

    # ------------------------------------------------------------- read side
    def queue_depth(self) -> int:
        with self._lock:
            return self._queue_rows

    def snapshot(self) -> dict:
        with self._lock:
            models = {}
            for name, s in self._models.items():
                q = s.quantiles_ms()
                total_s = s.exec_ns / 1e9
                models[name] = {
                    "requests": s.requests,
                    "rows": s.rows,
                    "errors": s.errors,
                    "shed": s.shed,
                    "deadline": s.deadline,
                    "batches": s.batches,
                    "batch_size_hist": {str(k): v for k, v in
                                        sorted(s.batch_hist.items())},
                    "latency_ms": q,
                    # throughput over BATCHED traffic only: exec_ns is
                    # accumulated per coalesced batch, so direct (un-timed)
                    # predict rows must not inflate the numerator
                    "rows_per_s": (s.batched_rows / total_s)
                    if total_s > 0 else None,
                }
            return {
                "queue_depth": self._queue_rows,
                "queue_peak": self._queue_peak,
                "compiles_warmup": self._compiles_warmup,
                "compiles_steady": self._compiles_steady,
                "models": models,
            }

    def export(self, tag: str = "serving") -> dict:
        """Snapshot + stream through the TrainingObserver channel when the
        debug observer is enabled (utils/observer.py)."""
        snap = self.snapshot()
        observer.observe_serving(snap, tag=tag)
        return snap

    def reset_latencies(self, model: Optional[str] = None) -> None:
        with self._lock:
            targets = ([self._models[model]] if model in self._models
                       else list(self._models.values()) if model is None
                       else [])
            for s in targets:
                s.lat_idx = s.lat_n = 0
