"""ServingEngine: batched multi-model inference with latency SLOs (port of
xgboost_tpu/serving/engine.py).

Three ideas, as in the reference:

1. **Prepared bucket programs.**  Requests pad to row buckets
   (ops/predict.py ``bucket_rows``).  On the card each (snapshot, bucket,
   output kind) is a CUDA graph, captured once and replayed: the
   traversal, the base score and the objective's transform (K4's sigmoid
   for ``binary:logistic``) in one replay, where eager PyTorch makes a
   launch per operation.  After ``warmup()`` steady traffic captures
   nothing; ``compile_cache_size()`` is the gauge (prepared programs
   alive, ops/predict.py ``predict_cache_size``) that must not grow once
   warm.  On the CPU a program runs the same functions eagerly and the
   gauge counts prepared programs, so "no recompile after warm-up" means
   the same on both devices.
2. **Dynamic micro-batching.**  Concurrent callers coalesce per
   (model, version, options) key up to ``max_batch`` rows or
   ``max_delay_us`` (batcher.py); one worker executes, results split per
   caller.
3. **Hot-model residency.**  Snapshots live in a ModelRegistry with LRU
   eviction and version pinning (registry.py); an evicted snapshot's
   graphs, static buffers and pinned staging are released at once.

A graph program (``_Program``, one a snapshot) holds, per (bucket, output
kind), a static (B, F) f32 input and the (B, K) output the graph writes,
both on the card, and pinned host buffers for the copies in and out.  The
snapshot's graphs share one memory pool, so one graph's output may lie
where another keeps its intermediates: the program's lock is held from the
copy into the static input to the end of the copy back to the host (the
reference's ``donate_lock``), and no other graph of the snapshot replays
in between.  Only the R rows
of a batch are copied in: the rows past R keep an earlier batch's values
(NaN from the capture, or real rows), which change nothing, since rows are
independent and sliced off.  A capture or a failed capture never falls
back to an eager run on the card: it raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import weakref
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..ops import hist_cuda
from ..ops.predict import (_MIN_ROW_BUCKET, _POW2_ROW_CEILING, bucket_rows,
                           note_programs, note_replay, pad_rows,
                           predict_cache_size)
from ..telemetry import span
from .batcher import MicroBatcher
from .metrics import ServingMetrics
from .registry import ModelRegistry
from .snapshot import InferenceSnapshot

__all__ = ["ServeConfig", "ServingEngine"]


@dataclasses.dataclass
class ServeConfig:
    """SLO knobs."""

    max_batch: int = 4096        # admission: batch launches at this many rows
    max_delay_us: int = 2000     # admission: ... or when the oldest waited this
    max_models: int = 8          # LRU residency cap (registry)
    # row buckets prepared up front; None = every bucket the admission
    # policy can produce (<= max_batch rows), so batched traffic never
    # captures at steady state.  A single request larger than max_batch
    # runs as its own oversized batch and captures on first hit.
    warmup_buckets: Optional[Tuple[int, ...]] = None
    use_batcher: bool = True     # False = every predict() runs inline
    # a per-request deadline in seconds (None = wait forever), and a bound
    # on queued rows beyond which submit() sheds (QueueFullError)
    request_timeout_s: Optional[float] = None
    max_queue_rows: Optional[int] = None
    # where snapshots live: None keeps a Booster's own device (a model
    # path loads onto the card); "cpu", "cuda", ... move them there
    device: Optional[str] = None

    def __post_init__(self) -> None:
        if self.max_batch < 1 or self.max_delay_us < 0:
            raise ValueError("max_batch >= 1 and max_delay_us >= 0 required")
        if self.request_timeout_s is not None and self.request_timeout_s <= 0:
            raise ValueError("request_timeout_s must be positive or None")
        if self.max_queue_rows is not None and self.max_queue_rows < 1:
            raise ValueError("max_queue_rows must be >= 1 or None")

    def resolved_warmup_buckets(self) -> Tuple[int, ...]:
        if self.warmup_buckets is not None:
            return self.warmup_buckets
        top = bucket_rows(self.max_batch)
        out, b = [], _MIN_ROW_BUCKET
        while b < min(top, _POW2_ROW_CEILING):
            out.append(b)
            b *= 2
        while b < top:  # past the pow2 ceiling buckets step by the ceiling
            out.append(b)
            b += _POW2_ROW_CEILING
        out.append(top)
        return tuple(out)


class _SharedExclusive:
    """A lock that replays share and captures take alone (a writer that
    waits holds new readers back).  A capture must not overlap another
    thread's copies, frees or pinned allocations: the allocator and the
    pinned pool are process-wide, so one lock serves every engine."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._readers = 0
        self._writer = False
        self._waiting = 0

    @contextlib.contextmanager
    def shared(self):
        with self._cv:
            while self._writer or self._waiting:
                self._cv.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cv:
                self._readers -= 1
                if not self._readers:
                    self._cv.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cv:
            self._waiting += 1
            try:
                while self._writer or self._readers:
                    self._cv.wait()
            finally:
                self._waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cv:
                self._writer = False
                self._cv.notify_all()


_device_lock = _SharedExclusive()


class _Graph:
    """One captured (bucket, output kind) on the card."""

    __slots__ = ("graph", "x_dev", "out_dev", "x_host", "out_host", "x_np",
                 "out_np", "done", "kernels")


def _release_count(cell) -> None:
    note_programs(-cell[0])
    cell[0] = 0


class _Program:
    """A snapshot's serve programs, one per (bucket, features, output
    kind): captured CUDA graphs on the card, eager programs on the CPU.
    Rides on the snapshot (``_serve_prog``) and takes it as an argument,
    so the two form no reference cycle and die together."""

    def __init__(self, snap: InferenceSnapshot) -> None:
        self.device = snap.device
        self.cuda = self.device.type == "cuda"
        self.base = torch.from_numpy(snap.base_score.copy()).to(self.device)
        self._lock = threading.Lock()  # creation and release of entries
        self._run_lock = threading.Lock()  # copy in, replay, copy out
        self._entries: dict = {}
        # programs alive, given back to the gauge at release or when the
        # snapshot dies (a hot swap replaces it without an eviction)
        self._count = [0]
        weakref.finalize(self, _release_count, self._count)
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()  # the graphs share it

    def _compute(self, snap: InferenceSnapshot, X, output_margin: bool):
        """base + margin, then the transform unless the margin is asked
        for: what ``Booster.predict`` computes, on the batch's device."""
        margin = snap.margin_padded(X) + self.base[None, :]
        return margin if output_margin else snap.transform(margin)

    def run(self, snap: InferenceSnapshot, X: np.ndarray,
            output_margin: bool) -> Tuple[np.ndarray, int]:
        """The (R, K) host output of a batch ((R,) under an argmax
        transform), and the programs this call prepared (0 or 1)."""
        R, F = X.shape
        key = (bucket_rows(R), F, bool(output_margin))
        entry = self._entries.get(key)
        made = 0
        if entry is None:
            with self._lock:
                entry = self._entries.get(key)
                if entry is None:
                    entry = self._prepare(snap, key)
                    self._entries[key] = entry
                    self._count[0] += 1
                    note_programs(1)
                    made = 1
        if not self.cuda:
            Xp = pad_rows(torch.from_numpy(X), key[0])
            return self._compute(snap, Xp, key[2])[:R].numpy(), made
        return self._replay(entry, X), made

    def _prepare(self, snap: InferenceSnapshot, key):
        """Capture the graph of ``key`` on the card (True on the CPU,
        where the program is the eager functions):
        one eager run on the program's stream, which loads K4's library
        and settles the caching allocator, then the capture, with no
        other thread's device work in between."""
        if not self.cuda:
            return True
        B, F, output_margin = key
        g = _Graph()
        with _device_lock.exclusive(), torch.cuda.device(self.device):
            g.x_dev = torch.full((B, F), float("nan"), dtype=torch.float32,
                                 device=self.device)
            g.x_host = torch.empty((B, F), dtype=torch.float32,
                                   pin_memory=True)
            g.done = torch.cuda.Event()
            s = self.stream
            s.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(s):
                self._compute(snap, g.x_dev, output_margin)
            s.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(s), hist_cuda.capturing() as kernels:
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    out = self._compute(snap, g.x_dev, output_margin)
                finally:
                    graph.capture_end()
            s.synchronize()
            # (B, K), or (B,) where the transform is an argmax
            g.out_host = torch.empty(out.shape, dtype=torch.float32,
                                     pin_memory=True)
        g.x_np, g.out_np = g.x_host.numpy(), g.out_host.numpy()
        g.graph, g.out_dev, g.kernels = graph, out, tuple(kernels)
        return g

    def _replay(self, g: _Graph, X: np.ndarray) -> np.ndarray:
        R = X.shape[0]
        with _device_lock.shared(), self._run_lock:
            np.copyto(g.x_np[:R], X)
            with torch.cuda.stream(self.stream):
                g.x_dev[:R].copy_(g.x_host[:R], non_blocking=True)
                g.graph.replay()
                g.out_host[:R].copy_(g.out_dev[:R], non_blocking=True)
                g.done.record(self.stream)
            g.done.synchronize()
            out = g.out_np[:R].copy()
        note_replay()
        hist_cuda.replayed(g.kernels)
        return out

    def release(self) -> None:
        """Free the graphs, static buffers and pinned staging.  A later
        batch on this snapshot prepares its programs again."""
        with self._lock, _device_lock.exclusive():
            entries, self._entries = self._entries, {}
            entries.clear()  # no replay runs: they share the device lock
            _release_count(self._count)


class ServingEngine:
    def __init__(self, config: Optional[ServeConfig] = None, **overrides,
                 ) -> None:
        if config is None:
            config = ServeConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.metrics = ServingMetrics()
        self.registry = ModelRegistry(max_models=config.max_models,
                                      device=config.device)
        self.registry.add_retire_hook(self._on_retire)
        self._batcher: Optional[MicroBatcher] = (
            MicroBatcher(self._execute, max_batch=config.max_batch,
                         max_delay_us=config.max_delay_us,
                         max_queue_rows=config.max_queue_rows,
                         metrics=self.metrics)
            if config.use_batcher else None)
        self._warming = 0  # >0 while warmup() runs (attributes its programs)
        self._warm_lock = threading.Lock()  # += / -= are not atomic
        self._prog_lock = threading.Lock()
        self._closed = False

    # ----------------------------------------------------------- model admin
    def add_model(self, name: str, source, *, version: Optional[int] = None,
                  warmup: bool = True) -> int:
        """Register a Booster (or .json/.ubj model path) and optionally
        prepare its warm-up bucket programs."""
        v = self.registry.register(name, source, version=version)
        if warmup:
            self.warmup(name, version=v)
        return v

    def warmup(self, name: str, version: Optional[int] = None,
               buckets: Optional[Tuple[int, ...]] = None) -> int:
        """Prepare the bucket programs (margin and transformed output) of
        ``buckets``, so steady requests never capture.  Returns the number
        of programs prepared."""
        snap, v = self.registry.get(name, version)
        before = self.compile_cache_size()
        with self._warm_lock:
            self._warming += 1
        try:
            for b in sorted(set(buckets
                                or self.config.resolved_warmup_buckets())):
                X = np.full((int(b), max(snap.num_features, 1)), np.nan,
                            np.float32)
                self._execute((name, v, False), X, (snap, False))
                self._execute((name, v, True), X, (snap, True))
        finally:
            with self._warm_lock:
                self._warming -= 1
        compiled = self.compile_cache_size() - before
        self.metrics.compiles_warmup += compiled
        return compiled

    def pin(self, name: str, version: int) -> None:
        self.registry.pin(name, version)

    def unpin(self, name: str) -> None:
        self.registry.unpin(name)

    # -------------------------------------------------------------- predict
    def predict(self, name: str, X, *, version: Optional[int] = None,
                output_margin: bool = False, direct: bool = False,
                ) -> np.ndarray:
        """Predict rows of ``X`` with ``name`` (latest / pinned version).

        Goes through the micro-batcher unless ``direct=True`` (or the engine
        was built with ``use_batcher=False``).  Output matches
        ``Booster.predict``: (R,) for single-group models, else (R, K).
        A DMatrix's ``base_margin`` is refused (it cannot ride a coalesced
        batch; use ``Booster.predict`` for that)."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        t0 = time.perf_counter_ns()
        try:
            # inside the guarded region so unknown/evicted-version failures
            # land in the per-model error counter too
            snap, v = self.registry.get(name, version)
            key = (name, v, bool(output_margin))
            Xn = self._as_batch(snap, X)
            if direct or self._batcher is None:
                out = self._execute(key, Xn, (snap, output_margin))
            else:
                fut = self._batcher.submit(key, Xn, (snap, output_margin))
                try:
                    out = fut.result(timeout=self.config.request_timeout_s)
                except FuturesTimeout:
                    # deadline expired: abandon the request (cancel if it
                    # has not launched) and raise within the SLO window
                    fut.cancel()
                    self.metrics.observe_deadline(name)
                    raise TimeoutError(
                        f"predict({name!r}) missed its "
                        f"{self.config.request_timeout_s}s deadline "
                        f"(worker alive: {self._batcher.worker_alive()})"
                    ) from None
        except BaseException:
            self.metrics.observe_error(name)
            raise
        self.metrics.observe_request(name, len(Xn),
                                     time.perf_counter_ns() - t0)
        # squeeze from the output width, not the submit-time snapshot: a
        # same-version hot swap between submit and execute serves the new
        # snapshot, whose group count may differ (multi:softmax's argmax
        # is (R,) already)
        return out[:, 0] if out.ndim == 2 and out.shape[1] == 1 else out

    # ------------------------------------------------------------ internals
    @staticmethod
    def _as_batch(snap: InferenceSnapshot, X) -> np.ndarray:
        if hasattr(X, "host_dense"):  # DMatrix: recode cats like predict
            if getattr(X, "base_margin", None) is not None:
                raise ValueError(
                    "the serving engine does not apply DMatrix base_margin "
                    "(a per-request starting margin cannot ride a coalesced "
                    "batch); use Booster.predict for margin-adjusted scoring")
            X = snap.host_dense_recoded(X)
        X = np.ascontiguousarray(X, np.float32)
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2:
            raise ValueError(f"expected (rows, features), got shape {X.shape}")
        if snap.num_features and X.shape[1] != snap.num_features:
            raise ValueError(
                f"feature shape mismatch: model has {snap.num_features} "
                f"features, input has {X.shape[1]}")
        return X

    def _prog(self, snap: InferenceSnapshot) -> _Program:
        prog = getattr(snap, "_serve_prog", None)
        if prog is None:
            # locked check-then-set: warmup() and the batcher worker can hit
            # a fresh snapshot at once
            with self._prog_lock:
                prog = getattr(snap, "_serve_prog", None)
                if prog is None:
                    prog = _Program(snap)
                    snap._serve_prog = prog  # rides the registry lifetime
        return prog

    @staticmethod
    def _on_retire(name, version, reason, snap) -> None:
        prog = getattr(snap, "_serve_prog", None)
        if prog is not None:
            prog.release()

    def _execute(self, key: Any, X: np.ndarray, ctx) -> np.ndarray:
        """Run one (possibly coalesced) batch.  Called by the batcher worker
        or inline for direct predicts; returns host (R, K) outputs."""
        snap, output_margin = ctx
        # re-resolve at execute time: a register() hot swap of this (name,
        # version) between submit and execute serves the current snapshot
        # for the whole batch; fall back to the submit-time snapshot if it
        # was evicted meanwhile, or if the replacement's feature count no
        # longer matches this batch (requests were validated against the
        # submit-time snapshot)
        try:
            cur, _ = self.registry.get(key[0], key[1])
            if not cur.num_features or cur.num_features == X.shape[1]:
                snap = cur
        except KeyError:
            pass
        with span("serve.execute"):
            out, made = self._prog(snap).run(snap, X, bool(output_margin))
        if made and not self._warming:
            self.metrics.note_steady_compiles(made)
        return out

    # ---------------------------------------------------------------- admin
    def compile_cache_size(self) -> int:
        """Serve programs alive (captured graphs on the card).  Flat after
        warm-up == the no-recompile SLO holds.  Process-wide: another
        engine's captures move it too."""
        return predict_cache_size()

    def metrics_snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        snap["compiled_programs"] = self.compile_cache_size()
        snap["resident_models"] = len(self.registry)
        snap["resident_bytes"] = self.registry.resident_bytes()
        return snap

    def close(self) -> None:
        """Stop the batcher and free the resident models' programs (on the
        card: their graphs, static buffers and pinned staging)."""
        with self._warm_lock:
            if self._closed:
                return
            self._closed = True
        if self._batcher is not None:
            self._batcher.close()
        for snap in self.registry.snapshots():
            self._on_retire(None, None, "closed", snap)

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
