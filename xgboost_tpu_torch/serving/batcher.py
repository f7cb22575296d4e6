"""Dynamic micro-batcher: coalesce concurrent predict requests per model
(port of xgboost_tpu/serving/batcher.py).

Admission policy (the standard dynamic-batching contract, cf. arXiv:1806.11248
§6 where prediction throughput comes from batching rows, not threads): a
request joins the queue of its (model, options) key and the worker launches a
batch as soon as EITHER the queued rows reach ``max_batch`` OR the oldest
request has waited ``max_delay_us``.  Batches concatenate request rows in FIFO
order, run once through the engine's bucket program (a captured CUDA graph on
the card), and the result
is split back per caller — so N concurrent callers cost one program
execution instead of N, and tail latency is bounded by the admission delay
plus one batch execution.

A single worker thread executes all batches.  That is deliberate: launches
serialise on the interpreter anyway, so extra executor threads would only
add context switches; ordering through one worker also keeps results
deterministic.

Failure contract: the worker thread dying must never
wedge callers.  ``submit()`` probes worker liveness and raises
:class:`WorkerDiedError` (chained to the original worker exception) instead
of returning a future nobody will resolve; a worker that dies with requests
queued fails every pending future on its way down.  ``max_queue_rows``
bounds the queue — beyond it ``submit()`` sheds with :class:`QueueFullError`
(counted in ``xtb_serve_shed_total``) so an overloaded engine degrades by
rejecting fast, not by growing an unbounded backlog.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np

from ..reliability import faults as _faults
from ..telemetry import spans as _spans


class WorkerDiedError(RuntimeError):
    """The batcher worker thread is not running; ``__cause__`` carries the
    exception that killed it (when one escaped)."""


class QueueFullError(RuntimeError):
    """Request shed: admitting it would exceed ``max_queue_rows``."""


def _key_label(key: Any) -> str:
    return key[0] if isinstance(key, tuple) else str(key)


class _Request:
    __slots__ = ("X", "future", "t_enqueue_ns", "ctx")

    def __init__(self, X: np.ndarray, ctx: Any) -> None:
        self.X = X
        self.future: Future = Future()
        self.t_enqueue_ns = time.perf_counter_ns()
        self.ctx = ctx


class MicroBatcher:
    """``submit(key, X, ctx)`` -> Future of the per-request result rows.

    ``execute(key, X, ctx)`` is the engine callback running one coalesced
    batch; ``ctx`` is an opaque per-key context (resolved model snapshot +
    options) taken from the first request of the batch.
    """

    def __init__(self, execute: Callable[[Any, np.ndarray, Any], np.ndarray],
                 *, max_batch: int = 4096, max_delay_us: int = 2000,
                 max_queue_rows: Optional[int] = None, metrics=None) -> None:
        self._execute = execute
        self.max_batch = int(max_batch)
        self.max_delay_ns = int(max_delay_us) * 1000
        self.max_queue_rows = (int(max_queue_rows)
                               if max_queue_rows is not None else None)
        self._metrics = metrics
        self._queues: Dict[Any, Deque[_Request]] = {}
        self._rows: Dict[Any, int] = {}  # running per-key queued-row counts
        self._total_rows = 0             # across all keys (shed bound)
        self._cv = threading.Condition()
        self._closed = False
        self._worker_exc: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="xtb-serve-batcher")
        self._worker.start()

    # ------------------------------------------------------------------ API
    def worker_alive(self) -> bool:
        return self._worker.is_alive() and self._worker_exc is None

    def submit(self, key: Any, X: np.ndarray, ctx: Any = None) -> Future:
        req = _Request(X, ctx)
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if not self.worker_alive():
                # fail fast with the REAL cause — returning a future no
                # worker will ever resolve blocks the caller forever
                raise WorkerDiedError(
                    "micro-batcher worker thread is not running"
                ) from self._worker_exc
            if (self.max_queue_rows is not None
                    and self._total_rows + len(X) > self.max_queue_rows
                    and self._total_rows > 0):
                # shed under overload (a single oversized request with an
                # empty queue is still admitted — it must be servable)
                if self._metrics is not None:
                    self._metrics.observe_shed(_key_label(key))
                raise QueueFullError(
                    f"queue full: {self._total_rows} rows waiting "
                    f"(max_queue_rows={self.max_queue_rows})")
            self._queues.setdefault(key, deque()).append(req)
            self._rows[key] = self._rows.get(key, 0) + len(X)
            self._total_rows += len(X)
            if self._metrics is not None:
                self._metrics.queue_delta(len(X))
            self._cv.notify()
        return req.future

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join()

    # ---------------------------------------------------------------- worker
    def _drain(self, key: Any) -> List[_Request]:
        """Pop FIFO requests up to max_batch rows (always at least one live
        request, so an oversized single request still runs as its own
        batch).  Requests whose future was cancelled — a caller that gave
        up at its deadline — are discarded without consuming batch budget:
        executing them would burn device time producing results nobody
        reads, falling further behind and timing out MORE callers (may
        return an empty batch when everything queued was abandoned)."""
        q = self._queues[key]
        batch, popped, batch_rows = [], 0, 0
        while q:
            if q[0].future.cancelled():
                popped += len(q.popleft().X)
                continue
            if batch and batch_rows + len(q[0].X) > self.max_batch:
                break
            r = q.popleft()
            batch.append(r)
            popped += len(r.X)
            batch_rows += len(r.X)
        if q:
            self._rows[key] -= popped
        else:
            del self._queues[key]
            del self._rows[key]
        self._total_rows -= popped
        if self._metrics is not None:
            self._metrics.queue_delta(-popped)
        return batch

    def _run_batch(self, key: Any, batch: List[_Request]) -> None:
        # the whole prepare/execute/account sequence is guarded: an escaped
        # exception would kill the sole worker thread and leave every pending
        # and future submit() hanging on a future nobody will ever resolve
        try:
            X = (batch[0].X if len(batch) == 1
                 else np.concatenate([r.X for r in batch], axis=0))
            t0 = time.perf_counter_ns()
            if _spans.enabled():
                # admission wait of the batch head: enqueue -> launch (the
                # other latency component besides serve.execute); recorded
                # with the true start timestamp
                _spans.record_phase("serve.batch_wait",
                                    batch[0].t_enqueue_ns,
                                    t0 - batch[0].t_enqueue_ns)
            out = self._execute(key, X, batch[0].ctx)
            exec_ns = time.perf_counter_ns() - t0
            if self._metrics is not None:
                self._metrics.observe_batch(_key_label(key), len(X),
                                            len(batch), exec_ns)
        except BaseException as e:  # fan the failure out to every caller
            for r in batch:
                if not r.future.set_running_or_notify_cancel():
                    continue
                r.future.set_exception(e)
            return
        off = 0
        for r in batch:
            n = len(r.X)
            if r.future.set_running_or_notify_cancel():
                r.future.set_result(out[off:off + n])
            off += n

    def _loop(self) -> None:
        try:
            self._loop_impl()
        except BaseException as e:
            self._on_worker_death(e)

    def _on_worker_death(self, exc: BaseException) -> None:
        """The sole worker is gone: record why, fail every queued request
        (their futures would otherwise never resolve), wake everyone."""
        with self._cv:
            self._worker_exc = exc
            pending = [r for q in self._queues.values() for r in q]
            drained = self._total_rows
            self._queues.clear()
            self._rows.clear()
            self._total_rows = 0
            if self._metrics is not None and drained:
                self._metrics.queue_delta(-drained)
            self._cv.notify_all()
        err = WorkerDiedError("micro-batcher worker died with requests "
                              "queued")
        err.__cause__ = exc
        for r in pending:
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(err)

    def _loop_impl(self) -> None:
        while True:
            # seam: 'exception' here IS a worker-thread death — the
            # deterministic stand-in for a bug escaping _loop_impl
            _faults.maybe_inject("serve.worker")
            with self._cv:
                while True:
                    # scan EVERY key: a queue that reached max_batch launches
                    # now even while another key's delay window is still open
                    # (oldest-key-only evaluation would park a full batch
                    # behind a lone slow-filling key for the whole delay);
                    # among ready keys the oldest head keeps FIFO fairness
                    now = time.perf_counter_ns()
                    key, key_t, earliest = None, None, None
                    for k, q in self._queues.items():
                        if not q:
                            continue
                        head_t = q[0].t_enqueue_ns
                        deadline = head_t + self.max_delay_ns
                        rows = self._rows[k]
                        if (rows >= self.max_batch or deadline <= now
                                or self._closed):
                            if key_t is None or head_t < key_t:
                                key, key_t = k, head_t
                        elif earliest is None or deadline < earliest:
                            earliest = deadline
                    if key is not None:
                        batch = self._drain(key)
                        if not batch:  # all abandoned: rescan, don't execute
                            continue
                        break
                    if earliest is None:  # nothing queued at all
                        if self._closed:
                            return
                        # bounded idle wait: submit()/close()
                        # notify immediately; the periodic wake only
                        # re-checks _closed so a lost notification can
                        # never wedge the worker forever
                        self._cv.wait(timeout=1.0)
                    else:
                        self._cv.wait(timeout=(earliest - now) / 1e9)
            self._run_batch(key, batch)
            # the batch's context holds its snapshot: drop it before the
            # wait, or an evicted model's tensors outlive its eviction
            del batch
