"""Collective communication API (port of xgboost_tpu/collective.py;
reference python-package/xgboost/collective.py, src/collective/).

The flat functions below dispatch through a thin backend trait (the role of
the reference's ``Coll`` interface and ``CommGroup`` backend select,
src/collective/coll.h:23, comm_group.cc:99), so the growers, the sketch
merge and the metrics do not know which backend is live:

- ``SingleProcessBackend``: world size 1, the identity.
- ``TorchDistributedBackend``: one worker per process.  In direct mode
  (``coordinator_address``, ``num_processes``, ``process_id``) a gloo
  process group of ``torch.distributed``; host arrays travel as CPU byte
  tensors through gloo's allgather.  In tracker mode
  (``dmlc_tracker_uri``, ``dmlc_tracker_port``, ``dmlc_task_id``) a
  ``tracker.TrackerClient`` takes the worker's rank and world from a
  ``RabitTracker`` and keeps its connection as the error channel; the
  gathers then go through the tracker's socket relay, or through a gloo
  group at the coordinator address rank 0 reported.  The reference picks
  by its JAX platform; the port has none, so the caller passes the
  worker's ``device`` to ``init``: with ``XGBOOST_TPU_COLL=auto`` (the
  default) a worker on the CPU (``device="cpu"``) takes the relay and any
  other the gloo group; ``relay`` and ``gloo`` force one.
- ``InMemoryBackend``: N threads of one process, each with its own rank
  (src/collective/in_memory_communicator.h:18), selected per thread with
  ``dmlc_communicator="in-memory"``.

Every backend's primitive is ``allgather``: an allreduce is a numpy
reduction of the gathered ``(world, ...)`` stack in rank order, the same
on every rank, so every rank sees the same bits (an f32 sum included) and
grows the same trees.  gloo's own all_reduce is never called: its ring
order would differ from rank to rank.

Not ported: the federated communicator (ROADMAP Queue 1 item 9b.4) and
elastic membership (join, leave, regroup; item 9b.3) raise
``NotImplementedError``; the watchdog, fault seams and telemetry hooks of
the reference's collective are left out (item 11).
"""
from __future__ import annotations

import datetime
import os
import pickle
import socket
import sys
import threading
from enum import IntEnum
from typing import Any, Dict, List, Optional

import numpy as np

from .tracker import COLL_TIMEOUT

__all__ = [
    "init", "finalize", "get_rank", "get_world_size", "is_distributed",
    "communicator_print", "get_processor_name", "broadcast", "allreduce",
    "allgather", "allgather_ragged", "signal_error", "Op",
    "global_sum", "global_max", "global_ratio", "reduce_stacked",
    "regroup", "CommunicatorContext", "CollBackend",
    "SingleProcessBackend", "TorchDistributedBackend", "InMemoryBackend",
]

_ELASTIC = "(ROADMAP Queue 1 item 9b.3)"
_FEDERATED = "(ROADMAP Queue 1 item 9b.4)"


class Op(IntEnum):
    """Reduce ops (reference: Op enum, src/collective/comm.h:186)."""

    MAX = 0
    MIN = 1
    SUM = 2
    BITWISE_AND = 3
    BITWISE_OR = 4
    BITWISE_XOR = 5


_REDUCERS = {
    Op.SUM: np.sum, Op.MAX: np.max, Op.MIN: np.min,
    Op.BITWISE_AND: np.bitwise_and.reduce,
    Op.BITWISE_OR: np.bitwise_or.reduce,
    Op.BITWISE_XOR: np.bitwise_xor.reduce,
}


def reduce_stacked(gathered: np.ndarray, op: Op, dtype) -> np.ndarray:
    """The reduction of a gathered ``(world, ...)`` stack over its first
    axis, in rank order, cast to ``dtype``: what every rank computes from
    the same stack (reference collective.py:56 ``_reduce_stacked``)."""
    red = _REDUCERS.get(op)
    if red is None:
        raise NotImplementedError(f"allreduce op {op!r} not supported")
    return red(gathered, axis=0).astype(dtype)


# ---------------------------------------------------------------------------
# Backend trait (Coll, coll.h:23)
# ---------------------------------------------------------------------------


class CollBackend:
    """A collective backend: rank, world and allgather are its primitives;
    allreduce and broadcast derive from the gather."""

    def rank(self) -> int:
        raise NotImplementedError

    def world_size(self) -> int:
        raise NotImplementedError

    def allgather(self, data: np.ndarray) -> np.ndarray:
        """(world, *data.shape): every worker's identically shaped array."""
        raise NotImplementedError

    def allreduce(self, data: np.ndarray, op: Op) -> np.ndarray:
        return reduce_stacked(self.allgather(data), op, data.dtype)

    def broadcast_bytes(self, payload: Optional[bytes], root: int) -> bytes:
        """A length-prefixed broadcast made of two gathers."""
        me = self.rank()
        n = np.asarray([len(payload) if me == root else 0], np.int64)
        size = int(self.allgather(n)[root, 0])
        buf = np.zeros(size, np.uint8)
        if me == root:
            buf[:] = np.frombuffer(payload, np.uint8)
        return bytes(self.allgather(buf)[root])

    def abort(self, msg: str = "") -> None:
        """Make the peers' pending and later collectives raise (a failed
        rank's signal); a no-op where a peer's failure already surfaces as
        a broken connection."""

    def shutdown(self) -> None:
        pass


class SingleProcessBackend(CollBackend):
    """world_size == 1: the identity (the reference degrades the same)."""

    def rank(self) -> int:
        return 0

    def world_size(self) -> int:
        return 1

    def allgather(self, data: np.ndarray) -> np.ndarray:
        return np.asarray(data)[None]

    def allreduce(self, data: np.ndarray, op: Op) -> np.ndarray:
        return np.asarray(data).copy()

    def broadcast_bytes(self, payload, root):
        return payload


# how long a rank waits in a rendezvous or a collective for its peers
# before it raises (reference collective.py:443-445), the relay's bound too
_TIMEOUT = datetime.timedelta(seconds=COLL_TIMEOUT)


class TorchDistributedBackend(CollBackend):
    """One worker per process (the role of the reference's
    JaxDistributedBackend).  Direct mode: ``coordinator_address``
    ("host:port" or "tcp://host:port"), ``num_processes`` and
    ``process_id`` start a gloo process group.  Tracker mode:
    ``dmlc_tracker_uri`` and ``dmlc_tracker_port`` (``dmlc_task_id`` a
    sort hint, not a rank) join a ``RabitTracker``, which assigns the rank;
    the gathers take its relay or a gloo group at its coordinator (module
    docstring; ``device`` the worker's).  Without either it only reports a
    process group someone else initialized.  The gloo gather moves host
    bytes: each array is sent as a uint8 CPU tensor of its bytes, so every
    dtype crosses unchanged."""

    def __init__(self, **args: Any) -> None:
        self._owned = False
        self._tracker = None
        self._relay_mode = False
        self._signalled = False
        uri, port = args.get("dmlc_tracker_uri"), args.get("dmlc_tracker_port")
        if uri and port:
            self._join_tracker(str(uri), int(port), args)
            return
        if uri or port:
            # a worker that meant to join a job must not train its shard
            # alone (reference collective.py:235-242)
            raise ValueError(
                "tracker rendezvous needs BOTH dmlc_tracker_uri and "
                f"dmlc_tracker_port; got uri={uri!r} port={port!r}")
        coordinator = args.get("coordinator_address")
        if coordinator is None:
            return
        if args.get("num_processes") is None or args.get("process_id") is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        self._init_gloo(str(coordinator), int(args["process_id"]),
                        int(args["num_processes"]))

    def _join_tracker(self, uri: str, port: int, args: Dict[str, Any]) -> None:
        from .tracker import TrackerClient

        mode = os.environ.get("XGBOOST_TPU_COLL", "auto")
        if mode not in ("auto", "relay", "gloo"):
            raise ValueError(f"XGBOOST_TPU_COLL must be auto, relay or gloo, "
                             f"not {mode!r}")
        t = TrackerClient(uri, port, task_id=str(args.get("dmlc_task_id", "")))
        self._tracker = t
        device = str(args.get("device") or "")
        self._relay_mode = (
            t.coll_port is not None and t.world > 1
            and (mode == "relay"
                 or (mode == "auto" and device.split(":")[0] == "cpu")))
        if self._relay_mode:
            return
        try:
            self._init_gloo(t.coordinator, t.rank, t.world)
        except Exception as e:
            # rank 0's store may have lost the coordinator port to another
            # process since it reported it: end the job through the
            # tracker rather than leave the peers waiting on the store
            msg = (f"rank {t.rank}: the gloo process group at the "
                   f"tracker's coordinator {t.coordinator} failed: {e}")
            t.signal_error(msg)
            t.shutdown()
            self._tracker = None
            raise RuntimeError(msg) from e

    def _init_gloo(self, coordinator: str, rank: int, world: int) -> None:
        import torch.distributed as dist

        addr = coordinator if "://" in coordinator else "tcp://" + coordinator
        if dist.is_initialized():
            raise RuntimeError("torch.distributed is already initialized")
        dist.init_process_group("gloo", init_method=addr, rank=rank,
                                world_size=world, timeout=_TIMEOUT)
        self._owned = True

    @staticmethod
    def _live() -> bool:
        import torch.distributed as dist

        return dist.is_available() and dist.is_initialized()

    def rank(self) -> int:
        if self._relay_mode:
            return self._tracker.rank
        if not self._live():
            return 0
        import torch.distributed as dist

        return dist.get_rank()

    def world_size(self) -> int:
        if self._relay_mode:
            return self._tracker.world
        if not self._live():
            return 1
        import torch.distributed as dist

        return dist.get_world_size()

    def allgather(self, data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data)
        if self._relay_mode:
            return self._tracker.coll_allgather(data)
        world = self.world_size()
        if world == 1:
            return data[None]
        import torch
        import torch.distributed as dist

        raw = torch.from_numpy(data.reshape(-1).view(np.uint8).copy())
        out = [torch.empty_like(raw) for _ in range(world)]
        dist.all_gather(out, raw)
        return np.stack([o.numpy().view(data.dtype).reshape(data.shape)
                         for o in out])

    def abort(self, msg: str = "") -> None:
        """Tell the tracker, once, that this worker failed: it aborts the
        others.  Without a tracker a peer's failure surfaces in gloo."""
        if self._tracker is not None and not self._signalled:
            self._signalled = True
            self._tracker.signal_error(msg or "a worker failed")

    def shutdown(self) -> None:
        if self._owned and self._live():
            import torch.distributed as dist

            dist.destroy_process_group()
        self._owned = False
        self._relay_mode = False
        if self._tracker is not None:
            self._tracker.shutdown()
            self._tracker = None


class _InMemoryGroup:
    """Shared rendezvous state of the thread workers of one group."""

    def __init__(self, world: int) -> None:
        self.world = world
        self.barrier = threading.Barrier(world)
        self.slots: List[Optional[np.ndarray]] = [None] * world


_INMEM_GROUPS: Dict[str, _InMemoryGroup] = {}
_INMEM_LOCK = threading.Lock()


class InMemoryBackend(CollBackend):
    """N threads of one process exchanging through shared memory
    (reference in_memory_communicator.h:18, the thread-worker harness of
    tests/cpp/collective/test_worker.h:155).  Select with
    ``dmlc_communicator='in-memory'`` and ``in_memory_world_size``,
    ``in_memory_rank``, ``in_memory_group``.  A rank that fails aborts the
    group's barrier (``abort``), so its peers raise instead of waiting."""

    def __init__(self, world: int, rank: int, group: str = "default") -> None:
        self._world = int(world)
        self._rank = int(rank)
        with _INMEM_LOCK:
            g = _INMEM_GROUPS.get(group)
            # a failed cohort leaves its barrier broken; a fresh cohort
            # must not inherit it
            if g is None or g.world != self._world or g.barrier.broken:
                g = _INMEM_GROUPS[group] = _InMemoryGroup(self._world)
        self._group = g

    def rank(self) -> int:
        return self._rank

    def world_size(self) -> int:
        return self._world

    def allgather(self, data: np.ndarray) -> np.ndarray:
        g = self._group
        g.slots[self._rank] = np.asarray(data)
        timeout = _TIMEOUT.total_seconds()
        g.barrier.wait(timeout=timeout)  # every slot filled
        out = np.stack([np.asarray(s) for s in g.slots])
        g.barrier.wait(timeout=timeout)  # every rank copied before reuse
        return out

    def abort(self, msg: str = "") -> None:
        self._group.barrier.abort()


# ---------------------------------------------------------------------------
# Flat API over the selected backend
# ---------------------------------------------------------------------------

# thread-local, so that in-memory thread workers each see their own rank;
# else the process-wide backend (one worker per process)
_TLS = threading.local()
_PROCESS_BACKEND: Optional[CollBackend] = None
# argless: reports a process group that someone else initialized
_DEFAULT = TorchDistributedBackend()


def _backend() -> CollBackend:
    b = getattr(_TLS, "backend", None)
    if b is not None:
        return b
    if _PROCESS_BACKEND is not None:
        return _PROCESS_BACKEND
    return _DEFAULT


def init(**args: Any) -> None:
    """Initialize the collective (reference collective.py:677).
    ``dmlc_communicator`` (or ``xgboost_communicator``) = 'in-memory' picks
    the thread backend (``in_memory_world_size``, ``in_memory_rank``,
    ``in_memory_group``); otherwise ``dmlc_tracker_uri`` and
    ``dmlc_tracker_port`` join a ``RabitTracker`` (``dmlc_task_id``, and
    ``device``: the worker's, which picks the relay or gloo), or
    ``coordinator_address``, ``num_processes`` and ``process_id`` start a
    gloo process group."""
    global _PROCESS_BACKEND
    kind = (args.get("dmlc_communicator")
            or args.get("xgboost_communicator") or "").replace("_", "-")
    if kind == "in-memory":
        if args.get("in_memory_join"):
            raise NotImplementedError(
                "elastic in-memory join is not ported to xgboost_tpu_torch "
                f"yet {_ELASTIC}")
        _TLS.backend = InMemoryBackend(
            int(args.get("in_memory_world_size", 1)),
            int(args.get("in_memory_rank", 0)),
            str(args.get("in_memory_group", "default")))
        return
    if kind == "federated":
        raise NotImplementedError(
            "the federated communicator is not ported to xgboost_tpu_torch "
            f"yet {_FEDERATED}")
    _PROCESS_BACKEND = TorchDistributedBackend(**args)


def finalize() -> None:
    global _PROCESS_BACKEND
    b = getattr(_TLS, "backend", None)
    if b is not None:
        b.shutdown()
        _TLS.backend = None
        return
    if _PROCESS_BACKEND is not None:
        _PROCESS_BACKEND.shutdown()
        _PROCESS_BACKEND = None


def get_rank() -> int:
    return _backend().rank()


def get_world_size() -> int:
    return _backend().world_size()


def is_distributed() -> bool:
    return get_world_size() > 1


def get_processor_name() -> str:
    return socket.gethostname()


def communicator_print(msg: str) -> None:
    print(f"[{get_rank()}] {msg}", flush=True)


def allreduce(data: np.ndarray, op: Op = Op.SUM) -> np.ndarray:
    """Allreduce across workers: exact, and in the same order on every
    worker."""
    return _backend().allreduce(np.asarray(data), op)


def allgather(data: np.ndarray) -> np.ndarray:
    """Gather each worker's identically shaped array: (world, *shape)."""
    return _backend().allgather(np.asarray(data))


def allgather_ragged(data: np.ndarray) -> np.ndarray:
    """Concatenate 1-D/2-D row arrays whose lengths differ by worker, in
    rank order (a gather padded to the longest, then trimmed)."""
    data = np.asarray(data)
    if not is_distributed():
        return data
    sizes = allgather(np.asarray([data.shape[0]], np.int64))[:, 0]
    width = int(sizes.max())
    pad = np.zeros((width,) + data.shape[1:], data.dtype)
    pad[: data.shape[0]] = data
    stacked = allgather(pad)
    return np.concatenate([stacked[k, : sizes[k]] for k in range(len(sizes))])


def global_sum(values: np.ndarray) -> np.ndarray:
    """Allreduce-SUM (src/collective/aggregator.h:33 GlobalSum)."""
    return allreduce(np.asarray(values), Op.SUM)


def global_max(value) -> np.ndarray:
    """Allreduce-MAX (aggregator.h:23 GlobalMax)."""
    return allreduce(np.asarray(value), Op.MAX)


def global_ratio(dividend: float, divisor: float) -> float:
    """sum(dividend) / sum(divisor) across workers; NaN where the global
    divisor is <= 0 (aggregator.h:52 GlobalRatio)."""
    out = allreduce(np.asarray([dividend, divisor], np.float64), Op.SUM)
    return float(out[0] / out[1]) if out[1] > 0 else float("nan")


def regroup(completed_round: int = 0):
    raise NotImplementedError(
        "elastic regroup is not ported to xgboost_tpu_torch yet "
        f"{_ELASTIC}")


def broadcast(data: Any, root: int) -> Any:
    """Broadcast a Python object from ``root`` (reference collective.py
    broadcast)."""
    if not is_distributed():
        return data
    b = _backend()
    payload = pickle.dumps(data) if b.rank() == root else None
    return pickle.loads(b.broadcast_bytes(payload, root))


def signal_error(msg: str = "") -> None:
    """Fail fast (reference collective.py:871): print, make the peers
    stop (a tracker aborts them; in-memory ranks' collectives raise), and
    exit 1.  No collective: a peer may be wedged already."""
    b = _backend()
    print(f"[{b.rank()}] collective error: {msg}", flush=True)
    b.abort(msg or "signal_error")
    sys.exit(1)


class CommunicatorContext:
    """``with`` block around ``init``/``finalize`` (reference
    collective.py:358).  A worker that leaves the block by an exception
    aborts its backend first, so that its peers raise rather than wait
    (a tracker's workers are aborted)."""

    def __init__(self, **args: Any) -> None:
        self.args = args

    def __enter__(self) -> Dict[str, Any]:
        init(**self.args)
        return self.args

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            _backend().abort(f"{exc_type.__name__}: {exc}")
        finalize()
