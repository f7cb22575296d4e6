"""Multi-process launcher (port of xgboost_tpu/launcher.py; the role of
the reference's dask and spark launchers, python-package/xgboost/dask/
__init__.py:722 _train_async: one worker a data shard, a rendezvous, one
model out).

``run_distributed(fn, num_workers)`` spawns one process a worker; each
initializes the collective and runs ``fn(rank, world)``.  Inside, build a
DMatrix on the worker's shard and call ``xgboost_tpu_torch.train``: the
cuts merge through the distributed sketch and the histograms are summed
over the ranks every level, so every worker holds the same model.

Example worker::

    def worker(rank, world):
        import xgboost_tpu_torch as xtt
        X, y = load_shard(rank, world)
        bst = xtt.train(params, xtt.DMatrix(X, label=y), 100)
        if rank == 0:
            bst.save_model("model.ubj")

    from xgboost_tpu_torch.launcher import run_distributed
    run_distributed(worker, num_workers=4)

The workers run on the card, several of them sharing it where there is
one, unless ``platform="cpu"``, which hides the card from them (a worker
that then asks for it raises, as the port does on a host without one).
Not ported: elastic workers and their respawns (ROADMAP Queue 1 item
9b.3); tracker failover, fault plans and the workers' flight recorder,
profiler and trace (item 11).
"""
from __future__ import annotations

import functools
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

__all__ = ["run_distributed", "WorkerFailedError", "stderr_tail",
           "spawn_worker"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class WorkerFailedError(RuntimeError):
    """One or more spawned workers exited non-zero.  ``failures`` holds
    ``(label, returncode, stderr_tail)`` for each: ``label`` is the spawn
    index (a tracker may have given the worker another rank; its stderr
    says which), ``stderr_tail`` the end of that process's stderr."""

    def __init__(self, message: str, failures) -> None:
        super().__init__(message)
        self.failures = list(failures)


def stderr_tail(path: str, limit: int = 4000) -> str:
    """The last ``limit`` bytes of a worker's captured stderr."""
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            fh.seek(max(fh.tell() - limit, 0))
            return fh.read().decode("utf-8", "replace").strip()
    except OSError:
        return "<stderr unavailable>"


def spawn_worker(argv, label, err_files: dict, *, env=None):
    """Spawn one worker process with its stderr in a file of its own,
    recorded in ``err_files[label]`` (a file, not a pipe: nobody drains a
    pipe while the workers run, and the tail must outlive the process).
    The caller reaps the process and removes the file."""
    fd, err_path = tempfile.mkstemp(prefix=f"xtt_worker_{label}_",
                                    suffix=".stderr")
    err_files[label] = err_path
    with os.fdopen(fd, "wb") as ef:
        return subprocess.Popen(argv, env=env, stderr=ef)


_CHILD = r"""
import pickle, sys

label, world, addr, platform = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
fn_path, rendezvous = sys.argv[5], sys.argv[6]
for p in reversed(sys.argv[7].split(chr(31))):  # the package root first
    if p:
        sys.path.insert(0, p)

from xgboost_tpu_torch import collective

if rendezvous == "tracker":
    # the tracker assigns the rank and keeps the error channel
    host, port = addr.rsplit(":", 1)
    args = dict(dmlc_tracker_uri=host, dmlc_tracker_port=int(port),
                dmlc_nworker=world)
else:
    args = dict(coordinator_address=addr, num_processes=world,
                process_id=int(label))
with open(fn_path, "rb") as fh:
    fn = pickle.load(fh)
# leaving the block by an exception tells the tracker, which aborts the
# peers that may wait on this worker
with collective.CommunicatorContext(
        device="cpu" if platform == "cpu" else None, **args):
    fn(collective.get_rank(), collective.get_world_size())
"""

# the seconds the other workers get to exit on their own once one has
# failed (a tracker's abort ends them at once, with code 255), before they
# are killed
_GRACE_S = 5.0

_UNPORTED = (
    ("elastic", False, "elastic workers (elastic=)", "9b.3"),
    ("max_respawns", 0, "worker respawns (max_respawns=)", "9b.3"),
    ("tracker_failover", False, "tracker failover (tracker_failover=)",
     "11"),
    ("max_tracker_respawns", 3,
     "tracker respawns (max_tracker_respawns=)", "11"),
    ("fault_plan", None, "fault plans (fault_plan=)", "11"),
)


def run_distributed(fn: Callable[[int, int], None], num_workers: int,
                    *, coordinator_port: Optional[int] = None,
                    platform: Optional[str] = None,
                    timeout: float = 3600.0,
                    fault_plan: Optional[str] = None,
                    rendezvous: str = "auto",
                    elastic: bool = False,
                    max_respawns: int = 0,
                    tracker_failover: bool = False,
                    max_tracker_respawns: int = 3) -> dict:
    """Spawn ``num_workers`` processes, each running ``fn(rank, world)``
    under an initialized collective; ``fn`` must pickle (a module-level
    function or a ``functools.partial`` of one).  ``platform="cpu"`` hides
    the card from the workers, whose collective then takes the CPU's
    route.

    ``rendezvous``: "direct" (a gloo process group at
    ``coordinator_port``, a free one by default; worker i is rank i) or
    "tracker" (a ``RabitTracker`` assigns the ranks, keeps the error
    channel, and carries the gathers on its relay for CPU workers or
    hands out a gloo coordinator; ``XGBOOST_TPU_COLL`` overrides, see
    ``collective``).  "auto" is "tracker" for ``platform="cpu"`` and
    "direct" otherwise, as the reference decides.

    The first worker that fails ends the job: the others get a few
    seconds to exit on their own (a tracker's abort ends them at once,
    with code 255), then are killed, and :class:`WorkerFailedError`
    carries each failed worker's spawn index, exit code and stderr tail.
    ``TimeoutError`` after ``timeout`` seconds.  Returns the reference's
    stats dict (no deaths tolerated, no respawns)."""
    args = dict(elastic=elastic, max_respawns=max_respawns,
                tracker_failover=tracker_failover,
                max_tracker_respawns=max_tracker_respawns,
                fault_plan=fault_plan)
    for name, default, what, item in _UNPORTED:
        if args[name] != default:
            raise NotImplementedError(
                f"{what} is not ported to xgboost_tpu_torch yet (ROADMAP "
                f"Queue 1 item {item})")
    if rendezvous == "auto":
        rendezvous = "tracker" if (platform or "") == "cpu" else "direct"
    if rendezvous not in ("tracker", "direct"):
        raise ValueError(f"unknown rendezvous {rendezvous!r}")
    _launch(fn, num_workers, platform=platform, timeout=timeout,
            rendezvous=rendezvous, coordinator_port=coordinator_port)
    return {"tolerated": [], "respawned": 0, "succeeded": num_workers,
            "tracker_respawns": 0, "tracker_pauses_s": []}


def _import_paths(objs) -> str:
    """The package root, then the directory of the module of each
    callable in ``objs`` (a callable unpickles in the worker by import
    path), joined by chr(31)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [root]
    for obj in objs:
        while isinstance(obj, functools.partial):
            obj = obj.func  # the real function's home module
        name = getattr(obj, "__module__", None) or ""
        mod = sys.modules.get(name) if callable(obj) else None
        f = getattr(mod, "__file__", None)
        # the package's own modules import from the root
        if f and name.split(".")[0] != __package__:
            d = os.path.dirname(os.path.abspath(f))
            if d not in paths:
                paths.append(d)
    return chr(31).join(paths)


def _launch(fn, num_workers: int, *, platform: Optional[str],
            timeout: float, rendezvous: str,
            coordinator_port: Optional[int] = None,
            host_ip: str = "127.0.0.1", imports=()) -> None:
    """Spawn and supervise the workers of :func:`run_distributed` (and of
    ``distributed.train_distributed``, which passes its tracker's
    ``host_ip`` and, as ``imports``, the parts whose modules its workers
    unpickle).  Under the tracker, its ``wait_for`` runs once every
    worker has exited 0."""
    env = dict(os.environ)
    if platform == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    elif platform:
        raise ValueError(f"platform must be None or 'cpu', not {platform!r}")
    else:
        import torch

        if torch.cuda.is_available():
            # build the kernel libraries here, once, so the workers only
            # load them
            from .ops import hist_cuda

            hist_cuda.build_all()
    with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as fh:
        pickle.dump(fn, fh)
        fn_path = fh.name
    paths = _import_paths((fn, *imports))
    err_files: dict = {}
    pending = {}
    tracker = None
    try:
        if rendezvous == "tracker":
            from .tracker import RabitTracker

            tracker = RabitTracker(n_workers=num_workers, host_ip=host_ip)
            tracker.start()
            addr = f"{tracker.host_ip}:{tracker.port}"
        else:
            addr = f"{host_ip}:{coordinator_port or _free_port()}"
        for label in range(num_workers):
            pending[label] = spawn_worker(
                [sys.executable, "-c", _CHILD, str(label), str(num_workers),
                 addr, platform or "", fn_path, rendezvous, paths],
                label, err_files, env=env)
        deadline = time.monotonic() + timeout
        codes = {}
        while len(codes) < num_workers:
            for label, p in pending.items():
                if label not in codes and p.poll() is not None:
                    codes[label] = p.returncode
            if any(rc != 0 for rc in codes.values()):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"worker(s) {sorted(set(pending) - set(codes))} still "
                    f"running after {timeout}s; killed")
            time.sleep(0.05)
        failures = _reap(pending, codes, err_files)
        if failures:
            labels = [f[0] for f in failures]
            detail = ", ".join(
                f"worker {r}: " + ("aborted by tracker fan-out"
                                   if rc == 255 else f"exit {rc}")
                for r, rc, _t in failures)
            msg = (f"worker(s) {labels} exited non-zero ({detail}); "
                   f"remaining workers killed")
            for r, _rc, tail in failures:
                if tail:
                    msg += f"\n--- worker {r} stderr tail ---\n{tail}"
            raise WorkerFailedError(msg, failures)
        if tracker is not None:
            tracker.wait_for(timeout=60)
    finally:
        for p in pending.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        if tracker is not None:
            tracker.free()
        for path in [fn_path, *err_files.values()]:
            try:
                os.unlink(path)
            except OSError:
                pass


def _reap(pending, codes, err_files):
    """After a failure, wait up to ``_GRACE_S`` seconds for the workers
    still running, kill the rest, and return the failed ones' ``(label,
    returncode, stderr tail)``; none when every worker exited 0."""
    if any(rc != 0 for rc in codes.values()):
        end = time.monotonic() + _GRACE_S
        while (time.monotonic() < end
               and any(p.poll() is None for p in pending.values())):
            time.sleep(0.05)
        for label, p in pending.items():
            if p.poll() is None:
                p.kill()
            codes[label] = p.wait()
    return [(label, rc, stderr_tail(err_files[label]))
            for label, rc in sorted(codes.items()) if rc != 0]
