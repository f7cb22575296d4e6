"""Training over several worker processes on one host (port of
xgboost_tpu/distributed.py; the dask ``train`` role, reference
python-package/xgboost/dask/__init__.py:722 _train_async).

``train_distributed(params, parts, ...)`` picks a free localhost port,
starts one worker process per data part, and each worker joins a gloo
process group there (``collective.CommunicatorContext`` with
``coordinator_address``, ``num_processes`` and ``process_id``: worker i
is rank i and reads part i), builds its DMatrix from its part, and
trains: the cuts merge through the distributed sketch, the histograms
are summed over the ranks each level.  Rank 0's model comes back as
``{"booster": Booster, "history": dict, "best_iteration": ...}``.  The
workers import only xgboost_tpu_torch and run on the card unless
``params`` asks for the CPU (``"device": "cpu"``); several workers may
share one card.  A worker that fails ends the job at once: the parent
stops the others and raises with the failed worker's log.

A part is a ``(X, y)`` tuple, a ``{"data": X, "label": y, ...}`` dict of
DMatrix arguments, or a picklable module-level zero-argument callable
returning one of them or a DMatrix.  The callable runs in the worker once
the collective is up, so an ``ExtMemQuantileDMatrix`` it builds over the
worker's pages takes the ranks' shared cuts.  The reference's tracker,
which assigns ranks and fans out errors, is not ported (ROADMAP Queue 1
item 9b.2).
"""
from __future__ import annotations

import functools
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

from .core import Booster

__all__ = ["train_distributed"]

_CHILD = r"""
import json, os, pickle, sys

tmp, port, world, rank, syspaths = (sys.argv[1], sys.argv[2],
                                    int(sys.argv[3]), int(sys.argv[4]),
                                    sys.argv[5])
for p in reversed(syspaths.split(chr(31))):
    if p:
        sys.path.insert(0, p)

import xgboost_tpu_torch as xtt
from xgboost_tpu_torch import collective
from xgboost_tpu_torch.distributed import _make_dmatrix

with collective.CommunicatorContext(
        coordinator_address=f"tcp://127.0.0.1:{port}",
        num_processes=world, process_id=rank):
    with open(os.path.join(tmp, "spec.pkl"), "rb") as fh:
        spec = pickle.load(fh)
    with open(os.path.join(tmp, f"part_{rank}.pkl"), "rb") as fh:
        part = pickle.load(fh)  # this rank's shard alone
    dtrain = _make_dmatrix(part, spec["params"].get("device"))
    evals = [(dtrain, "train")] if spec["eval_train"] else []
    history = {}
    bst = xtt.train(spec["params"], dtrain, spec["num_boost_round"],
                    evals=evals, evals_result=history,
                    verbose_eval=spec["verbose_eval"],
                    **spec["train_kwargs"])
    if rank == 0:
        raw = bytes(bst.save_raw())
        head = json.dumps({"history": history,
                           "best_iteration": bst.best_iteration}).encode()
        with open(os.path.join(tmp, "result.bin"), "wb") as fh:
            fh.write(len(head).to_bytes(8, "little") + head + raw)
print("WORKER-DONE", flush=True)
"""


def _make_dmatrix(part: Any, device=None):
    """One worker's part as a DMatrix on ``device`` (the DaskDMatrix
    role); a callable's own DMatrix as it built it."""
    from .data.dmatrix import DMatrix

    if callable(part):
        part = part()
    if isinstance(part, DMatrix):
        return part
    if isinstance(part, tuple):
        X, y = part
        return DMatrix(X, label=y, device=device)
    if isinstance(part, dict):
        kw = dict(part)
        return DMatrix(kw.pop("data"), device=device, **kw)
    raise TypeError(f"cannot build a DMatrix from a part of type "
                    f"{type(part)}")


def _free_port(host: str) -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _import_paths(parts) -> List[str]:
    """The repository root, and the directory of the module of each
    callable part (a callable unpickles in the worker by import path)."""
    paths = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    for part in parts:
        fn = part.func if isinstance(part, functools.partial) else part
        if callable(fn):
            mod = sys.modules.get(getattr(fn, "__module__", ""), None)
            f = getattr(mod, "__file__", None)
            if f:
                d = os.path.dirname(os.path.abspath(f))
                if d not in paths:
                    paths.append(d)
    return paths


def train_distributed(params: Dict[str, Any], parts: Sequence[Any],
                      num_boost_round: int = 10, *,
                      eval_train: bool = False,
                      verbose_eval: bool = False,
                      timeout: int = 1200,
                      train_kwargs: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """Train one model over ``len(parts)`` local worker processes; returns
    rank 0's ``{"booster", "history", "best_iteration"}`` (the reference's
    dask ``train()`` contract, dask/__init__.py:930).  ``timeout``: the
    seconds the job may take before its workers are stopped."""
    world = len(parts)
    if world == 0:
        raise ValueError("parts is empty: need one data part per worker")
    from .utils.device import resolve_device

    if resolve_device(params.get("device")).type == "cuda":
        # build the kernel libraries here, once, so the workers only load
        from .ops import hist_cuda

        hist_cuda.build_all()
    tmp = tempfile.mkdtemp(prefix="xtt_dist_")
    procs: List[subprocess.Popen] = []
    logs: List[Any] = []
    try:
        with open(os.path.join(tmp, "spec.pkl"), "wb") as fh:
            pickle.dump({"params": dict(params),
                         "num_boost_round": int(num_boost_round),
                         "eval_train": bool(eval_train),
                         "verbose_eval": verbose_eval,
                         "train_kwargs": dict(train_kwargs or {})}, fh)
        for i, part in enumerate(parts):
            with open(os.path.join(tmp, f"part_{i}.pkl"), "wb") as fh:
                pickle.dump(part, fh)
        port = _free_port("127.0.0.1")
        paths = chr(31).join(_import_paths(parts))
        for i in range(world):
            # output to a file: a pipe would block a chatty worker while
            # the parent waits on another
            log = open(os.path.join(tmp, f"worker_{i}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, tmp, str(port), str(world),
                 str(i), paths],
                stdout=log, stderr=subprocess.STDOUT))
        _wait_all(procs, logs, timeout)
        with open(os.path.join(tmp, "result.bin"), "rb") as fh:
            blob = fh.read()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    n = int.from_bytes(blob[:8], "little")
    meta = json.loads(blob[8:8 + n].decode())
    bst = Booster(params)
    bst.load_model(bytearray(blob[8 + n:]))
    return {"booster": bst, "history": meta["history"],
            "best_iteration": meta["best_iteration"]}


def _wait_all(procs, logs, timeout: float, grace: float = 5.0) -> None:
    """Wait for every worker.  The first that fails, or the timeout, ends
    the job: the others get ``grace`` seconds to exit on their own (a peer
    of a failed worker fails in its next collective), then are stopped,
    and the failed workers' logs are raised."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        if all(c == 0 for c in codes):
            return
        if any(c not in (None, 0) for c in codes) \
                or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    end = time.monotonic() + grace
    while any(p.poll() is None for p in procs) and time.monotonic() < end:
        time.sleep(0.05)
    codes = [p.poll() for p in procs]
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    errs = []
    for i, c in enumerate(codes):
        if c not in (None, 0):
            logs[i].seek(0)
            errs.append(f"worker {i} (exit {c}):\n" + logs[i].read()[-2000:])
    if all(c is None or c == 0 for c in codes):
        errs.append(f"timed out after {timeout}s")
    raise RuntimeError("distributed training failed:\n"
                       + "\n---\n".join(errs))
