"""Training over several worker processes on one host (port of
xgboost_tpu/distributed.py; the dask ``train`` role, reference
python-package/xgboost/dask/__init__.py:722 _train_async).

``train_distributed(params, parts, ...)`` starts a
:class:`~xgboost_tpu_torch.tracker.RabitTracker`, then one worker process
per data part, through the launcher's tracker rendezvous
(``launcher.run_distributed``'s: the tracker assigns the rank, and a
worker of rank r reads part r).  Each worker builds its DMatrix from
its part, and trains: the cuts merge through the distributed sketch, the
histograms are summed over the ranks each level (on the tracker's relay
for CPU workers, a gloo group at the tracker's coordinator on the card).
Rank 0's model comes back as ``{"booster": Booster, "history": dict,
"best_iteration": ...}``.  The workers import only xgboost_tpu_torch and
run on the card unless ``params`` asks for the CPU (``"device": "cpu"``);
several workers may share one card.  A worker that fails signals the
tracker, which aborts the others (exit 255) rather than leave them
waiting in a collective; the parent raises with the failed workers'
stderr tails.

A part is a ``(X, y)`` tuple, a ``{"data": X, "label": y, ...}`` dict of
DMatrix arguments, or a picklable module-level zero-argument callable
returning one of them or a DMatrix.  The callable runs in the worker once
the collective is up, so an ``ExtMemQuantileDMatrix`` it builds over the
worker's pages takes the ranks' shared cuts.
"""
from __future__ import annotations

import functools
import json
import os
import pickle
import shutil
import tempfile
from typing import Any, Dict, Optional, Sequence

from .core import Booster

__all__ = ["train_distributed"]


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


def _train_worker(tmp: str, rank: int, world: int) -> None:
    """One worker of :func:`train_distributed`, run by the launcher inside
    the tracker-mode collective: train on ``part_<rank>`` and, at rank 0,
    write the model and its history to ``result.bin``."""
    import xgboost_tpu_torch as xtt

    with open(os.path.join(tmp, "spec.pkl"), "rb") as fh:
        spec = pickle.load(fh)
    with open(os.path.join(tmp, f"part_{rank}.pkl"), "rb") as fh:
        part = pickle.load(fh)  # this rank's shard alone
    dtrain = _make_dmatrix(part, spec["params"].get("device"))
    evals = [(dtrain, "train")] if spec["eval_train"] else []
    history: Dict[str, Any] = {}
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


def train_distributed(params: Dict[str, Any], parts: Sequence[Any],
                      num_boost_round: int = 10, *,
                      eval_train: bool = False,
                      verbose_eval: bool = False,
                      host_ip: str = "127.0.0.1",
                      timeout: int = 1200,
                      train_kwargs: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """Train one model over ``len(parts)`` local worker processes; returns
    rank 0's ``{"booster", "history", "best_iteration"}`` (the reference's
    dask ``train()`` contract, dask/__init__.py:930).  ``host_ip``: the
    address the tracker listens on; ``timeout``: the seconds the job may
    take before its workers are stopped.  A failed or timed-out job
    raises ``RuntimeError`` with the failed workers' stderr tails."""
    world = len(parts)
    if world == 0:
        raise ValueError("parts is empty: need one data part per worker")
    from .launcher import WorkerFailedError, _launch
    from .utils.device import resolve_device

    device = resolve_device(params.get("device"))
    tmp = tempfile.mkdtemp(prefix="xtt_dist_")
    try:
        with open(os.path.join(tmp, "spec.pkl"), "wb") as fh:
            pickle.dump({"params": dict(params),
                         "num_boost_round": int(num_boost_round),
                         "eval_train": bool(eval_train),
                         "verbose_eval": verbose_eval,
                         "train_kwargs": dict(train_kwargs or {})}, fh)
        # the tracker gives the ranks: every part is written, and a worker
        # reads only the part of its rank
        for i, part in enumerate(parts):
            with open(os.path.join(tmp, f"part_{i}.pkl"), "wb") as fh:
                pickle.dump(part, fh)
        try:
            _launch(functools.partial(_train_worker, tmp), world,
                    platform="cpu" if device.type == "cpu" else None,
                    timeout=timeout, rendezvous="tracker", host_ip=host_ip,
                    imports=parts)
        except (WorkerFailedError, TimeoutError) as e:
            raise RuntimeError(f"distributed training failed: {e}") from e
        with open(os.path.join(tmp, "result.bin"), "rb") as fh:
            blob = fh.read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = int.from_bytes(blob[:8], "little")
    meta = json.loads(blob[8:8 + n].decode())
    bst = Booster(params)
    bst.load_model(bytearray(blob[8 + n:]))
    return {"booster": bst, "history": meta["history"],
            "best_iteration": meta["best_iteration"]}
