"""Worker functions for ``xgboost_tpu_torch.launcher.run_distributed`` in
the port's tests: module-level, so that they pickle into the worker
processes, and importing only numpy, the standard library and
xgboost_tpu_torch, as the workers do.

The data is made here from a seed, so the tests can hand the same shards
to the reference's in-memory ranks."""
import json
import os

import numpy as np

CUT = 1100  # rank 0's rows of ``data()``; rank 1 holds the rest


def data(n=2000, f=6, seed=0):
    """Binary data with missing values (tests/test_torch_distributed.py's
    ``_data``)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    z = np.nan_to_num(X[:, 0]) + 0.8 * np.nan_to_num(X[:, 1]) * (X[:, 2] > 0)
    return X, (z > 0).astype(np.float32)


def shards():
    """The two uneven row shards of ``data()``, by rank."""
    X, y = data()
    return [(X[:CUT], y[:CUT]), (X[CUT:], y[CUT:])]


def train_shard(rank, world, out_dir, params, rounds):
    """Train ``rounds`` rounds on this rank's shard; write the model JSON
    and the world to ``out_dir/rank<rank>.json``."""
    import xgboost_tpu_torch as xtt

    X, y = shards()[rank]
    d = xtt.DMatrix(X, label=y, device=params.get("device"))
    bst = xtt.train(params, d, rounds, verbose_eval=False)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump({"world": world, "model": json.dumps(bst.save_raw_dict())},
                  fh)


def signal_or_wait(rank, world):
    """Rank 1 signals an error through the collective; rank 0 waits for
    it in a collective, from which only the tracker's abort frees it."""
    from xgboost_tpu_torch import collective

    if rank == 1:
        collective.signal_error("rank 1 gives up on purpose")
    collective.allreduce(np.ones(4))
