"""How closely ten depth-6 rounds fit the multi-target regression of
``chip_smoke.py`` phase 13b, on the CPU, in either package.

    python3 scripts/multi_target_fit.py --package xgboost_tpu [--rows 50000]
    python3 scripts/multi_target_fit.py --package xgboost_tpu_torch [--rows 50000]

The HIGGS-shaped rows of ``chip_smoke.py:make_data`` (28 columns, N(0,
1)) with 3 targets X W + 0.1 noise, W N(0, 1): over the first 8 columns
(``chip_smoke.py:make_targets``, as the reference's
``tests/test_multitarget.py:10-15`` builds its 8-feature targets) and over
all 28.  ``reg:squarederror``, ``num_target`` 3, depth 6, ``max_bin``
256, ``eta`` 0.3, 10 rounds (``chip_smoke.py:MULTI_REG``), under both
``multi_strategy`` values.  Prints, per case, the training rmse over the
baseline's (the targets' deviation from their means): phase 13b's gate
is 0.5.  Each run imports the one package it names.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from chip_smoke import MULTI_REG, make_data, make_targets  # noqa: E402


def targets_all(X, k: int = 3, seed: int = 13):
    """``make_targets`` over all of X's columns."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(X.shape[1], k)).astype(np.float32)
    return (X @ W + 0.1 * rng.normal(size=(X.shape[0], k))).astype(
        np.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", required=True,
                    choices=("xgboost_tpu", "xgboost_tpu_torch"))
    ap.add_argument("--rows", type=int, default=50_000)
    args = ap.parse_args()
    if args.package == "xgboost_tpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import xgboost_tpu as pkg
        kw = {}
    else:
        import xgboost_tpu_torch as pkg
        kw = {"device": "cpu"}
    X, _ = make_data(args.rows, 28)
    for name, Y in (("8 columns", make_targets(X)),
                    ("28 columns", targets_all(X))):
        base = float(np.sqrt(np.mean((Y - Y.mean(0)) ** 2)))
        d = pkg.DMatrix(X, label=Y, **kw)
        for strategy in ("one_output_per_tree", "multi_output_tree"):
            res: dict = {}
            pkg.train(dict(MULTI_REG, multi_strategy=strategy), d, 10,
                      evals=[(d, "train")], evals_result=res,
                      verbose_eval=False, **kw)
            rmse = float(res["train"]["rmse"][-1])
            print(json.dumps({"package": args.package, "rows": args.rows,
                              "targets": name, "strategy": strategy,
                              "rmse": rmse, "baseline": base,
                              "ratio": rmse / base}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
