"""Why phase 14 of chip_smoke.py sets two objectives' parameters.

    JAX_PLATFORMS=cpu python3 scripts/phase14_settings.py \\
        [--huber-rows N] [--cox-rows M]

Phase 14's data (chip_smoke.py:make_data and make_pointwise_targets),
ten rounds of depth 6, eta 0.3, max_bin 256, trained on the CPU by
xgboost_tpu and by xgboost_tpu_torch:

- reg:pseudohubererror on the continuous target (standard deviation
  about 3.2) at N rows (default 50,000), huber_slope 1 (the default) and
  3.  At slope 1 a leaf of residuals well above the slope has a hessian
  sum near zero, so its Newton step overshoots, and the next round's
  further still.
- survival:cox on the sign-encoded times at M rows (default 1,048,576,
  phase 14's), max_delta_step 0 (the default) and 0.7.  With a million
  rows a leaf of early times has a hessian sum far below its gradient
  sum, and its weight grows with the rows until the margins overflow.

Prints each run's train metric per round beside the constant model's.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import xgboost_tpu as xtb  # noqa: E402
import xgboost_tpu_torch as xtt  # noqa: E402
from xgboost_tpu_torch.metric import create_metric  # noqa: E402
from xgboost_tpu_torch.objective import create_objective  # noqa: E402


def run(objective, metric, X, y, settings):
    for extra in settings:
        params = dict(cs.P14_BASE, objective=objective, eval_metric=metric,
                      **extra)
        for pkg, dm, kw in ((xtb, xtb.DMatrix(X, label=y), {}),
                            (xtt, xtt.DMatrix(X, label=y, device="cpu"),
                             {"device": "cpu"})):
            res: dict = {}
            bst = pkg.train(params, dm, cs.P14_ROUNDS, evals=[(dm, "train")],
                            evals_result=res, verbose_eval=False, **kw)
            base = float(np.asarray(bst.base_score).reshape(-1)[0])
            obj = create_objective(objective, params)
            const_pred = obj.pred_transform(
                torch.full((len(y),), base)).numpy()
            mkw = {"slope": extra["huber_slope"]} \
                if "huber_slope" in extra else {}
            const = create_metric(metric)[0](const_pred, y, **mkw)
            curve = " ".join(f"{v:.6g}" for v in res["train"][metric])
            print(f"{pkg.__name__} {objective} {extra}: {metric} by round "
                  f"{curve}; constant model {const:.6f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--huber-rows", type=int, default=50_000)
    ap.add_argument("--cox-rows", type=int, default=1 << 20)
    args = ap.parse_args()
    X, y = cs.make_data(args.huber_rows, 28)
    t = cs.make_pointwise_targets(X, y)["cont"]
    print(f"continuous target: {len(t)} rows, std {float(t.std()):.4f}")
    run("reg:pseudohubererror", "mphe", X, t,
        [{"huber_slope": 1.0}, {"huber_slope": 3.0}])
    X, y = cs.make_data(args.cox_rows, 28)
    c = cs.make_pointwise_targets(X, y)["cox"]
    run("survival:cox", "cox-nloglik", X, c,
        [{}, {"max_delta_step": 0.7}])
    return 0


if __name__ == "__main__":
    sys.exit(main())
