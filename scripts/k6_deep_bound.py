"""K6's bound for the deep ensemble of scripts/treeshap_ab.py (300 rounds
of depth 8 on the first 200,000 of chip_smoke.py's HIGGS-shaped rows),
over its 1,000 explained rows, values and interactions: the larger of the
bytes at the HBM rate and the f32 and f64 operations at the unfused rates,
from the same ``treeshap_cuda.work`` count as chip_smoke.py's phase 18
(``_k6_bound``).  Trains the model on the card.

    python scripts/k6_deep_bound.py
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import xgboost_tpu_torch as xtt  # noqa: E402
from xgboost_tpu_torch.interpret import device as dv  # noqa: E402

DEEP_ROWS = 1_000


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_deep_bound: no CUDA device", file=sys.stderr)
        return 1
    X, y = cs.make_data(1_000_000, 28)
    bst = xtt.train(dict(cs.BASE, max_depth=8),
                    xtt.DMatrix(X[:200_000], label=y[:200_000]), 300,
                    verbose_eval=False)
    parts = [t for t in (dv.path_tables(trees, wts, X.shape[1])
                         for trees, wts in cs._groups(bst).values())
             if t.buckets]
    for inter in (False, True):
        ms = by = 0.0
        f32 = 0
        for t in parts:
            m, b, f = cs._k6_bound(t, DEEP_ROWS, interactions=inter)
            ms, by, f32 = ms + m, b, f32 + f
        print(f"deep model ({len(bst.trees)} trees), {DEEP_ROWS} rows, "
              f"{'interactions' if inter else 'values'}: bound {ms:.4f} ms "
              f"({by}), {f32:.4g} f32 operations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
