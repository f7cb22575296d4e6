"""The f32 accuracy of a lockstep (``_lockstep=1``) Covertype round on one GPU.

    python3 scripts/lockstep_accuracy.py [--out FILE]

Covertype-shaped rows (``chip_smoke.py:make_covertype``: 581,012 x 54, 7
classes), ``multi:softprob`` at depth 8 with ``max_bin`` 256, one round:

1. Every level's histograms of the lockstep round, on that level's own
   inputs, against an f64 sum (``chip_smoke.py:lockstep_level_errors``,
   which phase 12 gates): K1's class axis (csrc/hist_multi.cu) with the
   plan it takes (``planned_multi``), the root bucketed in blocks of one
   class as the levels below it are, and K single K1 launches.
   Per variant the largest cell error, the largest error of one (class,
   node, feature)'s sum over its bins, which a split's child totals
   carry, and the time of a call (median of 20 CUDA-event times, host
   launch included).
2. One round grown sequentially and one in lockstep: per depth, the
   largest |H - n h| over the
   round's nodes, H the node's stored hessian sum and n h its exact value
   (a first round's hessian is the same for every row); and where each
   lockstep round's trees first differ from the sequential ones, counting
   features and children alone, and counting too the thresholds and
   default directions that route some of the node's rows apart
   (``chip_smoke.py:_first_difference``), with the gap and the noise of
   ``chip_smoke.py:_same_or_near_tie`` there.

Prints one line per level and per depth and, with ``--out``, writes
every number to that JSON file.  Exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402
import xgboost_tpu_torch as xtt  # noqa: E402
from xgboost_tpu_torch.ops import hist_cuda  # noqa: E402


def bucketed_one_node(plan, bins, kw):
    """At the root, the bucketed launch of one class a block that the
    levels below it take (planned as for two nodes, with the root's K1
    block) in place of the unbucketed one."""
    if plan.bucketed:
        return None
    R, F = bins.shape
    return hist_cuda.plan_f32_multi(
        R, F, 2, kw["n_bin"], cs.COVER_CLASSES,
        hist_cuda.card_max_clusters(bins.device, bins.dtype,
                                    "hist_f32_multi",
                                    hist_cuda.MULTI_THREADS),
        kw["stride"], hist_cuda.card_max_clusters(bins.device, bins.dtype)
    )._replace(k1_rows=plan.k1_rows)


def hessian_errors(bst, X, h):
    """Per depth, the largest |H - n h| over a booster's nodes."""
    worst: dict = {}
    for tree in bst.trees:
        rows = {0: np.arange(X.shape[0])}
        depth = {0: 0}
        for n in range(tree.n_nodes):
            r = rows[n]
            err = abs(float(tree.sum_hessian[n]) - len(r) * h)
            worst[depth[n]] = max(worst.get(depth[n], 0.0), err)
            left = int(tree.left_children[n])
            if left == -1:
                continue
            right = int(tree.right_children[n])
            x = X[r, tree.split_indices[n]]
            go = np.where(np.isnan(x), bool(tree.default_left[n]),
                          x < tree.split_conditions[n])
            rows[left], rows[right] = r[go], r[~go]
            depth[left] = depth[right] = depth[n] + 1
    return worst


def first_difference_by_feature(got, ref):
    """Where two boosters' trees first differ by feature or children."""
    for t, (a, b) in enumerate(zip(got.trees, ref.trees)):
        n = min(a.n_nodes, b.n_nodes)
        d = np.nonzero((a.split_indices[:n] != b.split_indices[:n])
                       | (a.left_children[:n] != b.left_children[:n]))[0]
        if len(d) or a.n_nodes != b.n_nodes:
            return t, int(d[0]) if len(d) else n
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    hist_cuda.build_all()
    X, y = cs.make_covertype()
    d = xtt.DMatrix(X, label=y)
    levels = cs.lockstep_level_errors(
        xtt, hist_cuda, d, variants=(("bucketed", bucketed_one_node),))
    for row in levels:
        print("level " + json.dumps(row), flush=True)
    p = np.float32(1.0) / np.float32(cs.COVER_CLASSES)
    h = float(np.float32(2.0) * p * (np.float32(1.0) - p))
    result = {"card": smi, "levels": levels, "hessian": {},
              "first_difference": {}}
    boosters = {"sequential": xtt.train(cs.COVER, d, 1, verbose_eval=False),
                "lockstep": xtt.train(cs.COVER_LOCKSTEP, d, 1,
                                      verbose_eval=False)}
    seq = boosters["sequential"]
    for name, bst in boosters.items():
        worst = hessian_errors(bst, X, h)
        result["hessian"][name] = worst
        print(f"{name}: largest |H - n h| by depth "
              + " ".join(f"{k}:{v:.4g}" for k, v in sorted(worst.items())),
              flush=True)
        if bst is seq:
            continue
        result["first_difference"][name] = {}
        for rule, fd in (("feature and children",
                          first_difference_by_feature),
                         ("routing", lambda a, b: cs._first_difference(
                             a, b, X))):
            first = fd(bst, seq)
            entry = None
            if first is not None:
                t, n = first
                gap, delta, n_same = cs._tie_gap(bst, seq, first)
                entry = {"tree": t, "node": n, "features": [
                    int(bst.trees[t].split_indices[n]),
                    int(seq.trees[t].split_indices[n])], "gains": [
                    float(bst.trees[t].loss_changes[n]),
                    float(seq.trees[t].loss_changes[n])], "gap": gap,
                    "noise": delta, "n_same": n_same}
            result["first_difference"][name][rule] = entry
            print(f"{name} vs sequential, first difference by {rule}: "
                  f"{json.dumps(entry)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
