"""The f32 accuracy of a lockstep (``_lockstep=1``) Covertype round on one GPU.

    python3 scripts/lockstep_accuracy.py [--out FILE]

Covertype-shaped rows (``chip_smoke.py:make_covertype``: 581,012 x 54, 7
classes), ``multi:softprob`` at depth 8 with ``max_bin`` 256, one round:

1. Every level's histograms of the lockstep round, on that level's own
   inputs, against an f64 sum: K1's class axis with its plan
   (``plan_f32_multi``: each class K1's row blocks), the class axis with
   one wave shared by the K classes' columns (K-fold fewer row blocks a
   class, its first design), and K single K1 launches.  Per variant the
   largest cell error, the largest error of one (class, node, feature)'s
   sum over its bins, which a split's child totals carry, and the time of
   a launch (median of 20 CUDA-event times, host launch included).
2. One round grown sequentially, one in lockstep and one in lockstep
   with the shared-wave plan: per depth, the largest |H - n h| over the
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
import xgboost_tpu_torch.tree.grow_lockstep as gl  # noqa: E402
from xgboost_tpu_torch.ops import hist_cuda  # noqa: E402


def shared_wave_plan(R, F, n_nodes, n_bin, K, card, stride):
    """The class axis's first plan: ``plan_f32``'s blocks and cluster, and
    as many row blocks per (class, feature group, node tile) as fill one
    wave shared by all K classes."""
    p = hist_cuda.plan_f32(R, F, n_nodes, n_bin, card, stride)
    smem = p.feat_group * p.node_tile * n_bin * 8
    n_cols = -(-F // p.feat_group) * -(-n_nodes // p.node_tile) * K
    wave = p.cluster * card(p.staged, smem, p.cluster)
    per_col = min(wave // p.cluster // n_cols,
                  -(-R // (p.cluster * hist_cuda.THREADS)))
    return p._replace(row_blocks=p.cluster * max(1, per_col))


def shared_wave_hist(bins, gpair, pos, *, node0, n_nodes, n_bin, stride=1):
    """The lockstep grower's histograms with ``shared_wave_plan``."""
    (R, F), K = bins.shape, gpair.shape[1]
    card = hist_cuda.card_max_clusters(bins.device, bins.dtype)
    return hist_cuda.run_f32_multi(
        bins, gpair, pos,
        shared_wave_plan(R, F, n_nodes, n_bin, K, card, stride),
        node0=node0, n_nodes=n_nodes, n_bin=n_bin, stride=stride)


def hist64(bins, g, pos, node0, n_nodes, n_bin, stride):
    """One class's histogram summed in f64: (n_nodes, F, n_bin, 2)."""
    R, F = bins.shape
    local = pos.long() - node0
    ok = (local >= 0) & (local % stride == 0) & (local // stride < n_nodes)
    take = ok[:, None] & (bins.long() < n_bin)
    idx = ((local // stride)[:, None] * F
           + torch.arange(F, device=bins.device)[None]) * n_bin + bins.long()
    flat = torch.zeros(n_nodes * F * n_bin, 2, dtype=torch.float64,
                       device=bins.device)
    flat.index_add_(0, idx[take], g.double()[:, None, :].expand(R, F, 2)[take])
    return flat.reshape(n_nodes, F, n_bin, 2)


def errors(h, ref):
    e = h.double() - ref
    return {"max_abs": e.abs().max().item(),
            "max_bin_sum": e.sum(dim=3).abs().max().item()}


def level_rows(X, y):
    """Part 1: every level of one lockstep round."""
    rows = []
    orig = gl.build_histogram_multi

    def probe(bins, gpair, pos, *, node0, n_nodes, n_bin, stride=1):
        out = orig(bins, gpair, pos, node0=node0, n_nodes=n_nodes,
                   n_bin=n_bin, stride=stride)
        K, R, F = gpair.shape[1], bins.shape[0], bins.shape[1]
        kw = dict(node0=node0, n_nodes=n_nodes, n_bin=n_bin, stride=stride)
        ref = torch.stack([hist64(bins, gpair[:, k], pos[k], node0, n_nodes,
                                  n_bin, stride) for k in range(K)])
        cols = [gpair[:, k].contiguous() for k in range(K)]
        card = hist_cuda.card_max_clusters(bins.device, bins.dtype)
        plan = hist_cuda.plan_f32_multi(R, F, n_nodes, n_bin, K, card,
                                        stride)
        shared = shared_wave_plan(R, F, n_nodes, n_bin, K, card, stride)

        def axis(p):
            return hist_cuda.run_f32_multi(bins, gpair, pos, p, **kw)

        def singles():
            return torch.stack([hist_cuda.build_histogram_cuda(
                bins, cols[k], pos[k], **kw) for k in range(K)])

        row = {"node0": node0, "n_nodes": n_nodes, "stride": stride,
               "largest_cell": ref.abs().max().item()}
        for name, fn, p in (("class axis", lambda: axis(plan), plan),
                            ("shared wave", lambda: axis(shared), shared),
                            ("K single K1", singles, None)):
            row[name] = dict(errors(fn(), ref), ms=cs.cuda_ms(fn),
                             plan=list(p) if p is not None else None)
        rows.append(row)
        print("level " + json.dumps(row), flush=True)
        return out

    gl.build_histogram_multi = probe
    try:
        xtt.train(cs.COVER_LOCKSTEP, xtt.DMatrix(X, label=y), 1,
                  verbose_eval=False)
    finally:
        gl.build_histogram_multi = orig
    return rows


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
    levels = level_rows(X, y)
    d = xtt.DMatrix(X, label=y)
    p = np.float32(1.0) / np.float32(cs.COVER_CLASSES)
    h = float(np.float32(2.0) * p * (np.float32(1.0) - p))
    result = {"card": smi, "levels": levels, "hessian": {},
              "first_difference": {}}
    boosters = {"sequential": xtt.train(cs.COVER, d, 1, verbose_eval=False),
                "lockstep": xtt.train(cs.COVER_LOCKSTEP, d, 1,
                                      verbose_eval=False)}
    gl.build_histogram_multi = shared_wave_hist
    try:
        boosters["lockstep, shared wave"] = xtt.train(
            cs.COVER_LOCKSTEP, d, 1, verbose_eval=False)
    finally:
        gl.build_histogram_multi = hist_cuda.build_histogram_multi
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
