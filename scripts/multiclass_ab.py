"""Time the port's multiclass training loops of several trees in turns on one GPU.

    python3 scripts/multiclass_ab.py parent=_proof/parent change=. \\
        [--out chiprun_out/multiclass_ab.json]

Each ``label=DIR`` names a checkout that holds ``xgboost_tpu_torch/`` and
``chip_smoke.py``.  The trees run in the order given and then in reverse
(A, B, B, A), each turn in a fresh process that builds that tree's kernels
from its sources and, on Covertype-shaped rows made from the same seed
(``chip_smoke.py:make_covertype``: 581,012 x 54, 7 classes), trains
chip_smoke's phase 12 (``_lockstep=1``) and phase 13 (``multi_output_tree``)
parameters, depth 8: per path the train loop's median of 3 runs of 5
rounds (no evaluation set, bins built; ``bench.py``'s definition), the
training merror of the first run's model, and a torch.profiler trace of
2 rounds: its wall time, the device's busy time, and the class axis's
device time (the kernels named ``hist_multi*``, or ``hist_kernel`` where a
tree's class axis is K1's own kernel: neither path launches single-class
K1).  Prints a table and writes every number to ``--out``.  Exits
non-zero if a turn fails or no GPU is present.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PATHS = ("lockstep", "vector leaves")
ROUNDS, REPEATS, PROFILED = 5, 3, 2


def _worker(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    import chip_smoke as cs
    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch.ops import hist_cuda

    hist_cuda.build_all()
    X, y = cs.make_covertype()
    d = xtt.DMatrix(X, label=y)
    out = {}
    for path, params in zip(PATHS, (cs.COVER_LOCKSTEP, cs.COVER_VECTOR)):
        xtt.train(params, d, 1, verbose_eval=False)  # warm
        times = []
        for i in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst = xtt.train(params, d, ROUNDS, verbose_eval=False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0:
                prob = bst.predict(d)
                merror = float(np.mean(prob.argmax(axis=1) != y))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            xtt.train(params, d, PROFILED, verbose_eval=False)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy = axis = 0.0
        for r in prof.key_averages():
            if r.device_type != DeviceType.CUDA:
                continue
            us = getattr(r, "self_device_time_total", None)
            ms = (r.self_cuda_time_total if us is None else us) / 1e3
            busy += ms
            if "hist_multi" in r.key or "hist_kernel" in r.key:
                axis += ms
        out[path] = dict(train_s=statistics.median(times), times=times,
                         merror=merror, wall_ms=wall_ms, busy_ms=busy,
                         class_axis_ms=axis)
    return dict(device=torch.cuda.get_device_name(0), paths=out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="label=DIR")
    ap.add_argument("--out", default="chiprun_out/multiclass_ab.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        import torch
        if not torch.cuda.is_available():
            print("multiclass_ab: no CUDA device", file=sys.stderr)
            return 1
        print("RESULT " + json.dumps(_worker(args.worker)), flush=True)
        return 0

    trees = [tuple(t.split("=", 1)) for t in args.trees]
    if not trees or any(len(t) != 2 for t in trees):
        ap.error("name at least one tree as label=DIR")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for label, tree in trees + trees[::-1]:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", tree]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            print(f"turn {label} failed (rc {proc.returncode}):\n"
                  f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}", flush=True)
            return 1
        runs.append(dict(label=label, tree=tree,
                         **json.loads(line[0][len("RESULT "):])))
        print(f"turn {len(runs)}: {label} done", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(card=smi, runs=runs), fh, indent=1)
    for path in PATHS:
        print(f"{path}: train loop s (median of {REPEATS} x {ROUNDS} "
              f"rounds) | {PROFILED} profiled rounds: wall / busy / class "
              f"axis ms | merror")
        for r in runs:
            p = r["paths"][path]
            print(f"  {r['label']:>8s} {p['train_s']:.3f} "
                  f"({' '.join(f'{t:.3f}' for t in p['times'])}) | "
                  f"{p['wall_ms']:.3f} / {p['busy_ms']:.3f} / "
                  f"{p['class_axis_ms']:.3f} | {p['merror']:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
