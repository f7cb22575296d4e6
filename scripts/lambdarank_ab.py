"""Time K5 and the ranking train loop of several trees in turns on one GPU.

    python3 scripts/lambdarank_ab.py parent=_proof/parent change=. \\
        [--out chiprun_out/lambdarank_ab.json]

Each ``label=DIR`` names a checkout that holds ``xgboost_tpu_torch/`` and
``chip_smoke.py``.  The trees run in the order given and then in reverse
(A, B, B, A), each turn in a fresh process that builds that tree's kernels
from its sources.  Each turn:

- K5 through the public wrapper (``lambdarank_topk_cuda``) at the query
  sizes of ``chip_smoke.py``'s phase 2g cases ``mslr`` (31,531 queries of
  40-199 docs), ``20k_groups`` (two of 20,000 docs and one of 150) and
  ``k_above_n`` (4,000 MSLR queries, k = 256), scores N(0, 1) and labels
  0-4 from one seed a case: the median of 20 CUDA-event times a call,
  torch.profiler's device time a call (every kernel the call runs, the
  wrapper's sorts included) and K5's own device time a launch, and a
  checksum of the output's bits;
- phase 15's ``rank:ndcg`` train loop on ``chip_smoke.make_mslr``'s
  31,531 queries (about 3.77M x 136, depth 8, eta 0.3, max_bin 256): the
  median of 3 runs of 5 rounds (bins built, no evaluation set), and a
  torch.profiler trace of 2 rounds: its wall time, the device's busy time,
  the idle share and K5's device time.

Prints a table and writes every number to ``--out``.  Exits non-zero if a
turn fails, the trees' outputs differ, or no GPU is present.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

CASES = ("mslr", "20k_groups", "k_above_n")
ROUNDS, REPEATS, PROFILED = 5, 3, 2


def _case_inputs(name):
    """(group pointer, scores, labels, k) of a case, made from a seed."""
    import numpy as np

    mslr = np.random.default_rng(20).integers(40, 200, size=31_531)
    sizes, k = {"mslr": (mslr, 32),
                "20k_groups": (np.array([20_000, 20_000, 150]), 32),
                "k_above_n": (mslr[:4000], 256)}[name]
    gp = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    rng = np.random.default_rng(CASES.index(name))
    R = int(gp[-1]) + 1000
    s = rng.normal(size=R).astype(np.float32)
    y = rng.integers(0, 5, R).astype(np.float32)
    return gp, s, y, k


def _profile(fn, reps):
    """torch.profiler over ``reps`` calls, each one K5 launch: (device ms a
    call, K5's device ms a launch), both over the K5 launches it saw (it
    may miss a call's events); None where it saw none in three tries."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = k5 = 0.0
        k5_n = 0
        for r in prof.key_averages():
            if r.device_type != DeviceType.CUDA:
                continue
            t = getattr(r, "self_device_time_total", None)
            us = r.self_cuda_time_total if t is None else t
            total += us
            if "lambdarank" in r.key:
                k5 += us
                k5_n += r.count
        if k5_n:
            return total / 1e3 / k5_n, k5 / 1e3 / k5_n
    return None, None


def _event_ms(fn, reps=20):
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _worker(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    import chip_smoke as cs
    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch.ops import hist_cuda
    from xgboost_tpu_torch.ops.lambdarank_cuda import (GroupLayout,
                                                       lambdarank_topk_cuda)

    hist_cuda.build_all()
    cases = {}
    for name in CASES:
        gp, s, y, k = _case_inputs(name)
        s, y = torch.from_numpy(s).cuda(), torch.from_numpy(y).cuda()
        layout = GroupLayout(gp, "cuda")

        def call():
            return lambdarank_topk_cuda(s, y, layout, k, True, True, True)
        out = call()
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        call_ms, launch_ms = _profile(call, 5)
        cases[name] = dict(event_ms=_event_ms(call), call_device_ms=call_ms,
                           launch_device_ms=launch_ms, sha256=digest)

    X, y, sizes = cs.make_mslr()
    d = xtt.DMatrix(X, label=y, group=sizes)
    del X
    params = dict(cs.MSLR_PARAMS)
    xtt.train(params, d, 1, verbose_eval=False)  # warm
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xtt.train(params, d, ROUNDS, verbose_eval=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        xtt.train(params, d, PROFILED, verbose_eval=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = k5 = 0.0
    for r in prof.key_averages():
        if r.device_type != DeviceType.CUDA:
            continue
        t = getattr(r, "self_device_time_total", None)
        ms = (r.self_cuda_time_total if t is None else t) / 1e3
        busy += ms
        if "lambdarank" in r.key:
            k5 += ms
    rows = int(np.sum(sizes))
    train = dict(train_s=statistics.median(times), times=times,
                 rate=rows * ROUNDS / statistics.median(times) / 1e6,
                 wall_ms=wall_ms, busy_ms=busy,
                 idle=1.0 - busy / wall_ms if busy else None, k5_ms=k5)
    return dict(device=torch.cuda.get_device_name(0), cases=cases,
                train=train)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="label=DIR")
    ap.add_argument("--out", default="chiprun_out/lambdarank_ab.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        import torch
        if not torch.cuda.is_available():
            print("lambdarank_ab: no CUDA device", file=sys.stderr)
            return 1
        print("RESULT " + json.dumps(_worker(args.worker)), flush=True)
        return 0

    trees = [tuple(t.split("=", 1)) for t in args.trees]
    if not trees or any(len(t) != 2 for t in trees):
        ap.error("name at least one tree as label=DIR")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
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
    same = True
    for name in CASES:
        print(f"{name}: CUDA-event ms a call | device ms a call | K5 ms a "
              f"launch | output sha256")
        for r in runs:
            c = r["cases"][name]
            print(f"  {r['label']:>8s} {c['event_ms']:.4f} | "
                  f"{c['call_device_ms']} | {c['launch_device_ms']} | "
                  f"{c['sha256'][:16]}")
        same &= len({r["cases"][name]["sha256"] for r in runs}) == 1
    print(f"rank:ndcg train loop s (median of {REPEATS} x {ROUNDS} rounds) "
          f"| M row-rounds/s | {PROFILED} profiled rounds: wall / busy ms, "
          f"idle, K5 ms")
    for r in runs:
        p = r["train"]
        print(f"  {r['label']:>8s} {p['train_s']:.3f} "
              f"({' '.join(f'{t:.3f}' for t in p['times'])}) | "
              f"{p['rate']:.3f} | {p['wall_ms']:.3f} / {p['busy_ms']:.3f}, "
              f"{p['idle']}, {p['k5_ms']:.3f}")
    if not same:
        print("the trees' K5 outputs differ", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
