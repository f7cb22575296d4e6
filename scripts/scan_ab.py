"""Time the port's split scan (K3) and logistic kernels (K4) of several
trees in turns on one GPU.

    python3 scripts/scan_ab.py parent=_proof/parent change=. \\
        [--out scan_ab.json]

Each ``label=DIR`` names a directory that holds a checkout's
``xgboost_tpu_torch/``.  The trees run in the order given and then in
reverse (A, B, B, A), each turn in a fresh process that builds that tree's
kernels from its sources and times them on the same inputs, made from
fixed seeds by chip_smoke.py's generators (of the checkout that holds this
script):

- K3 through ``split_scan_cuda`` at chip_smoke phase 2c's shapes (the six
  levels of a depth-6 round, N = 1-32 x 28 x 256, unconstrained and
  monotone) and phase 2e's (N = 1-64 x 39 x 128, 26 categorical features,
  partition and one-hot), each held bitwise against ``split_scan_plain``;
- K4's sigmoid through ``sigmoid_cuda`` on 1,000,448 margins, bitwise
  against ``sigmoid_f32``;
- the binary:logistic gradient through the objective's ``get_gradient``
  on the same margins, without and with weights and scale_pos_weight,
  bitwise against the same call on CPU tensors (each tree's plain path).

Per case: ``ms``, the median of 20 CUDA-event timings of one call each
after 3 warm-up calls (chip_smoke.py's definition, host launch included);
``ms_batched``, 20 calls between two events over 20; ``device_ms`` and
``launches``, the device time and the kernels of one call from
torch.profiler; ``host_ms``, the host's time a call, 200 calls issued
without a synchronisation.  The split layer (``evaluate_splits``: K3 and
the sums and weights its caller forms) is timed too at the native
levels.  Prints a table and the level sums per turn, writes every
number to ``--out``.  Exits non-zero if a kernel disagrees or no GPU is
present.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """chip_smoke.py of this script's checkout: input generators and
    timers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _equal(a, b) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
        import torch

        nan = torch.isnan(b)
        return bool(torch.equal(torch.isnan(a), nan) and torch.equal(
            a[~nan].view(torch.int32), b[~nan].view(torch.int32)))
    return bool((a == b).all())


def _worker(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from xgboost_tpu_torch.objective import create_objective
    from xgboost_tpu_torch.ops import hist_cuda
    from xgboost_tpu_torch.ops.sigmoid_cuda import sigmoid_cuda
    from xgboost_tpu_torch.ops.split import (SplitParams, evaluate_splits,
                                             is_monotone, monotone_vec,
                                             split_scan_plain)
    from xgboost_tpu_torch.ops.split_cuda import split_scan_cuda
    from xgboost_tpu_torch.utils.fp import sigmoid_f32

    cs = _chip_smoke()
    hist_cuda.build_all()
    cases = []

    def host_ms(fn, calls=200):
        """The host's time a call, the calls issued back to back without a
        synchronisation (median of three batches)."""
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e3)
            torch.cuda.synchronize()
        return statistics.median(times)

    def measure(group, n, fn, ok):
        device_ms, launches, _ = cs.device_per_call(fn)
        cases.append(dict(group=group, n=n, ok=ok, ms=cs.cuda_ms(fn),
                          ms_batched=cs.batched_ms(fn), device_ms=device_ms,
                          launches=launches, host_ms=host_ms(fn)))

    for mode in ("native", "monotone"):
        for N in cs.SCAN_LEVELS:
            h, tot, nb, fm, bounds, mono = cs._scan_inputs(
                N, cs.SCAN_F, cs.SCAN_B, seed=N)
            p = SplitParams(eta=0.3, gamma=0.0, min_child_weight=1.0,
                            lambda_=1.0, alpha=0.0, max_delta_step=0.0,
                            monotone=mono if mode == "monotone" else None)
            args = [t.cuda() for t in (h, tot, nb, fm, bounds)]
            mvec = (monotone_vec(mono, args[0].device) if is_monotone(p)
                    else None)

            def k3():
                return split_scan_cuda(*args[:3], p, args[3], args[4], mvec)
            want = split_scan_plain(*args[:3], p, args[3], args[4])
            measure(f"K3 {mode}", N, k3,
                    all(_equal(a, b) for a, b in zip(k3(), want)))
            if mode == "native":  # the split layer: K3 and its caller
                def layer():
                    return evaluate_splits(*args[:3], p, args[3], args[4])
                want = evaluate_splits(h, tot, nb, p, fm, bounds)
                measure("split layer (evaluate_splits)", N, layer,
                        all(_equal(a, b) for a, b in zip(layer(), want)))
    for onehot in (4, 128):
        for N in cs.CAT_LEVELS:
            h, tot, nb, fm, cm, _ = cs._cat_scan_inputs(N, seed=N + onehot)
            p = SplitParams(eta=0.3, gamma=0.0, min_child_weight=1.0,
                            lambda_=1.0, alpha=0.0, max_delta_step=0.0,
                            max_cat_to_onehot=onehot)
            card = [t.cuda() for t in (h, tot, nb, fm, cm)]

            def k3():
                return split_scan_cuda(*card[:3], p, card[3], None, None,
                                       card[4])
            want = split_scan_plain(*card[:3], p, card[3], None, card[4])
            label = "partition" if onehot == 4 else "one-hot"
            measure(f"K3 categorical {label}", N, k3,
                    all(_equal(a, b) for a, b in zip(k3(), want)))

    x = torch.from_numpy(cs._margins(cs.SIGMOID_N))
    xc = x.cuda()
    measure("K4 sigmoid", cs.SIGMOID_N, lambda: sigmoid_cuda(xc),
            _equal(sigmoid_cuda(xc), sigmoid_f32(x)))
    rng = np.random.default_rng(6)
    y = torch.from_numpy((rng.random(x.numel()) < 0.4).astype(np.float32))
    w = torch.from_numpy((rng.random(x.numel()) + 0.01).astype(np.float32))
    for weighted, spw in ((False, 1.0), (True, 2.5)):
        obj = create_objective("binary:logistic", {"scale_pos_weight": spw})
        wc = w if weighted else None
        card = (xc[:, None], y.cuda(), None if wc is None else wc.cuda())
        want = obj.get_gradient(x[:, None], y, wc)
        measure(f"K4 gradient{' weighted, spw 2.5' if weighted else ''}",
                cs.SIGMOID_N, lambda: obj.get_gradient(*card),
                _equal(obj.get_gradient(*card), want))
    return dict(device=torch.cuda.get_device_name(0), cases=cases)


def _fmt(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="label=DIR")
    ap.add_argument("--out", default="scan_ab.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        import torch
        if not torch.cuda.is_available():
            print("scan_ab: no CUDA device", file=sys.stderr)
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
    head = " ".join(f"{r['label']:>9s}" for r in runs)
    print(f"{'case':38s} {head}   (ms per call: median of 20 CUDA-event "
          "timings; [batched]; {device ms a call/launches a call}; <host ms "
          "a call>)")
    bad = []
    for i, case in enumerate(runs[0]["cases"]):
        row = [r["cases"][i] for r in runs]
        bad += [(r["label"], c["group"], c["n"]) for r, c in zip(runs, row)
                if not c["ok"]]
        cells = " ".join(f"{c['ms']:9.4f}" for c in row)
        batch = " ".join(f"{c['ms_batched']:.4f}" for c in row)
        dev = " ".join(f"{_fmt(c['device_ms'])}/{c['launches']:g}"
                       for c in row)
        host = " ".join(f"{c['host_ms']:.4f}" for c in row)
        print(f"{case['group'] + ' ' + str(case['n']):38s} {cells}  [{batch}]"
              f"  {{{dev}}}  host <{host}>")
    for group in dict.fromkeys(c["group"] for c in runs[0]["cases"]):
        if group.startswith("K4"):
            continue
        for key in ("ms", "ms_batched", "device_ms", "host_ms"):
            sums = []
            for r in runs:
                vals = [c[key] for c in r["cases"] if c["group"] == group]
                sums.append(None if None in vals else sum(vals))
            print(f"{group} level sum of {key} per turn: " + " ".join(
                f"{r['label']}={_fmt(s)}" for r, s in zip(runs, sums)))
    if bad:
        print(f"DISAGREE: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
