"""Time the port's histogram kernels of several trees in turns on one GPU.

    python3 scripts/hist_ab.py parent=_proof/parent change=. \\
        [--out chiprun_out/hist_ab.json]

Each ``label=DIR`` names a directory that holds a checkout's
``xgboost_tpu_torch/``.  The trees run in the order
given and then in reverse (A, B, B, A), each turn in a fresh process that
builds that tree's kernels from its sources and times them on the same
inputs (made from fixed seeds with numpy): R = 1,048,576 rows, F = 28,
int16 bins at B = 256 with ~5% missing, ~2% pad rows, at the six levels a
depth-6 round builds, the 16-node span (15, 16, 2) and the node-tiled
level (255, 128, 2).  K1 (f32) is held against its plain version within
1e-5 of the largest cell, K2 (exact int32 limbs) bitwise.  Each turn also
counts the atomic instructions in each built library's SASS
(``cuobjdump -sass``): a shared-memory add that the card runs natively is
an ``ATOMS.ADD``, one it emulates a compare-and-swap loop
(``ATOMS.CAS``/``ATOMS.CAST.SPIN``).

Per case: ``ms``, the median of 20 CUDA-event timings of one call each
after 3 warm-up calls (chip_smoke.py's definition), and ``ms_batched``,
20 calls between two events over 20; ``library_ms``, one index_add_ over
precomputed flat indices.  Prints a table and, per tree, the six-level sum;
writes every number to ``--out``.  Exits non-zero if a kernel disagrees or
no GPU is present.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np

LEVELS = ((0, 1, 1), (1, 1, 2), (3, 2, 2), (7, 4, 2), (15, 8, 2),
          (31, 16, 2))
K1_SHAPES = LEVELS + ((15, 16, 2), (255, 128, 2))
K2_SHAPES = LEVELS + ((15, 16, 2), (255, 128, 2))
R, F, N_BIN = 1 << 20, 28, 256
REPS = 20


def _sass_atomics(hist_cuda) -> dict:
    """Per kernel library, the count of each atomic or reduction opcode in
    its SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name in hist_cuda.SOURCES:
        sass = subprocess.run([tool, "-sass", hist_cuda._lib_path(name)],
                              capture_output=True, text=True,
                              check=True).stdout
        out[name] = dict(collections.Counter(re.findall(
            r"\b(?:ATOMS|ATOMG|ATOM|REDG|RED)(?:\.[A-Z0-9_]+)*", sass)))
    return out


def _worker(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from xgboost_tpu_torch.ops import hist_cuda

    hist_cuda.build_all()
    sass = _sass_atomics(hist_cuda)

    def per_call(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def batched(fn):
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / REPS

    rng = np.random.default_rng(1)
    b = rng.integers(0, N_BIN, size=(R, F), dtype=np.int64)
    b[rng.random((R, F)) < 0.05] = N_BIN  # missing -> sentinel
    bins = torch.from_numpy(b).to(torch.int16).cuda()
    gpair = torch.from_numpy(np.stack(
        [rng.normal(size=R), rng.random(R)], 1).astype(np.float32)).cuda()
    from xgboost_tpu_torch.ops.quantise import local_rho, quantise_gpair
    gq = quantise_gpair(gpair, local_rho(gpair, torch.ones(
        R, dtype=torch.bool, device="cuda")))
    cases = []
    for name, shapes in (("hist_f32", K1_SHAPES), ("hist_q", K2_SHAPES)):
        if name == "hist_f32":
            kernel, plain = (hist_cuda.build_histogram_cuda,
                             hist_cuda.build_histogram_plain)
            vals, ch, acc = gpair, 2, torch.float32
        else:
            kernel, plain = (hist_cuda.build_histogram_q_cuda,
                             hist_cuda.build_histogram_q_plain)
            vals, ch, acc = gq, 6, torch.int32
        for node0, n_nodes, stride in shapes:
            p = np.random.default_rng(node0 + n_nodes).integers(
                node0, node0 + stride * n_nodes, size=R)
            p[np.random.default_rng(7).random(R) < 0.02] = -1  # pad rows
            pos = torch.from_numpy(p.astype(np.int32)).cuda()
            kw = dict(node0=node0, n_nodes=n_nodes, n_bin=N_BIN,
                      stride=stride)
            got = kernel(bins, vals, pos, **kw)
            want = plain(bins, vals, pos, **kw)
            err = float((got - want).abs().max().item())
            scale = float(want.abs().max().item())
            ok = err <= 1e-5 * scale if name == "hist_f32" else err == 0.0
            local = pos.long() - node0
            inl = ((local >= 0) & (local % stride == 0)
                   & (local // stride < n_nodes))
            take = inl[:, None] & (bins.long() < N_BIN)
            idx = ((local // stride)[:, None] * F
                   + torch.arange(F, device="cuda")[None, :]) * N_BIN \
                + bins.long()
            flat_idx = idx[take]
            flat_val = vals.reshape(R, 1, ch).to(acc).expand(R, F, ch)[take]
            flat = torch.zeros(n_nodes * F * N_BIN, ch, dtype=acc,
                               device="cuda")
            plan = None
            if name == "hist_f32" and hasattr(hist_cuda, "plan_f32"):
                card = hist_cuda.card_max_clusters(bins.device, bins.dtype)
                plan = list(hist_cuda.plan_f32(R, F, n_nodes, N_BIN, card,
                                               stride))
            if name == "hist_q" and hasattr(hist_cuda, "plan_q"):
                card = hist_cuda.card_max_clusters(bins.device, bins.dtype,
                                                   "hist_q")
                plan = list(hist_cuda.plan_q(R, F, n_nodes, N_BIN, 6, card,
                                             stride))
            cases.append(dict(
                kernel=name, shape=[node0, n_nodes, stride], ok=ok,
                max_abs_err=err, max_rel_err=err / scale if scale else 0.0,
                ms=per_call(lambda: kernel(bins, vals, pos, **kw)),
                ms_batched=batched(lambda: kernel(bins, vals, pos, **kw)),
                library_ms=per_call(
                    lambda: flat.index_add_(0, flat_idx, flat_val)),
                plan=plan))
    return dict(device=torch.cuda.get_device_name(0), sass=sass, cases=cases)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="label=DIR")
    ap.add_argument("--out", default="chiprun_out/hist_ab.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        import torch
        if not torch.cuda.is_available():
            print("hist_ab: no CUDA device", file=sys.stderr)
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
        print(f"turn {len(runs)}: {label} done; SASS atomics "
              f"{runs[-1]['sass']}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(card=smi, runs=runs), fh, indent=1)
    head = " ".join(f"{r['label']:>9s}" for r in runs)
    print(f"{'kernel':8s} {'shape':14s} {head}   index_add_  (ms: median of "
          f"{REPS} per-call CUDA-event timings; [batched])")
    bad = []
    for i, case in enumerate(runs[0]["cases"]):
        row = [r["cases"][i] for r in runs]
        bad += [(r["label"], c["kernel"], c["shape"]) for r, c in
                zip(runs, row) if not c["ok"]]
        cells = " ".join(f"{c['ms']:9.4f}" for c in row)
        batch = " ".join(f"{c['ms_batched']:.4f}" for c in row)
        plans = {r["label"]: c["plan"] for r, c in zip(runs, row)
                 if c["plan"]}
        print(f"{case['kernel']:8s} {str(tuple(case['shape'])):14s} {cells}"
              f"   {row[-1]['library_ms']:.4f}  [{batch}]  plans {plans}")
    for name in ("hist_f32", "hist_q"):
        for key in ("ms", "ms_batched"):
            sums = [sum(c[key] for c in r["cases"] if c["kernel"] == name
                        and tuple(c["shape"]) in LEVELS) for r in runs]
            print(f"{name} six-level sum of {key} per turn: " + " ".join(
                f"{r['label']}={s:.4f}" for r, s in zip(runs, sums)))
    print(f"max error of K1 over the plain version, of the largest cell: "
          f"{max(c['max_rel_err'] for r in runs for c in r['cases']):.3g}")
    if bad:
        print(f"DISAGREE: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
