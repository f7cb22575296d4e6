"""Time K6 (TreeSHAP values and interactions) of several trees in turns on
one GPU.

    python3 scripts/treeshap_ab.py parent=_proof/parent change=. \\
        [--out chiprun_out/treeshap_ab.json] [--models DIR]

Each ``label=DIR`` names a checkout that holds ``xgboost_tpu_torch/`` and
``chip_smoke.py``.  First the last tree's package trains the models of
``chip_smoke.py``'s phase 18 on the card (phase 3's HIGGS model, 1M x 28,
10 rounds of depth 6; phase 6's lossguide model, 255 leaves; phase 17a's
uniform/tree DART model; phase 8's Covertype model, 581,012 x 54, 7
classes x 5 rounds of depth 8; a deep ensemble, 300 rounds of depth 8 on
200,000 HIGGS rows) and saves them as JSON, which every tree loads.  Then the trees run in the order given and in reverse (A, B, B, A),
each turn in a fresh process that builds that tree's kernels from its
sources.  Each turn, at phase 18's shapes (HIGGS values over 1M rows,
Covertype's 7 groups over its rows, lossguide and DART over 2^16 rows,
HIGGS interactions over 2^16 rows) and at the deep ensemble's values and
interactions over 1,000 rows (a large model and a small call), over every
output group that has a split:

- for a tree whose wrapper has ``tab_floats``, the MB of its table;
- the median of 20 CUDA-event times of K6's ``launch`` and of
  ``treeshap_cuda`` (the wrapper's layout included), summed over the
  groups;
- torch.profiler's device time a K6 launch;
- a sha256 of the output's bits (``treeshap_cuda``, every group);
- for a tree whose ``launch`` takes ``rows_per_thread``, the same
  CUDA-event time at 1 and 2 rows a thread;
- in its first turn, ptxas's registers, spills and shared memory of each
  kernel of the tree's ``csrc/treeshap.cu`` (``nvcc -Xptxas -v`` with its
  own flags), and of each m template alone where the source can build
  one.

Prints a table and writes every number to ``--out``.  Exits non-zero if a
turn fails, the trees' outputs differ, or no GPU is present.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile

CASES = ("higgs", "covertype", "lossguide", "dart", "interactions", "deep",
         "deep_interactions")
SMALL_ROWS = 1 << 16  # chip_smoke.P18_ROWS
DEEP_ROWS = 1000
DEEP = dict(max_depth=8)  # beside chip_smoke.BASE, 300 rounds
REPS = 20


def _train(tree: str, models: str) -> None:
    """Train phase 18's models with ``tree``'s package; save their JSON."""
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke as cs
    import xgboost_tpu_torch as xtt

    X, y = cs.make_data(1_000_000, 28)
    d = xtt.DMatrix(X, label=y)
    for name, params in (("higgs", cs.BASE), ("lossguide", cs.LOSSGUIDE),
                         ("dart", cs.P17_DART["uniform/tree"])):
        xtt.train(params, d, 10, verbose_eval=False).save_model(
            os.path.join(models, f"{name}.json"))
    d = xtt.DMatrix(X[:200_000], label=y[:200_000])
    xtt.train(dict(cs.BASE, **DEEP), d, 300, verbose_eval=False).save_model(
        os.path.join(models, "deep.json"))
    del d, X, y
    Xc, yc = cs.make_covertype()
    xtt.train(cs.COVER, xtt.DMatrix(Xc, label=yc), 5,
              verbose_eval=False).save_model(
                  os.path.join(models, "covertype.json"))


def _ptxas(hist_cuda) -> dict:
    """{build: ptxas's lines} of the tree's csrc/treeshap.cu: the whole
    source, and where it has the K6_ONLY_M switch, each m template alone
    (m = 1 to 8, and 0 for the paths past eight), all nvcc at once."""
    src = hist_cuda._src_path("treeshap")
    with open(src) as fh:
        per_m = "K6_ONLY_M" in fh.read()
    builds = {"all": []}
    if per_m:
        builds.update({f"m={m}": [f"-DK6_ONLY_M={m}"] for m in range(9)})
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: subprocess.Popen(
            [hist_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", *hist_cuda.EXTRA_FLAGS.get("treeshap", []),
             *flags, "-Xptxas", "-v", "-cubin", "-o",
             os.path.join(tmp, f"{i}.cubin"), src],
            stderr=subprocess.PIPE, text=True)
            for i, (name, flags) in enumerate(builds.items())}
        out = {}
        for name, proc in procs.items():
            err = proc.communicate()[1]
            lines, kernel = [], None
            for line in err.splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1]
                elif "Used" in line or "spill" in line:
                    lines.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
            out[name] = lines
    return out


def _event_ms(fn, reps=REPS):
    import torch

    for _ in range(2):
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


def _profile_ms(fn, reps=5):
    """torch.profiler's device time a K6 launch over ``reps`` calls; None
    where it saw no K6 kernel in three tries."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for r in prof.key_averages():
            if r.device_type != DeviceType.CUDA or "treeshap" not in r.key:
                continue
            t = getattr(r, "self_device_time_total", None)
            us += r.self_cuda_time_total if t is None else t
            n += r.count
        if n:
            return us / 1e3 / n
    return None


def _worker(tree: str, models: str, ptxas: bool) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as cs
    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch.interpret import device as dv
    from xgboost_tpu_torch.ops import hist_cuda
    from xgboost_tpu_torch.ops import treeshap_cuda as tc

    hist_cuda.build_all()
    takes_rt = "rows_per_thread" in inspect.signature(tc.launch).parameters
    X = torch.from_numpy(cs.make_data(1_000_000, 28)[0]).cuda()
    Xc = torch.from_numpy(cs.make_covertype()[0]).cuda()
    cases = {}
    for name in CASES:
        model = {"interactions": "higgs",
                 "deep_interactions": "deep"}.get(name, name)
        bst = xtt.Booster(model_file=os.path.join(models, f"{model}.json"))
        Xd = {"higgs": X, "covertype": Xc}.get(
            name, X[:DEEP_ROWS] if model == "deep" else X[:SMALL_ROWS])
        inter = name.endswith("interactions")
        parts = [t for t in (dv.path_tables(trees, wts, Xd.shape[1])
                             for trees, wts in cs._groups(bst).values())
                 if t.buckets]
        pks = [t.packed(inter, Xd.device) for t in parts]
        digest = hashlib.sha256()
        for t in parts:
            out = tc.treeshap_cuda(Xd, t, inter)
            digest.update(out.contiguous().cpu().numpy().tobytes())
            del out
        res = dict(groups=len(parts), rows=Xd.shape[0],
                   paths=sum(s[2] for pk in pks for s in pk.shapes),
                   max_m=max(pk.max_m for pk in pks),
                   sha256=digest.hexdigest())
        if hasattr(tc, "tab_floats"):
            res["tab_mb"] = sum(4 * tc.tab_floats(pk, Xd.shape[0])
                                for pk in pks) / 1e6
        torch.cuda.empty_cache()
        res["launch_ms"] = _event_ms(
            lambda: [tc.launch(Xd, pk) for pk in pks])
        res["call_ms"] = _event_ms(
            lambda: [tc.treeshap_cuda(Xd, t, inter) for t in parts])
        res["device_ms_a_launch"] = _profile_ms(
            lambda: [tc.launch(Xd, pk) for pk in pks])
        if takes_rt:
            res["rows_per_thread_ms"] = {
                rt: _event_ms(lambda: [tc.launch(Xd, pk, rows_per_thread=rt)
                                       for pk in pks])
                for rt in (1, 2)}
            res["plan"] = [list(tc.plan(pk)) for pk in pks]
        cases[name] = res
        del bst, Xd, parts, pks
        torch.cuda.empty_cache()
    return dict(device=torch.cuda.get_device_name(0), cases=cases,
                ptxas=_ptxas(hist_cuda) if ptxas else {})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="label=DIR")
    ap.add_argument("--out", default="chiprun_out/treeshap_ab.json")
    ap.add_argument("--models", help="the models' directory (default: a "
                    "temporary one, trained anew)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--train", help=argparse.SUPPRESS)
    ap.add_argument("--ptxas", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker or args.train:
        import torch
        if not torch.cuda.is_available():
            print("treeshap_ab: no CUDA device", file=sys.stderr)
            return 1
        if args.train:
            _train(args.train, args.models)
            return 0
        print("RESULT " + json.dumps(_worker(args.worker, args.models,
                                             args.ptxas)), flush=True)
        return 0

    trees = [tuple(t.split("=", 1)) for t in args.trees]
    if not trees or any(len(t) != 2 for t in trees):
        ap.error("name at least one tree as label=DIR")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        models = args.models or tmp
        if not args.models:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--train",
                 trees[-1][1], "--models", models],
                capture_output=True, text=True)
            if proc.returncode != 0:
                print(f"training failed (rc {proc.returncode}):\n"
                      f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
                return 1
            print(f"models trained with {trees[-1][0]}'s package",
                  flush=True)
        runs = []
        for turn, (label, tree) in enumerate(trees + trees[::-1]):
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   tree, "--models", models] + (["--ptxas"] if turn < len(
                       trees) else [])
            proc = subprocess.run(cmd, capture_output=True, text=True)
            line = [x for x in proc.stdout.splitlines()
                    if x.startswith("RESULT ")]
            if proc.returncode != 0 or not line:
                print(f"turn {label} failed (rc {proc.returncode}):\n"
                      f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}",
                      flush=True)
                return 1
            runs.append(dict(label=label, tree=tree,
                             **json.loads(line[0][len("RESULT "):])))
            print(f"turn {len(runs)}: {label} done", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(card=smi, runs=runs), fh, indent=1)
    same = True
    for name in CASES:
        c0 = runs[0]["cases"][name]
        print(f"{name} ({c0['groups']} groups, {c0['rows']} rows, "
              f"{c0['paths']} paths, m <= {c0['max_m']}): ms a launch "
              f"(CUDA events) | a call | device ms a launch (profiler) | "
              f"1 / 2 rows a thread | sha256")
        for r in runs:
            c = r["cases"][name]
            rt = c.get("rows_per_thread_ms")
            rt = " / ".join(f"{v:.4f}" for v in rt.values()) if rt else "-"
            dev = c["device_ms_a_launch"]
            tab = c.get("tab_mb")
            print(f"  {r['label']:>8s} {c['launch_ms']:.4f} | "
                  f"{c['call_ms']:.4f} | "
                  f"{'-' if dev is None else f'{dev:.4f}'} | {rt} | "
                  f"{c['sha256'][:16]}"
                  + ("" if tab is None else f" | table {tab:.1f} MB"))
        same &= len({r["cases"][name]["sha256"] for r in runs}) == 1
    for r in runs[:len(trees)]:
        for build, lines in r["ptxas"].items():
            print(f"ptxas, {r['label']}, {build}:")
            for line in lines:
                print(f"  {line}")
    if not same:
        print("the trees' K6 outputs differ", flush=True)
        return 1
    print("the trees' K6 outputs are the same bits at every shape")
    return 0


if __name__ == "__main__":
    sys.exit(main())
