"""Smoke run of xgboost_tpu_torch on one NVIDIA GPU.

Drives the port's two training paths through its public entry points and
holds each CUDA kernel against its plain PyTorch version:

  1. device: card name and power limit; build every kernel library (one
     nvcc per source, all at once) and load it
  2. K1 vs plain: the f32 histogram kernel (csrc/hist.cu) against
     build_histogram_plain at R=1,048,576 x F=28, B=256, int16 and uint8
     bins, within 1e-5 of the largest cell, with timings of the kernel, the
     plain version, one index_add_ call (a yardstick the port never calls)
     and the memory bound; plus a 128-node level whose nodes are tiled
  2b. K2 vs plain: the exact limb histogram kernel (csrc/hist_q.cu) against
     build_histogram_q_plain at the same shapes, bitwise
  3. train: 1,000,000 x 28 HIGGS-shaped rows, binary:logistic, max_bin=256,
     max_depth=6, eta=0.3, 10 rounds, evaluated on the training set; K1
     launches 6 times per round and K2 never
  3b. profile: device time by kernel over two training rounds and the
     card's idle share
  3c. the same training with deterministic_histogram=1: K2 launches 6 times
     per round and K1 never, and two runs write byte-identical models
  3d. profile of 3c
  4. predict 100k rows, save JSON and UBJ, reload, predict identically
  5. small-input parity: the same small training on the card and on the CPU
     (whose histograms are the plain versions the tests hold against the
     JAX reference) must grow the same trees
  5b. phase 5 under deterministic_histogram=1, alone and with monotone and
     interaction constraints, column sampling and max_leaves; the
     constrained model at full width must not decrease along feature 0

Run from the repository root: ``python3 chip_smoke.py``.  Exits non-zero if
any phase fails or no CUDA device is present.  Each phase prints its
seconds.  The last three lines are the card's name and power limit, the
kernels JSON line and the device JSON line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# H100 SXM f32 outside the tensor cores; K2's int32 adds are counted at the
# same 32-bit rate (the bound is the bytes either way)
F32_FLOPS = 67e12
HIST_RTOL = 1e-5  # of the histogram's largest cell: f32 sums in other orders


def make_data(n: int, f: int, seed: int = 0):
    """HIGGS-like: informative low-order interactions + noise features
    (the workload formula of bench.py)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    logits = (
        1.5 * X[:, 0]
        + X[:, 1] * X[:, 2]
        - 0.8 * np.abs(X[:, 3])
        + 0.5 * X[:, 4]
        + 0.3 * rng.normal(size=n)
    )
    y = (logits > 0).astype(np.float32)
    return X, y


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of per-call CUDA-event times, after warm-up."""
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


def phase_device(hist_cuda):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    hist_cuda.build_all()  # one nvcc per kernel source, all at once
    for name in hist_cuda.SOURCES:
        hist_cuda.load_library(name)
    build_s = time.perf_counter() - t0
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; kernels "
        f"{sorted(hist_cuda.SOURCES)} built and loaded in {build_s:.3f} s")
    return smi


def _limbs(gpair):
    from xgboost_tpu_torch.ops.quantise import local_rho, quantise_gpair

    valid = torch.ones(gpair.shape[0], dtype=torch.bool, device=gpair.device)
    return quantise_gpair(gpair, local_rho(gpair, valid))


def _case(hist_cuda, name, bins, vals, pos, *, node0, n_nodes, n_bin,
          stride):
    """One kernel-vs-plain case on the card: agreement, the kernel's, the
    plain version's and one index_add_'s times, and the bound."""
    if name == "hist_f32":
        kernel = hist_cuda.build_histogram_cuda
        plain = hist_cuda.build_histogram_plain
        ch, row_bytes, acc = 2, 8, torch.float32
    else:
        kernel = hist_cuda.build_histogram_q_cuda
        plain = hist_cuda.build_histogram_q_plain
        ch, row_bytes, acc = 6, 6, torch.int32
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=n_bin, stride=stride)
    got = kernel(bins, vals, pos, **kw)
    torch.cuda.synchronize()
    want = plain(bins, vals, pos, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max().item())
    scale = float(want.abs().max().item())
    # K1: f32 sums in another order; K2: exact integers, bitwise
    ok = err <= HIST_RTOL * scale if name == "hist_f32" else err == 0.0

    # yardstick: one index_add_ over precomputed flat indices, into a flat
    # tensor of the kernel's accumulator type (f32 for K1, int32 for K2)
    R, F = bins.shape
    local = pos.long() - node0
    inl = (local >= 0) & (local % stride == 0) & (local // stride < n_nodes)
    take = inl[:, None] & (bins.long() < n_bin)
    idx = ((local // stride)[:, None] * F
           + torch.arange(F, device="cuda")[None, :]) * n_bin + bins.long()
    flat_idx = idx[take]
    flat_val = vals.reshape(R, 1, ch).to(acc).expand(R, F, ch)[take]
    flat = torch.zeros(n_nodes * F * n_bin, ch, dtype=acc, device="cuda")

    kernel_ms = cuda_ms(lambda: kernel(bins, vals, pos, **kw))
    plain_ms = cuda_ms(lambda: plain(bins, vals, pos, **kw), reps=5)
    library_ms = cuda_ms(lambda: flat.index_add_(0, flat_idx, flat_val))

    # least work these inputs need: pos of every row, bins and gradients of
    # the rows in the level, the histogram written once; one 32-bit add per
    # (row, feature, channel) present
    n_in = int(inl.sum().item())
    n_bytes = (4 * R + n_in * (F * bins.element_size() + row_bytes)
               + n_nodes * F * n_bin * ch * 4)
    n_ops = ch * int(take.sum().item())
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS
    return dict(kernel=name, dtype=str(bins.dtype).split(".")[-1],
                node0=node0, n_nodes=n_nodes, stride=stride,
                max_abs_err=err, max_rel_err=err / scale if scale else 0.0,
                ok=ok, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# (node0, n_nodes, stride): the root and two 16-node left-child levels of
# a depth-6 tree, and a 128-node level of a depth-9 tree, whose nodes the
# kernels split over blocks
SHAPES = ((0, 1, 1), (15, 16, 2), (31, 16, 2))
TILED = (255, 128, 2)


def phase_kernels(hist_cuda, name: str, label: str):
    """K1 or K2 against its plain version at the bench shapes, int16 and
    uint8 bins, plus the node-tiled level at int16."""
    R, F = 1 << 20, 28
    rng = np.random.default_rng(1)
    cases = []
    for dtype, n_bin in ((torch.int16, 256), (torch.uint8, 254)):
        b = rng.integers(0, n_bin, size=(R, F), dtype=np.int64)
        b[rng.random((R, F)) < 0.05] = n_bin  # ~5% missing -> sentinel
        bins = torch.from_numpy(b).to(dtype).cuda()
        gpair = torch.from_numpy(np.stack(
            [rng.normal(size=R), rng.random(R)], 1).astype(np.float32)).cuda()
        vals = gpair if name == "hist_f32" else _limbs(gpair)
        shapes = SHAPES + ((TILED,) if dtype == torch.int16 else ())
        for node0, n_nodes, stride in shapes:
            p = rng.integers(node0, node0 + stride * n_nodes, size=R)
            p[rng.random(R) < 0.02] = -1  # pad rows
            pos = torch.from_numpy(p.astype(np.int32)).cuda()
            case = _case(hist_cuda, name, bins, vals, pos, node0=node0,
                         n_nodes=n_nodes, n_bin=n_bin, stride=stride)
            cases.append(case)
            log(f"phase {label} kernel vs plain: " + json.dumps(case))
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"{name} disagrees with its plain version: {bad}")
    return cases


BASE = {"objective": "binary:logistic", "max_depth": 6, "max_bin": 256,
        "eta": 0.3, "tree_method": "hist"}
DET = dict(BASE, deterministic_histogram=1)


def _model_bytes(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _train_main_path(xtt, hist_cuda, params, dtrain, n_rows, rounds, kernel,
                     label, repeats: int = 3):
    """One path as a user runs it: train with the training-set eval, then
    the train loop alone ``repeats`` times (as bench.py times it: no evals,
    bins already built), each run with the launch counts set to 0 just
    before and read just after.  Returns the first two boosters, the first
    run's launches, the metrics and the timed loops' median rate."""
    want = {name: 0 for name in hist_cuda.SOURCES}
    want[kernel] = 6 * rounds
    hist_cuda.reset_launches()
    evals_result: dict = {}
    t0 = time.perf_counter()
    bst = xtt.train(dict(params, eval_metric=["logloss", "auc"]), dtrain,
                    rounds, evals=[(dtrain, "train")],
                    evals_result=evals_result, verbose_eval=False)
    torch.cuda.synchronize()
    with_eval_s = time.perf_counter() - t0
    launches = dict(hist_cuda.launches)
    if launches != want:
        raise AssertionError(f"phase {label}: launches {launches} in "
                             f"{rounds} rounds, want {want}")
    times = []
    for _ in range(repeats):
        hist_cuda.reset_launches()
        t0 = time.perf_counter()
        run = xtt.train(params, dtrain, rounds, verbose_eval=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if hist_cuda.launches != want:
            raise AssertionError(f"phase {label}: timed run launched "
                                 f"{hist_cuda.launches}, want {want}")
        if len(times) == 1:
            timed = run  # the first timed booster, for the bytes check
    logloss = evals_result["train"]["logloss"][-1]
    auc = evals_result["train"]["auc"][-1]
    train_s = statistics.median(times)
    if not auc > 0.9:
        raise AssertionError(f"phase {label}: AUC {auc} <= 0.9")
    return dict(bst=bst, timed=timed, launches=launches[kernel],
                logloss=logloss, auc=auc, train_s=train_s,
                rate=n_rows * rounds / train_s / 1e6,
                times=" ".join(f"{t:.3f}" for t in times),
                with_eval_s=with_eval_s)


def phase_train(xtt, hist_cuda, X, y, rounds: int):
    t0 = time.perf_counter()
    dtrain = xtt.DMatrix(X, label=y)
    dtrain.ensure_ellpack(max_bin=256)  # the device sketch, then the bins
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    r = _train_main_path(xtt, hist_cuda, BASE, dtrain, X.shape[0], rounds,
                         "hist_f32", "3")
    r["same_bytes"] = _model_bytes(r["bst"]) == _model_bytes(r["timed"])
    log(f"phase 3 train: {X.shape[0]} x {X.shape[1]}, {rounds} rounds; "
        f"ingest (device sketch + bins) {ingest_s:.3f} s; train loop "
        f"median {r['train_s']:.3f} s = {r['rate']:.3f} M row-rounds/s "
        f"(runs {r['times']} s); with eval "
        f"{r['with_eval_s']:.3f} s; logloss {r['logloss']:.6f} auc "
        f"{r['auc']:.6f}; K1 launches {r['launches']}; two f32 runs gave "
        f"byte-identical models: {r['same_bytes']}")
    return r, dtrain


def phase_train_det(xtt, hist_cuda, dtrain, n_rows, rounds, f32):
    """deterministic_histogram=1: every level histogram by K2, and two
    runs must write byte-identical models."""
    r = _train_main_path(xtt, hist_cuda, DET, dtrain, n_rows, rounds,
                         "hist_q", "3c")
    if _model_bytes(r["bst"]) != _model_bytes(r["timed"]):
        raise AssertionError("phase 3c: two deterministic runs wrote "
                             "different models")
    log(f"phase 3c deterministic train: {rounds} rounds; train loop "
        f"median {r['train_s']:.3f} s = {r['rate']:.3f} M row-rounds/s (runs "
        f"{r['times']} s; f32 path, phase 3: {f32['rate']:.3f}); with eval "
        f"{r['with_eval_s']:.3f} s; "
        f"logloss {r['logloss']:.6f} auc {r['auc']:.6f}; K2 launches "
        f"{r['launches']}, K1 0; two runs byte-identical: True")
    return r


def phase_profile(xtt, dtrain, params, label, rounds: int = 2, top: int = 8):
    """Where a training round's time goes: device time by kernel name over
    ``rounds`` rounds (torch.profiler), and the card's idle share of the
    profiled wall time."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    xtt.train(params, dtrain, 1, verbose_eval=False)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        xtt.train(params, dtrain, rounds, verbose_eval=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for r in prof.key_averages():
        if r.device_type != DeviceType.CUDA:
            continue
        us = getattr(r, "self_device_time_total", None)
        if us is None:
            us = r.self_cuda_time_total
        rows.append((us / 1e3, r.count, r.key))
    busy_ms = sum(ms for ms, _, _ in rows)
    rows.sort(reverse=True)
    if not rows:
        log(f"phase {label} profile: the profiler saw no device time (not "
            "measured)")
        return
    log(f"phase {label} profile: {rounds} rounds, wall {wall_ms:.3f} ms under "
        f"the profiler, device busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.4f}")
    for ms, n, name in rows[:top]:
        log(f"  {ms:9.3f} ms {100 * ms / busy_ms:6.2f}% x{n:<5d} {name[:90]}")


def phase_predict(xtt, bst, X):
    dtest = xtt.DMatrix(X[:100_000])
    pred = bst.predict(dtest)
    if pred.shape != (100_000,) or not np.all(np.isfinite(pred)):
        raise AssertionError(f"bad predictions: shape {pred.shape}")
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        for ext in ("json", "ubj"):
            path = os.path.join(tmp, f"model.{ext}")
            bst.save_model(path)
            again = xtt.Booster(model_file=path).predict(dtest)
            if not np.array_equal(pred, again):
                raise AssertionError(
                    f"{ext} round trip changed predictions by "
                    f"{np.abs(pred - again).max()}")
    log("phase 4 predict: 100000 rows finite; JSON and UBJ reloads predict "
        "identically")


def _card_vs_cpu(xtt, params, X, y, rounds, atol, label):
    """Train the same small input on the card and on the CPU (whose
    histograms are the plain versions the tests hold against the JAX
    reference): the cuts (device sketch on the card, host grid on the CPU)
    must agree bitwise at this size, the trees must be the same and the
    predictions within ``atol``."""
    d_card = xtt.DMatrix(X, label=y)
    d_cpu = xtt.DMatrix(X, label=y, device="cpu")
    cuts = [d.ensure_ellpack(params["max_bin"]).cuts.cut_values
            for d in (d_card, d_cpu)]
    if not np.array_equal(cuts[0].view(np.uint32), cuts[1].view(np.uint32)):
        raise AssertionError(f"phase {label}: the device sketch and the host "
                             "grid gave different cuts")
    got = xtt.train(params, d_card, rounds, verbose_eval=False)
    ref = xtt.train(params, d_cpu, rounds, verbose_eval=False, device="cpu")
    for a, b in zip(got.trees, ref.trees):
        if not (np.array_equal(a.split_indices, b.split_indices)
                and np.array_equal(a.left_children, b.left_children)):
            raise AssertionError(f"phase {label}: card and CPU grew "
                                 "different trees")
    diff = np.abs(got.predict(xtt.DMatrix(X)) -
                  ref.predict(xtt.DMatrix(X, device="cpu"))).max()
    if diff > atol:
        raise AssertionError(f"phase {label}: card and CPU predictions "
                             f"differ by {diff}")
    leaves = max(int((t.left_children == -1).sum()) for t in got.trees)
    log(f"phase {label} parity: card vs CPU on {X.shape[0]} rows, same "
        f"trees (at most {leaves} leaves), max |pred diff| {diff:.3g}; "
        f"model JSON byte-identical: {_model_bytes(got) == _model_bytes(ref)}")


SMALL = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 64,
         "eta": 0.3}
# monotone on feature 0, two interaction sets, every column sampler and a
# leaf budget that binds at depth 6 (64 leaves otherwise)
CONSTRAINED = {"monotone_constraints": "(" + ",".join(["1"] + ["0"] * 27)
               + ")",
               "interaction_constraints": [[0, 1, 2], [3, 4]],
               "colsample_bytree": 0.8, "colsample_bylevel": 0.8,
               "colsample_bynode": 0.8, "max_leaves": 24, "max_depth": 6}


def phase_parity(xtt):
    X, y = make_data(20_000, 28, seed=3)
    _card_vs_cpu(xtt, SMALL, X, y, 5, 1e-4, "5")


def phase_parity_det(xtt, dtrain, X):
    """Phase 5 under deterministic_histogram=1, then with the constraints;
    the constrained model at full width must not decrease along feature 0."""
    Xs, ys = make_data(20_000, 28, seed=3)
    det = dict(SMALL, deterministic_histogram=1)
    _card_vs_cpu(xtt, det, Xs, ys, 5, 1e-5, "5b")
    _card_vs_cpu(xtt, dict(det, **CONSTRAINED), Xs, ys, 5, 1e-5,
                 "5b constrained")
    bst = xtt.train(dict(DET, **CONSTRAINED), dtrain, 10, verbose_eval=False)
    grid = np.linspace(-3, 3, 20, dtype=np.float32)
    rows = np.repeat(X[:2000], len(grid), axis=0)
    rows[:, 0] = np.tile(grid, 2000)
    margin = bst.predict(xtt.DMatrix(rows), output_margin=True)
    steps = np.diff(margin.reshape(2000, len(grid)), axis=1)
    if (steps < 0).any():
        raise AssertionError(f"phase 5b: the monotone model decreases along "
                             f"feature 0 by up to {-steps.min()}")
    log(f"phase 5b monotone: {X.shape[0]} x {X.shape[1]} constrained model, "
        f"10 rounds; margins of 2000 rows over 20 values of feature 0 never "
        f"decrease (largest step {steps.max():.4g})")


def _kernel_entry(name, source, cases, launches):
    # the line sums the three int16 shapes of the main path (a root build
    # and two 16-node left-child builds)
    main = [c for c in cases if c["dtype"] == "int16"
            and (c["node0"], c["n_nodes"], c["stride"]) in SHAPES]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": sum(c["kernel_ms"] for c in main),
        "plain_ms": sum(c["plain_ms"] for c in main),
        "bound_ms": sum(c["bound_ms"] for c in main),
        "bound_by": main[0]["bound_by"],
        "library_ms": sum(c["library_ms"] for c in main),
    }


REPLACES = {"hist_f32": "xgboost_tpu/ops/hist_pallas.py:77",
            "hist_q": "xgboost_tpu/ops/hist_pallas.py:173"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch.ops import hist_cuda

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {label} took {time.perf_counter() - t0:.3f} s")
        return out

    smi = timed("1", phase_device, hist_cuda)
    f32_cases = timed("2", phase_kernels, hist_cuda, "hist_f32", "2")
    q_cases = timed("2b", phase_kernels, hist_cuda, "hist_q", "2b")
    X, y = make_data(1_000_000, 28)
    f32, dtrain = timed("3", phase_train, xtt, hist_cuda, X, y, 10)
    timed("3b", phase_profile, xtt, dtrain, BASE, "3b")
    det = timed("3c", phase_train_det, xtt, hist_cuda, dtrain, X.shape[0],
                10, f32)
    timed("3d", phase_profile, xtt, dtrain, DET, "3d (deterministic)")
    timed("4", phase_predict, xtt, f32["bst"], X)
    timed("5", phase_parity, xtt)
    timed("5b", phase_parity_det, xtt, dtrain, X)

    kernels = [_kernel_entry(name, hist_cuda.SOURCES[name], cases, n)
               for name, cases, n in (("hist_f32", f32_cases, f32["launches"]),
                                      ("hist_q", q_cases, det["launches"]))]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
