"""Smoke run of xgboost_tpu_torch on one NVIDIA GPU.

Drives the port's main path through its public entry points and holds its
CUDA kernel against the plain PyTorch version:

  1. device: card name and power limit; build and load the kernel library
  2. kernel vs plain: the histogram kernel (K1, csrc/hist.cu) against
     build_histogram_plain at R=1,048,576 x F=28, B=256, int16 and uint8
     bins, with timings of the kernel, the plain version, one index_add_
     call (a yardstick the port never calls) and the memory bound
  3. train: 1,000,000 x 28 HIGGS-shaped rows, binary:logistic, max_bin=256,
     max_depth=6, eta=0.3, 10 rounds, evaluated on the training set; the
     kernel's launch count must be 6 per round
  3b. profile: device time by kernel over two training rounds and the
     card's idle share
  4. predict 100k rows, save JSON and UBJ, reload, predict identically
  5. small-input parity: the same small training on the card and on the CPU
     (whose histogram is the plain version the tests hold against the JAX
     reference) must grow the same trees

Run from the repository root: ``python3 chip_smoke.py``.  Exits non-zero if
any phase fails or no CUDA device is present.  The last two lines are the
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
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
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
    hist_cuda.load_library()
    build_s = time.perf_counter() - t0
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; kernel build+load "
        f"{build_s:.3f} s")
    return smi


def phase_kernel(hist_cuda):
    """K1 against its plain version at the bench shapes."""
    R, F, B = 1 << 20, 28, 256
    rng = np.random.default_rng(1)
    cases = []
    for dtype, n_bin in ((torch.int16, 256), (torch.uint8, 254)):
        b = rng.integers(0, n_bin, size=(R, F), dtype=np.int64)
        b[rng.random((R, F)) < 0.05] = n_bin  # ~5% missing -> sentinel
        bins = torch.from_numpy(b).to(dtype).cuda()
        gpair = torch.from_numpy(np.stack(
            [rng.normal(size=R), rng.random(R)], 1).astype(np.float32)).cuda()
        for node0, n_nodes, stride in ((0, 1, 1), (15, 16, 2), (31, 16, 2)):
            p = rng.integers(node0, node0 + stride * n_nodes, size=R)
            p[rng.random(R) < 0.02] = -1  # pad rows
            pos = torch.from_numpy(p.astype(np.int32)).cuda()
            kw = dict(node0=node0, n_nodes=n_nodes, n_bin=n_bin, stride=stride)
            got = hist_cuda.build_histogram_cuda(bins, gpair, pos, **kw)
            torch.cuda.synchronize()
            want = hist_cuda.build_histogram_plain(bins, gpair, pos, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            ok = err <= HIST_RTOL * scale

            # yardstick: one index_add_ over precomputed flat indices
            local = pos.long() - node0
            inl = (local >= 0) & (local % stride == 0) \
                & (local // stride < n_nodes)
            take = inl[:, None] & (bins.long() < n_bin)
            idx = ((local // stride)[:, None] * F
                   + torch.arange(F, device="cuda")[None, :]) * n_bin \
                + bins.long()
            flat_idx = idx[take]
            flat_val = gpair[:, None, :].expand(R, F, 2)[take]
            flat = torch.zeros(n_nodes * F * n_bin, 2, device="cuda")

            kernel_ms = cuda_ms(lambda: hist_cuda.build_histogram_cuda(
                bins, gpair, pos, **kw))
            plain_ms = cuda_ms(lambda: hist_cuda.build_histogram_plain(
                bins, gpair, pos, **kw), reps=5)
            library_ms = cuda_ms(lambda: flat.index_add_(0, flat_idx, flat_val))

            # least work these inputs need: pos of every row, bins and gpair
            # of the rows in the level, the histogram written once
            n_in = int(inl.sum().item())
            n_bytes = (4 * R + n_in * (F * bins.element_size() + 8)
                       + n_nodes * F * n_bin * 2 * 4)
            n_ops = 2 * int(take.sum().item())
            t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS
            bound_ms = max(t_bytes, t_ops) * 1e3
            case = dict(dtype=str(dtype).split(".")[-1], node0=node0,
                        n_nodes=n_nodes, stride=stride, max_abs_err=err,
                        max_rel_err=err / scale, ok=ok, kernel_ms=kernel_ms,
                        plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bound_ms,
                        bound_by="bytes" if t_bytes >= t_ops else "operations")
            cases.append(case)
            log("phase 2 kernel vs plain: " + json.dumps(case))
            del flat_idx, flat_val, idx, take
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version beyond "
                             f"{HIST_RTOL} x max|hist|: {bad}")
    return cases


def phase_train(xtt, hist_cuda, X, y, rounds: int):
    params = {"objective": "binary:logistic", "max_depth": 6, "max_bin": 256,
              "eta": 0.3, "tree_method": "hist",
              "eval_metric": ["logloss", "auc"]}
    t0 = time.perf_counter()
    dtrain = xtt.DMatrix(X, label=y)
    dtrain.ensure_ellpack(max_bin=256)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0

    # the main path: counts from zero just before, read just after
    hist_cuda.launches = 0
    evals_result: dict = {}
    t0 = time.perf_counter()
    bst = xtt.train(params, dtrain, rounds, evals=[(dtrain, "train")],
                    evals_result=evals_result, verbose_eval=False)
    torch.cuda.synchronize()
    with_eval_s = time.perf_counter() - t0
    launches = hist_cuda.launches
    if launches != 6 * rounds:
        raise AssertionError(f"K1 launched {launches} times in {rounds} "
                             f"rounds, want {6 * rounds}")
    logloss = evals_result["train"]["logloss"][-1]
    auc = evals_result["train"]["auc"][-1]

    # train loop only (as bench.py times it): no evals, bins already built
    hist_cuda.launches = 0
    t0 = time.perf_counter()
    xtt.train(params, dtrain, rounds, verbose_eval=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if hist_cuda.launches != 6 * rounds:
        raise AssertionError("timed run launched K1 "
                             f"{hist_cuda.launches} times")
    rate = X.shape[0] * rounds / train_s / 1e6
    log(f"phase 3 train: {X.shape[0]} x {X.shape[1]}, {rounds} rounds; "
        f"ingest {ingest_s:.3f} s; train loop {train_s:.3f} s = "
        f"{rate:.3f} M row-rounds/s; with eval {with_eval_s:.3f} s; "
        f"logloss {logloss:.6f} auc {auc:.6f}; K1 launches {launches}")
    if not auc > 0.9:
        raise AssertionError(f"AUC {auc} <= 0.9")
    return bst, launches, dtrain


def phase_profile(xtt, dtrain, rounds: int = 2, top: int = 8):
    """Where a training round's time goes: device time by kernel name over
    ``rounds`` rounds (torch.profiler), and the card's idle share of the
    profiled wall time."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    params = {"objective": "binary:logistic", "max_depth": 6, "max_bin": 256,
              "eta": 0.3}
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
        log("phase 3b profile: the profiler saw no device time (not measured)")
        return
    log(f"phase 3b profile: {rounds} rounds, wall {wall_ms:.3f} ms under the "
        f"profiler, device busy {busy_ms:.3f} ms, idle share "
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


def phase_parity(xtt):
    """The card's trees equal the CPU path's on a small input."""
    X, y = make_data(20_000, 28, seed=3)
    params = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 64,
              "eta": 0.3}
    got = xtt.train(params, xtt.DMatrix(X, label=y), 5, verbose_eval=False)
    ref = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), 5,
                    verbose_eval=False, device="cpu")
    for a, b in zip(got.trees, ref.trees):
        if not (np.array_equal(a.split_indices, b.split_indices)
                and np.array_equal(a.left_children, b.left_children)):
            raise AssertionError("card and CPU grew different trees")
    diff = np.abs(got.predict(xtt.DMatrix(X)) -
                  ref.predict(xtt.DMatrix(X, device="cpu"))).max()
    if diff > 1e-4:
        raise AssertionError(f"card and CPU predictions differ by {diff}")
    log(f"phase 5 parity: card vs CPU on 20000 rows, same trees, "
        f"max |pred diff| {diff:.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import xgboost_tpu_torch as xtt
    from xgboost_tpu_torch.ops import hist_cuda

    smi = phase_device(hist_cuda)
    cases = phase_kernel(hist_cuda)
    X, y = make_data(1_000_000, 28)
    bst, launches, dtrain = phase_train(xtt, hist_cuda, X, y, rounds=10)
    phase_profile(xtt, dtrain)
    phase_predict(xtt, bst, X)
    phase_parity(xtt)

    # the kernels line sums the three int16 shapes (a root build and two
    # 16-node left-child builds)
    i16 = [c for c in cases if c["dtype"] == "int16"]
    kernels = [{
        "name": "hist_f32",
        "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/hist.cu",
        "replaces": "xgboost_tpu/ops/hist_pallas.py:77",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": sum(c["kernel_ms"] for c in i16),
        "plain_ms": sum(c["plain_ms"] for c in i16),
        "bound_ms": sum(c["bound_ms"] for c in i16),
        "bound_by": i16[0]["bound_by"],
        "library_ms": sum(c["library_ms"] for c in i16),
    }]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
