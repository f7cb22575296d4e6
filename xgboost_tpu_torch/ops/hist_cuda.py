"""Per-level gradient histogram on the card: the hand-written CUDA kernel K1
(csrc/hist.cu, port of xgboost_tpu/ops/hist_pallas.py:_hist_kernel) and its
build, binding and dispatch.

The kernel is compiled with nvcc for sm_90a into a shared library with a
plain C interface at first use, into ``xgboost_tpu_torch/_build/`` (keyed by
the source's hash, so an edited source rebuilds), and bound with ctypes.  A
failed build or load raises; there is no fallback to the plain version.

``build_histogram`` is the dispatcher the grower calls: a CPU tensor goes to
the plain PyTorch version (``build_histogram_plain``, ops/histogram.py), a
CUDA tensor to the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from .histogram import build_histogram as build_histogram_plain

__all__ = ["build_histogram", "build_histogram_cuda", "build_histogram_plain",
           "choose_feature_group", "load_library", "launches"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "hist.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# kernel launches made by build_histogram_cuda since the last reset
launches = 0

_BIN_CODES = {torch.uint8: 0, torch.int16: 1, torch.int32: 2}
# shared memory one block may use for its histogram; 227 KB is the H100's
# per-block opt-in limit, the rest is left for the runtime's own reservation
SMEM_BUDGET = 220 * 1024
THREADS = 512
_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA histogram kernel cannot be "
                       "built (put the CUDA toolkit's bin/ on PATH)")


def _build(lib_path: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {_SRC}:\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library():
    """Build (if the source changed) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:16]
        lib_path = os.path.join(_BUILD_DIR, f"libxtb_hist_{digest}.so")
        if not os.path.exists(lib_path):
            _build(lib_path)
        lib = ctypes.CDLL(lib_path)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.xtb_hist_f32.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci, ci, ci,
                                     ci, ci, ci, ci, vp]
        lib.xtb_hist_f32.restype = ci
        lib.xtb_cuda_error_string.argtypes = [ci]
        lib.xtb_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def choose_feature_group(n_features: int, n_nodes: int, n_bin: int,
                         smem_budget: int = SMEM_BUDGET) -> int:
    """Features per block such that the block's (FG, N, B, 2) f32 histogram
    fits ``smem_budget``, balanced over the groups (the role of
    choose_tiles in ops/hist_pallas.py).  Raises if one feature alone does not fit."""
    per_feature = n_nodes * n_bin * 2 * 4
    if per_feature > smem_budget:
        raise ValueError(
            f"one feature's histogram for {n_nodes} nodes x {n_bin} bins "
            f"needs {per_feature} B of shared memory, over {smem_budget} B")
    max_fg = smem_budget // per_feature
    n_groups = -(-n_features // max_fg)
    return -(-n_features // n_groups)


def _row_blocks(n_rows: int, n_groups: int, n_sm: int) -> int:
    # about two blocks in flight per SM over the whole grid, and no block
    # with fewer rows than its threads
    want = max(1, (2 * n_sm) // n_groups)
    return max(1, min(want, n_rows // THREADS))


def build_histogram_cuda(bins, gpair, pos, *, node0: int, n_nodes: int,
                         n_bin: int, stride: int = 1):
    """Launch K1: hist (n_nodes, F, n_bin, 2) f32 on the inputs' card."""
    global launches
    if not (bins.is_cuda and gpair.is_cuda and pos.is_cuda):
        raise ValueError("build_histogram_cuda needs CUDA tensors")
    if not (bins.device == gpair.device == pos.device):
        raise ValueError("bins, gpair and pos must be on one device")
    if bins.dtype not in _BIN_CODES:
        raise TypeError(f"bins must be uint8, int16 or int32, got {bins.dtype}")
    if gpair.dtype != torch.float32 or pos.dtype != torch.int32:
        raise TypeError("gpair must be float32 and pos int32")
    if bins.dim() != 2 or gpair.shape != (bins.shape[0], 2) \
            or pos.shape != (bins.shape[0],):
        raise ValueError(f"shapes bins {tuple(bins.shape)}, gpair "
                         f"{tuple(gpair.shape)}, pos {tuple(pos.shape)} do "
                         "not agree: want (R, F), (R, 2), (R,)")
    if not (bins.is_contiguous() and gpair.is_contiguous()
            and pos.is_contiguous()):
        raise ValueError("bins, gpair and pos must be contiguous")
    if n_nodes < 1 or stride < 1 or n_bin < 1:
        raise ValueError("n_nodes, stride and n_bin must be positive")
    R, F = bins.shape
    out = torch.zeros((n_nodes, F, n_bin, 2), dtype=torch.float32,
                      device=bins.device)
    if R == 0 or F == 0:
        return out
    lib = load_library()
    fg = choose_feature_group(F, n_nodes, n_bin)
    n_sm = torch.cuda.get_device_properties(bins.device).multi_processor_count
    row_blocks = _row_blocks(R, -(-F // fg), n_sm)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    with torch.cuda.device(bins.device):
        rc = lib.xtb_hist_f32(bins.data_ptr(), _BIN_CODES[bins.dtype],
                              gpair.data_ptr(), pos.data_ptr(), out.data_ptr(),
                              R, F, n_bin, node0, n_nodes, stride, fg,
                              row_blocks, THREADS, stream)
    if rc != 0:
        raise RuntimeError("histogram kernel launch failed: "
                           + lib.xtb_cuda_error_string(rc).decode())
    launches += 1
    return out


def build_histogram(bins, gpair, pos, *, node0: int, n_nodes: int,
                    n_bin: int, stride: int = 1):
    """The grower's histogram: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor (which raises if it cannot run)."""
    fn = build_histogram_cuda if bins.is_cuda else build_histogram_plain
    return fn(bins, gpair, pos, node0=node0, n_nodes=n_nodes, n_bin=n_bin,
              stride=stride)
