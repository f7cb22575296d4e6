"""Per-level gradient histograms on the card: the hand-written CUDA kernels
and their build, binding and dispatch.

- K1 ``hist_f32`` (csrc/hist.cu, port of xgboost_tpu/ops/hist_pallas.py:
  _hist_kernel): f32 (g, h) sums, the default path.
- K2 ``hist_q`` (csrc/hist_q.cu, port of _hist_kernel_q): exact int32 sums
  of the int8 gradient limbs, the ``deterministic_histogram=1`` path.

Each source is compiled with nvcc for sm_90a into its own shared library
with a plain C interface at first use, into ``xgboost_tpu_torch/_build/``
(keyed by the source's hash, so an edited source rebuilds; ``build_all``
starts one nvcc per source, all at once), and bound with ctypes.  A failed
build or load raises; there is no fallback to the plain version.

``build_histogram`` and ``build_histogram_q`` are the dispatchers the grower
calls: a CPU tensor goes to the plain PyTorch version, a CUDA tensor to the
kernel.  ``launches`` counts, per kernel, the launches since the last reset.
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
from .quantise import hist_accumulate_q

__all__ = ["build_histogram", "build_histogram_cuda", "build_histogram_plain",
           "build_histogram_q", "build_histogram_q_cuda",
           "build_histogram_q_plain", "build_all", "choose_block",
           "load_library", "launches", "reset_launches", "SOURCES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG, "_build")
# kernel name -> its source, relative to the repository root
SOURCES = {"hist_f32": "xgboost_tpu_torch/csrc/hist.cu",
           "hist_q": "xgboost_tpu_torch/csrc/hist_q.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# kernel launches per kernel since the last reset_launches()
launches = {name: 0 for name in SOURCES}

_BIN_CODES = {torch.uint8: 0, torch.int16: 1, torch.int32: 2}
# shared memory one block may use for its histogram; 227 KB is the H100's
# per-block opt-in limit, the rest is left for the runtime's own reservation
SMEM_BUDGET = 220 * 1024
THREADS = 512
_vp, _ci = ctypes.c_void_p, ctypes.c_int
# C signature of each kernel's entry point (name, argtypes)
_ENTRY = {
    "hist_f32": ("xtb_hist_f32", [_vp, _ci, _vp, _vp, _vp] + [_ci] * 10 + [_vp]),
    "hist_q": ("xtb_hist_q", [_vp, _ci, _vp, _vp, _vp] + [_ci] * 11 + [_vp]),
}
_libs: dict = {}
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA histogram kernels cannot be "
                       "built (put the CUDA toolkit's bin/ on PATH)")


def _src_path(name: str) -> str:
    return os.path.join(os.path.dirname(_PKG), SOURCES[name])


def _lib_path(name: str) -> str:
    with open(_src_path(name), "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libxtb_{name}_{digest}.so")


def _build(names) -> None:
    """Compile the libraries of ``names`` that are missing, one nvcc each,
    all started together."""
    todo = [(n, _lib_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not os.path.exists(p)]
    if not todo:
        return
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for name, lib_path in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, _src_path(name)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((name, lib_path, tmp, proc))
        errors = []
        for name, lib_path, tmp, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed to build {_src_path(name)}:\n{err}")
            else:  # atomic: a concurrent loader sees all or none
                os.replace(tmp, lib_path)
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def build_all() -> None:
    """Build every kernel library whose source changed, in parallel."""
    with _lib_lock:
        _build(list(SOURCES))


def load_library(name: str):
    """Build (if its source changed) and load kernel ``name``'s library."""
    with _lib_lock:
        if name in _libs:
            return _libs[name]
        _build([name])
        lib = ctypes.CDLL(_lib_path(name))
        entry, argtypes = _ENTRY[name]
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = _ci
        lib.xtb_cuda_error_string.argtypes = [_ci]
        lib.xtb_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def choose_block(n_features: int, n_nodes: int, n_bin: int, words: int,
                 smem_budget: int = SMEM_BUDGET):
    """(features, nodes) per block such that the block's (FG, NT, B, words)
    4-byte histogram fits ``smem_budget`` (the role of choose_tiles(out_ch=)
    in ops/hist_pallas.py; words = 2 for K1, 6 for K2): all nodes and as
    many features as fit, balanced over the groups; once one feature's
    nodes do not fit, one feature and as many nodes as fit, balanced over
    the node tiles.  Raises only if one (node, feature) pair does not fit."""
    cell = n_bin * words * 4
    if cell > smem_budget:
        raise ValueError(
            f"one node's histogram of one feature ({n_bin} bins x {words} "
            f"words) needs {cell} B of shared memory, over {smem_budget} B")
    if n_nodes * cell <= smem_budget:
        max_fg = smem_budget // (n_nodes * cell)
        n_groups = -(-n_features // max_fg)
        return -(-n_features // n_groups), n_nodes
    n_tiles = -(-n_nodes // (smem_budget // cell))
    return 1, -(-n_nodes // n_tiles)


def _row_blocks(n_rows: int, n_blocks: int, n_sm: int) -> int:
    # about two blocks in flight per SM over the whole grid, and no block
    # with fewer rows than its threads
    want = max(1, (2 * n_sm) // n_blocks)
    return max(1, min(want, n_rows // THREADS))


def _check(bins, vals, pos, vals_dtype, vals_tail, n_nodes, n_bin, stride):
    """The checks both kernels share; raises on what they cannot take."""
    if not (bins.is_cuda and vals.is_cuda and pos.is_cuda):
        raise ValueError("the histogram kernels need CUDA tensors")
    if not (bins.device == vals.device == pos.device):
        raise ValueError("bins, gradients and pos must be on one device")
    if bins.dtype not in _BIN_CODES:
        raise TypeError(f"bins must be uint8, int16 or int32, got {bins.dtype}")
    if vals.dtype != vals_dtype or pos.dtype != torch.int32:
        raise TypeError(f"gradients must be {vals_dtype} and pos int32")
    R = bins.shape[0]
    if bins.dim() != 2 or tuple(vals.shape) != (R, *vals_tail) \
            or pos.shape != (R,):
        raise ValueError(f"shapes bins {tuple(bins.shape)}, gradients "
                         f"{tuple(vals.shape)}, pos {tuple(pos.shape)} do "
                         "not agree: want (R, F), (R, "
                         f"{', '.join(map(str, vals_tail))}), (R,)")
    if not (bins.is_contiguous() and vals.is_contiguous()
            and pos.is_contiguous()):
        raise ValueError("bins, gradients and pos must be contiguous")
    if n_nodes < 1 or stride < 1 or n_bin < 1:
        raise ValueError("n_nodes, stride and n_bin must be positive")


def _grid(bins, n_nodes: int, n_bin: int, words: int):
    """(features per block, nodes per block, row blocks) of one launch."""
    R, F = bins.shape
    fg, nt = choose_block(F, n_nodes, n_bin, words)
    n_sm = torch.cuda.get_device_properties(bins.device).multi_processor_count
    return fg, nt, _row_blocks(R, -(-F // fg) * -(-n_nodes // nt), n_sm)


def _launched(name: str, lib, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.xtb_cuda_error_string(rc).decode())
    launches[name] += 1


def build_histogram_cuda(bins, gpair, pos, *, node0: int, n_nodes: int,
                         n_bin: int, stride: int = 1):
    """Launch K1: hist (n_nodes, F, n_bin, 2) f32 on the inputs' card."""
    _check(bins, gpair, pos, torch.float32, (2,), n_nodes, n_bin, stride)
    R, F = bins.shape
    out = torch.zeros((n_nodes, F, n_bin, 2), dtype=torch.float32,
                      device=bins.device)
    if R == 0 or F == 0:
        return out
    lib = load_library("hist_f32")
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    with torch.cuda.device(bins.device):
        rc = lib.xtb_hist_f32(
            bins.data_ptr(), _BIN_CODES[bins.dtype], gpair.data_ptr(),
            pos.data_ptr(), out.data_ptr(), R, F, n_bin, node0, n_nodes,
            stride, *_grid(bins, n_nodes, n_bin, 2), THREADS, stream)
    _launched("hist_f32", lib, rc)
    return out


def build_histogram_q_cuda(bins, gq, pos, *, node0: int, n_nodes: int,
                           n_bin: int, stride: int = 1):
    """Launch K2: exact limb hist (n_nodes, F, n_bin, C, 3) int32 from gq
    (R, C, 3) int8 on the inputs' card."""
    if gq.dim() != 3 or gq.shape[-1] != 3:
        raise ValueError(f"gq must be (R, C, 3) int8 limbs, got "
                         f"{tuple(gq.shape)}")
    C = gq.shape[1]
    _check(bins, gq, pos, torch.int8, (C, 3), n_nodes, n_bin, stride)
    R, F = bins.shape
    out = torch.zeros((n_nodes, F, n_bin, C, 3), dtype=torch.int32,
                      device=bins.device)
    if R == 0 or F == 0:
        return out
    lib = load_library("hist_q")
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    with torch.cuda.device(bins.device):
        rc = lib.xtb_hist_q(
            bins.data_ptr(), _BIN_CODES[bins.dtype], gq.data_ptr(),
            pos.data_ptr(), out.data_ptr(), R, F, n_bin, 3 * C, node0,
            n_nodes, stride, *_grid(bins, n_nodes, n_bin, 3 * C), THREADS,
            stream)
    _launched("hist_q", lib, rc)
    return out


def build_histogram_q_plain(bins, gq, pos, *, node0: int, n_nodes: int,
                            n_bin: int, stride: int = 1):
    """K2's plain PyTorch version (quantise.hist_accumulate_q)."""
    return hist_accumulate_q(bins, gq, pos, node0, n_nodes, n_bin,
                             stride=stride)


def build_histogram(bins, gpair, pos, *, node0: int, n_nodes: int,
                    n_bin: int, stride: int = 1):
    """The grower's f32 histogram: the plain version for a CPU tensor, K1
    for a CUDA tensor (which raises if it cannot run)."""
    fn = build_histogram_cuda if bins.is_cuda else build_histogram_plain
    return fn(bins, gpair, pos, node0=node0, n_nodes=n_nodes, n_bin=n_bin,
              stride=stride)


def build_histogram_q(bins, gq, pos, *, node0: int, n_nodes: int,
                      n_bin: int, stride: int = 1):
    """The grower's exact limb histogram: the plain version for a CPU
    tensor, K2 for a CUDA tensor (which raises if it cannot run)."""
    fn = build_histogram_q_cuda if bins.is_cuda else build_histogram_q_plain
    return fn(bins, gq, pos, node0=node0, n_nodes=n_nodes, n_bin=n_bin,
              stride=stride)
