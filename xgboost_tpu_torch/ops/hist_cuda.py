"""The hand-written CUDA kernels' build, binding and launch counts, and the
per-level gradient histograms on the card.

- K1 ``hist_f32`` (csrc/hist.cu, port of xgboost_tpu/ops/hist_pallas.py:
  _hist_kernel): f32 (g, h) sums, the default path.  Launched in thread
  block clusters along its row blocks, as ``plan_f32`` plans from the
  card's occupancy.
- K1's class axis ``hist_f32_multi`` (csrc/hist_multi.cu): K histograms in
  one call, each row read once for the classes of a block and added by
  the one lane that owns its cell, no shared-memory atomics: the lockstep
  grower's K class trees, each with its own pos
  (``build_histogram_multi``), and a vector-leaf tree's K targets under
  one pos (``build_level_hist_multi``); ``plan_f32_multi`` plans it.  A
  call is two CUDA launches (histogram, rounding of its f64 sums), and
  five where it buckets the level's rows by node first (count, scan,
  scatter before them), counted as one.  ``class_axis_lanes``,
  ``bucket_level``, ``class_axis_items``, ``class_axis_item_rows`` and
  ``class_axis_model`` are its index logic in PyTorch, which the CPU
  tests hold against the plain versions.
- K2 ``hist_q`` (csrc/hist_q.cu, port of _hist_kernel_q): exact int32 sums
  of the int8 gradient limbs, the ``deterministic_histogram=1`` path.
  Launched the same way, as ``plan_q`` plans.
- K3 ``split_scan`` (csrc/split_scan.cu; no Pallas kernel, it replaces the
  reference's native and XLA split scans): the best split per node in the
  reference's summation order; its wrapper is ops/split_cuda.py.
- K4 ``sigmoid`` (csrc/sigmoid.cu; no Pallas kernel, it replaces XLA's
  jax.nn.sigmoid and the binary:logistic gradient around it): the
  logistic transform and the gradient pairs in XLA's f32 arithmetic, two
  entries counted as one kernel; its wrapper is ops/sigmoid_cuda.py.
- K5 ``lambdarank`` (csrc/lambdarank.cu; no Pallas kernel, it replaces the
  reference's native top-k LambdaMART kernel): the ranking objectives'
  gradient pairs with glibc's expf/exp2f/log2f and the native sum orders,
  one launch a round, bundles of query groups sorted and held in shared
  memory; its wrapper is ops/lambdarank_cuda.py.
- K6 ``treeshap`` (csrc/treeshap.cu; no Pallas kernel, it replaces the
  reference's XLA programs interpret/device.py ``_bucket_phi`` and
  ``_bucket_interactions``): exact TreeSHAP values and interaction terms
  of an ensemble's path tables, every bucket in one cooperative launch
  (each path's terms tabulated once a mask of its one fractions, then
  read by each row); two entries, counted as ``treeshap`` and
  ``treeshap_interactions``; its wrapper is ops/treeshap_cuda.py.
K3-K6 are built with ``--fmad=false`` so that nvcc fuses no multiply-add
the reference does not.

Each source is compiled with nvcc for sm_90a into its own shared library
with a plain C interface at first use, into ``xgboost_tpu_torch/_build/``
(keyed by the hash of the source and its flags, so an edit rebuilds;
``build_all`` starts one nvcc per source, all at once), and bound with
ctypes.  A failed build or load raises; there is no fallback to the plain
version.

``build_histogram``, ``build_histogram_q``, ``build_histogram_multi`` and
``build_level_hist_multi`` are the dispatchers the growers call: a CPU
tensor goes to the plain PyTorch version, a CUDA tensor to the kernel.
``launches`` counts, per kernel, the launches since the last reset;
every wrapper counts through ``launched``.  A wrapper called while its
thread captures a CUDA graph (``capturing``) launches nothing: the graph
records the kernel, and each replay counts it (``replayed``).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, NamedTuple

import torch

from .histogram import build_histogram as build_histogram_plain
from .histogram import (build_histogram_multi_plain,
                        build_level_hist_multi_plain)
from .quantise import hist_accumulate_q

__all__ = ["build_histogram", "build_histogram_cuda", "build_histogram_plain",
           "build_histogram_multi", "build_histogram_multi_cuda",
           "build_histogram_multi_plain", "build_level_hist_multi",
           "build_level_hist_multi_cuda", "build_level_hist_multi_plain",
           "build_histogram_q", "build_histogram_q_cuda",
           "build_histogram_q_plain", "build_all", "card_max_clusters",
           "choose_block", "Plan", "MultiPlan", "load_library", "launches",
           "plan_f32", "plan_f32_multi", "plan_q", "planned_multi",
           "reset_launches", "thread_launches", "run_f32", "run_f32_multi", "run_q",
           "slice_units", "launched", "capturing", "replayed", "on_device", "multi_smem",
           "multi_scratch", "multi_partial", "multi_roles", "multi_chunk",
           "class_axis_lanes", "bucket_level", "class_axis_items",
           "class_axis_item_rows", "class_axis_model", "SOURCES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG, "_build")
# kernel name -> its source, relative to the repository root
SOURCES = {"hist_f32": "xgboost_tpu_torch/csrc/hist.cu",
           "hist_f32_multi": "xgboost_tpu_torch/csrc/hist_multi.cu",
           "hist_q": "xgboost_tpu_torch/csrc/hist_q.cu",
           "split_scan": "xgboost_tpu_torch/csrc/split_scan.cu",
           "sigmoid": "xgboost_tpu_torch/csrc/sigmoid.cu",
           "lambdarank": "xgboost_tpu_torch/csrc/lambdarank.cu",
           "treeshap": "xgboost_tpu_torch/csrc/treeshap.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
# K3-K6 must round as the reference does: no contracted multiply-adds
EXTRA_FLAGS = {"split_scan": ["--fmad=false"], "sigmoid": ["--fmad=false"],
               "lambdarank": ["--fmad=false"], "treeshap": ["--fmad=false"]}

# kernel launches per kernel since the last reset_launches(); K6's
# interaction entry is counted apart from its values entry.  The ranks of
# the in-memory collective are threads of one process: ``launches`` counts
# them all, ``thread_launches()`` the calling thread's own
launches = {name: 0 for name in [*SOURCES, "treeshap_interactions"]}
_count_lock = threading.Lock()
_thread_counts = threading.local()
_capture = threading.local()  # .names: the kernels a capture recorded

_BIN_CODES = {torch.uint8: 0, torch.int16: 1, torch.int32: 2}
# shared memory one block may use for its histogram; 227 KB is the H100's
# per-block opt-in limit, the rest is left for the runtime's own reservation
SMEM_BUDGET = 220 * 1024
# a block of either kernel: 32 warps, and the static shared memory of their
# per-warp row lists (32 warps x 95 rows x 8 bytes), taken from the
# histogram's budget
THREADS = 1024
STAGE_BYTES = 32 * 95 * 8
CLUSTERS = (8, 4, 2, 1)  # cluster sizes the kernels may use, largest first
_vp, _ci = ctypes.c_void_p, ctypes.c_int
# C signatures of each kernel library's entry points {name: argtypes}
_ENTRY = {
    "hist_f32": {"xtb_hist_f32": [_vp, _ci, _vp, _vp, _vp] + [_ci] * 12
                 + [_vp]},
    "hist_f32_multi": {"xtb_hist_f32_multi": [_vp, _ci] + [_vp] * 6
                       + [_ci] * 8 + [ctypes.c_longlong] + [_ci] * 10
                       + [_vp]},
    "hist_q": {"xtb_hist_q": [_vp, _ci, _vp, _vp, _vp] + [_ci] * 13
               + [_vp]},
    "split_scan": {"xtb_split_scan": [_vp] * 4 + [_ci] + [_vp] * 3 + [_ci]
                   + [_vp] * 2 + [_ci] * 3 + [ctypes.c_float] * 4 + [_ci]
                   + [_vp] * 8},
    "sigmoid": {"xtb_sigmoid": [_vp, _vp, ctypes.c_longlong, _vp],
                "xtb_logistic_grad": [_vp, _vp, _vp, ctypes.c_float, _vp,
                                      ctypes.c_longlong, _vp]},
    "lambdarank": {"xtb_lambdarank": [_vp] * 5 + [_ci] * 4 + [_vp, _ci]
                   + [_vp] * 3 + [ctypes.c_longlong, _vp] + [_ci] * 4
                   + [_vp, _vp],
                   "xtb_lambdarank_plan": [_ci] * 4
                   + [ctypes.POINTER(_ci)] * 2,
                   "xtb_lambdarank_geometry": [ctypes.POINTER(_ci)] * 3},
    "treeshap": {entry: [_vp] + [_ci] * 3 + [_vp] * 8 + [_ci] * 4
                 + [ctypes.c_double] + [_ci] * 2 + [_vp] * 7
                 for entry in ("xtb_treeshap", "xtb_treeshap_interactions")},
}
_libs: dict = {}
_lib_lock = threading.Lock()
_clusters: dict = {}  # (kernel, device, bin code, staged, threads, smem, C)
_plans: dict = {}  # each kernel's plan per (device, dtype, shapes, stride)


def reset_launches() -> None:
    """Zero the process's counts and the calling thread's."""
    with _count_lock:
        for name in launches:
            launches[name] = 0
    _thread_counts.counts = dict.fromkeys(launches, 0)


def thread_launches() -> dict:
    """The calling thread's launches per kernel since it last called
    ``reset_launches`` (or since it started)."""
    counts = getattr(_thread_counts, "counts", None)
    if counts is None:
        counts = _thread_counts.counts = dict.fromkeys(launches, 0)
    return counts


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin/ on PATH)")


def _src_path(name: str) -> str:
    return os.path.join(os.path.dirname(_PKG), SOURCES[name])


def _flags(name: str):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _lib_path(name: str) -> str:
    with open(_src_path(name), "rb") as fh:
        h = hashlib.sha256(fh.read())
    h.update(" ".join(_flags(name)).encode())
    digest = h.hexdigest()[:16]
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
                [nvcc, *_flags(name), "-o", tmp, _src_path(name)],
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
    lib = _libs.get(name)  # loaded: no lock on the launch path
    if lib is not None:
        return lib
    with _lib_lock:
        if name in _libs:
            return _libs[name]
        _build([name])
        lib = ctypes.CDLL(_lib_path(name))
        for entry, argtypes in _ENTRY[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = _ci
        query = getattr(lib, f"xtb_{name}_max_clusters", None)
        if query is not None:  # the histogram kernels' occupancy query
            query.argtypes = [_ci] * 5 + [ctypes.POINTER(_ci)]
            query.restype = _ci
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


def on_device(device, entry, *args) -> int:
    """``entry(*args, stream)``, a kernel library's entry point, with
    ``device`` current and ``stream`` its current stream: the CUDA runtime
    launches on the calling thread's device.  Returns the entry's code."""
    # the raw stream handle; torch.cuda.current_stream builds an object
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        return entry(*args, stream)
    with torch.cuda.device(device):
        return entry(*args, stream)


def launched(name: str, lib, rc: int) -> None:
    """Count one launch of kernel ``name``, or raise with the card's
    reason if its entry point returned an error.  Under ``capturing`` the
    kernel is recorded into the graph, not launched: it is noted for the
    graph's replays and counted nowhere."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.xtb_cuda_error_string(rc).decode())
    captured = getattr(_capture, "names", None)
    if captured is not None:
        captured.append(name)
        return
    with _count_lock:
        launches[name] += 1
    thread_launches()[name] += 1


@contextlib.contextmanager
def capturing():
    """The calling thread captures a CUDA graph inside: yields the list
    of the kernels that wrappers record into it, in order."""
    prev = getattr(_capture, "names", None)
    _capture.names = names = []
    try:
        yield names
    finally:
        _capture.names = prev


def replayed(names) -> None:
    """Count one replay of a graph that captured the kernels ``names``:
    each of them launches once more."""
    counts = thread_launches()
    with _count_lock:
        for name in names:
            launches[name] += 1
    for name in names:
        counts[name] += 1


class Plan(NamedTuple):
    """A kernel's launch: features and nodes per block, row blocks (a
    multiple of ``cluster``), blocks per cluster along the row blocks,
    threads, and the row loop (True: staged; False: one thread per row)."""
    feat_group: int
    node_tile: int
    row_blocks: int
    cluster: int
    threads: int
    staged: bool


def _plan(n_rows: int, n_features: int, n_nodes: int, n_bin: int,
          words: int, max_clusters: Callable[[bool, int, int], int],
          stride: int, kernel: str) -> Plan:
    """The launch of ``kernel``, whose cell is ``words`` 4-byte words.
    Features and nodes per block as ``choose_block`` picks them, within
    the budget left beside the row lists.  The staged row loop where the
    level skips rows (``stride`` > 1 or more than one node tile), one
    thread per row where every row counts.  Then the cluster size C of
    ``CLUSTERS``, no larger than the (node, feature) pairs a block has to
    flush, whose wave holds the most blocks, and of those the largest:
    ``max_clusters(staged, smem, C)`` is the most clusters of C blocks with
    ``smem`` bytes of histogram the card holds at once
    (``card_max_clusters``).  The row loop is bound by each SM's
    shared-memory atomics, so a wave that leaves SMs idle costs more than
    the flush that a smaller C adds.  Last, as many row blocks per
    (feature group, node tile) as fill that wave, and no more than the rows
    give a block's threads one row each."""
    fg, nt = choose_block(n_features, n_nodes, n_bin, words,
                          SMEM_BUDGET - STAGE_BYTES)
    smem = fg * nt * n_bin * words * 4
    n_tiles = -(-n_nodes // nt)
    n_cols = -(-n_features // fg) * n_tiles
    staged = stride > 1 or n_tiles > 1
    # blocks one wave holds with each cluster size C no larger than the
    # pairs a block can flush; the most blocks, then the largest C
    wave = {c: c * max_clusters(staged, smem, c) for c in CLUSTERS
            if c <= fg * nt}
    if not any(wave.values()):
        raise ValueError(f"the card holds no block of {kernel} with {smem} B "
                         "of histogram")
    cluster = max(wave, key=lambda c: (wave[c], c))
    per_col = min(wave[cluster] // cluster // n_cols,
                  -(-n_rows // (cluster * THREADS)))
    return Plan(fg, nt, cluster * max(1, per_col), cluster, THREADS, staged)


def plan_f32(n_rows: int, n_features: int, n_nodes: int, n_bin: int,
             max_clusters: Callable[[bool, int, int], int],
             stride: int = 1) -> Plan:
    """K1's launch geometry (``_plan`` with (g, h) f32 cells)."""
    return _plan(n_rows, n_features, n_nodes, n_bin, 2, max_clusters, stride,
                 "hist_f32")


class MultiPlan(NamedTuple):
    """The class axis's launch (csrc/hist_multi.cu): ``feat_group``
    features a block, ``feats_per_warp`` to each of its feat_group /
    feats_per_warp accumulating warps; one node a block (``node_tile``);
    ``class_group`` classes a block (one where a pos per class is
    bucketed); bin rows of ``cell_row`` words a
    warp; items of ``cluster`` * ``rows_per_block`` steps of one node,
    taken in turn by the ``row_blocks`` / ``cluster`` clusters of each
    feature group; ``bucketed``: the (class, row) pairs are bucketed
    by node first, else step s is row s of the level's one node;
    ``k1_rows``, the rows of K1's block at the level, of which a bucketed
    node takes its share."""
    feat_group: int
    node_tile: int
    class_group: int
    feats_per_warp: int
    cell_row: int
    rows_per_block: int
    row_blocks: int
    cluster: int
    threads: int
    bucketed: bool
    k1_rows: int

    @property
    def units(self) -> int:
        """The block's accumulating warps."""
        return self.feat_group // self.feats_per_warp


# a class-axis block: MULTI_THREADS threads, at most MULTI_MAX_UNITS
# accumulating warps; the other 8 or more warps stage rows, each thread at
# most MULTI_ROLES groups of 4 steps of a staged row
MULTI_THREADS = 640
MULTI_MAX_UNITS = 12
MULTI_ROLES = 3


def multi_chunk(shared_pos: bool, bucketed: bool) -> int:
    """Steps a class-axis block stages at once: 64 where a block takes one
    class of a pos per class (bucketed), else 128."""
    return 64 if bucketed and not shared_pos else 128


def multi_roles(units: int, class_group: int, feats_per_warp: int,
                shared_pos: bool, bucketed: bool) -> int:
    """Groups of 4 steps that a class-axis block stages a chunk: of its
    classes' gradient rows (both channels a group), its features' bins
    rows and, bucketed, the row ids."""
    rows = class_group + units * feats_per_warp + (1 if bucketed else 0)
    return multi_chunk(shared_pos, bucketed) // 4 * rows


def multi_smem(units: int, n_bin: int, cell_row: int, class_group: int,
               feats_per_warp: int, bin_bytes: int, shared_pos: bool,
               bucketed: bool) -> int:
    """Shared memory of a class-axis block, in bytes: the cells (units x
    (n_bin + 1) x cell_row f32 words; bin row n_bin takes the adds of
    missing bins), two staging buffers (a gradient row a class and
    channel, a bins row a feature) and two slots of staged row ids
    (csrc/hist_multi.cu: layout)."""
    chunk = multi_chunk(shared_pos, bucketed)
    cells = -(-units * (n_bin + 1) * cell_row * 4 // 16) * 16
    bin_pitch = chunk * bin_bytes + 16
    buf = (2 * class_group * (chunk + 4) * 4
           + units * feats_per_warp * bin_pitch)
    return cells + 2 * buf + 2 * chunk * 4


def plan_f32_multi(n_rows: int, n_features: int, n_nodes: int, n_bin: int,
                   n_classes: int,
                   max_clusters: Callable[[bool, int, int], int],
                   stride: int = 1, k1_clusters=None, *,
                   shared_pos: bool = False,
                   bin_bytes: int = 2) -> MultiPlan:
    """The class axis's launch.  Classes: one a block where a pos per
    class is bucketed (the classes' rows differ there, so a block of
    several would stage each class's rows apart, which took longer over a
    lockstep round's levels, PERF.md §6); else groups of at most 16 (a
    warp's lanes), as even as they go.  A
    warp owns feats_per_warp = 32 // (2 KG) features of KG classes and
    both channels, in bin rows of 32 words (so its lanes never share a
    bank); where one such warp's cells do not fit, one feature a warp in
    rows of the next power of two above 2 KG, with fewer classes a group
    if even that does not fit.  As many warps a block (at most
    MULTI_MAX_UNITS) as fit the budget K1's histogram has beside its row
    lists (so K1's occupancy query also answers for this kernel), even
    over the feature groups, and no more than leave MULTI_ROLES groups
    of a chunk to each staging thread.  Bucketed where the level skips
    rows (``stride`` > 1 or more than one node), one node a block; the
    root walks all the rows, each read once for every class, as K1
    does.  The
    cluster size as ``_plan`` picks it, from ``max_clusters(bucketed,
    smem, C)``; as many clusters per feature group as one wave holds,
    taking the items of every class group in turn (so a class whose level
    holds more rows gets more clusters).  Rows a block an item: at most
    the rows K1's plan gives a block at this level (``plan_f32`` with
    ``k1_clusters``, default ``max_clusters``): unbucketed, fewer where
    that gives each cluster one item; bucketed, a node's share of them
    (``class_axis_item_rows``: K1's block sums a node's rows among all
    the others'), so a cell sums no more rows in one block than K1's and
    rounds as much, and no more than about four items a cluster would
    take were one node to hold every row; never fewer than four staged
    chunks."""
    k1 = plan_f32(n_rows, n_features, n_nodes, n_bin,
                  k1_clusters or max_clusters, stride)
    k1_rows = -(-n_rows // k1.row_blocks)
    bucketed = stride > 1 or n_nodes > 1
    budget = SMEM_BUDGET - STAGE_BYTES

    def smem(units, kg, per_warp, row):
        roles = multi_roles(units, kg, per_warp, shared_pos, bucketed)
        if roles > MULTI_ROLES * (MULTI_THREADS - 32 * units):
            return budget + 1  # more than the staging threads hold
        return multi_smem(units, n_bin, row, kg, per_warp, bin_bytes,
                          shared_pos, bucketed)

    n_cg = (n_classes if bucketed and not shared_pos
            else -(-n_classes // min(n_classes, 16)))
    kg = -(-n_classes // n_cg)
    per_warp, row = 32 // (2 * kg), 32
    if smem(1, kg, per_warp, row) > budget:
        per_warp = 1
        while True:
            row = 1 << (2 * kg - 1).bit_length()
            if smem(1, kg, 1, row) <= budget:
                break
            if kg == 1:
                raise ValueError(
                    f"one class's histogram of one feature ({n_bin} bins) "
                    f"does not fit {budget} B of shared memory")
            n_cg = -(-n_classes // (kg - 1))
            kg = -(-n_classes // n_cg)
    max_units = 1
    while max_units < MULTI_MAX_UNITS \
            and smem(max_units + 1, kg, per_warp, row) <= budget:
        max_units += 1
    n_units = -(-n_features // per_warp)
    n_fg = -(-n_units // max_units)
    units = -(-n_units // n_fg)
    need = smem(units, kg, per_warp, row)
    wave = {c: c * max_clusters(bucketed, need, c) for c in CLUSTERS}
    if not any(wave.values()):
        raise ValueError(f"the card holds no block of hist_f32_multi with "
                         f"{need} B of shared memory")
    cluster = max(wave, key=lambda c: (wave[c], c))
    n_q = max(1, wave[cluster] // cluster // n_fg)
    floor = 4 * multi_chunk(shared_pos, bucketed)
    # unbucketed, one item a cluster; bucketed, at most about four a
    # cluster were one node to hold every row (each node takes its share
    # of K1's block below that)
    rows = -(-n_cg * n_rows // ((4 if bucketed else 1) * cluster * n_q))
    rows = min(k1_rows, max(floor, rows))
    if not bucketed:
        n_q = min(n_q, n_cg * -(-n_rows // (cluster * rows)))
    return MultiPlan(units * per_warp, 1, kg, per_warp, row, rows,
                     cluster * n_q, cluster, MULTI_THREADS, bucketed, k1_rows)


def class_axis_item_rows(plan: MultiPlan, count: int, n_rows: int,
                         shared_pos: bool = False) -> int:
    """Rows a class-axis block sums in one item of a node whose list holds
    ``count`` rows: unbucketed, rows_per_block; bucketed, the node's share
    of K1's block (k1_rows of the n_rows rows, count * k1_rows / n_rows of
    them in the node), at least four staged chunks and at most
    rows_per_block (csrc/hist_multi.cu: item_rows)."""
    if not plan.bucketed:
        return plan.rows_per_block
    share = -(-count * plan.k1_rows // n_rows)
    floor = 4 * multi_chunk(shared_pos, True)
    return min(plan.rows_per_block, max(floor, share))


def class_axis_lanes(plan: MultiPlan):
    """Lane l of an accumulating warp -> (feature of the warp's
    feats_per_warp, class of the group, channel) whose cells, every bin,
    it owns, or None for an idle lane: lane = feature * 2 KG + 2 class +
    channel (csrc/hist_multi.cu)."""
    lanes = 2 * plan.class_group
    out = []
    for lane in range(32):
        fsub, kc = divmod(lane, lanes)
        out.append((fsub, kc >> 1, kc & 1)
                   if fsub < plan.feats_per_warp else None)
    return out


def multi_scratch(n_rows: int, n_nodes: int, n_classes: int,
                  class_group: int, shared_pos: bool) -> int:
    """int32 words of a bucketed call's scratch: counts, starts and
    cursors a (list, node), the items prefix over the (class group, node)
    pairs and its total, and the lists, one a class or one shared
    (csrc/hist_multi.cu)."""
    n_lists = 1 if shared_pos else n_classes
    n_cg = -(-n_classes // class_group)
    return 3 * n_lists * n_nodes + n_cg * n_nodes + 1 + n_lists * n_rows


def multi_partial(plan: MultiPlan, n_features: int, n_classes: int,
                  n_bin: int) -> int:
    """f64 words of a call's partial sums: each block's share of its
    cluster's flush (a 1/cluster of its units * n_bin bin rows of
    cell_row words), kept over the items of one node and added to the
    output once (csrc/hist_multi.cu)."""
    blocks = -(-n_features // plan.feat_group) * plan.row_blocks
    return blocks * (-(-plan.units * n_bin // plan.cluster) * plan.cell_row)


def bucket_level(pos, *, node0: int, n_nodes: int, stride: int = 1):
    """The count, scan and scatter of a bucketed call, on (L, R) pos (a
    list a class, or one (1, R) shared): counts (L, N), the rows of list l
    in the level's node t; starts (L, N), where they begin in the flat
    (L * R,) ``rows`` (l * R plus the rows of l in earlier nodes); rows,
    each list's rows node by node (ascending here; the card's warps
    scatter in no fixed order within a node), -1 past its level's
    rows."""
    L, R = pos.shape
    local = pos.long() - node0
    ok = (local >= 0) & (local % stride == 0) & (local // stride < n_nodes)
    node = torch.where(ok, local // stride, n_nodes)  # n_nodes: outside
    counts = torch.zeros((L, n_nodes + 1), dtype=torch.int64,
                         device=pos.device)
    counts.scatter_add_(1, node, torch.ones_like(node))
    counts = counts[:, :n_nodes]
    starts = (torch.cumsum(counts, 1) - counts
              + torch.arange(L, device=pos.device)[:, None] * R)
    order = torch.sort(node, dim=1, stable=True).indices
    rows = torch.where(torch.arange(R, device=pos.device)[None]
                       < counts.sum(1, keepdim=True), order, -1)
    return counts, starts, rows.reshape(-1)


def class_axis_items(counts, plan: MultiPlan, n_classes: int, n_rows: int,
                     shared_pos: bool = False):
    """(n_cgroups * N + 1,): the items of the (class group, node) pairs
    before (g, t) at g * N + t, their total last; a pair's items cover its
    list (the shared one, or class g's, one class a group) in spans of
    cluster * ``class_axis_item_rows`` steps (the scan of
    csrc/hist_multi.cu)."""
    L, N = counts.shape
    n = []
    for g in range(-(-n_classes // plan.class_group)):
        for t in range(N):
            count = int(counts[0 if L == 1 else g, t])
            span = plan.cluster * class_axis_item_rows(plan, count, n_rows,
                                                       shared_pos)
            n.append(-(-count // span))
    return torch.cumsum(torch.tensor([0] + n), 0)


def class_axis_model(bins, gpair, pos, plan: MultiPlan, *, node0: int,
                     n_nodes: int, n_bin: int, stride: int = 1,
                     shared_pos: bool = False):
    """K1's class axis as csrc/hist_multi.cu computes it, in PyTorch: for
    every feature group and each item of the one queue its clusters take
    (a class group and, bucketed, a node), each rank's rows of every class
    of the group (bucketed: its list's steps in the item's node, that
    node's ``class_axis_item_rows`` a rank; else the rows of the item
    flagged in the node), summed with the plain histogram, then each
    lane's (feature, class, channel) cells added to the output as the
    flush does.  Returns the lockstep (K, N, F, B, 2) layout, or (N, F,
    B, K, 2) with ``shared_pos``."""
    R, F = bins.shape
    K = gpair.shape[1]
    pk = pos.reshape(1, R) if shared_pos else pos
    out = torch.zeros((K, n_nodes, F, n_bin, 2), dtype=torch.float32)
    C, KG, P = plan.cluster, plan.class_group, plan.feats_per_warp
    n_cg = -(-K // KG)
    per_g = -(-R // (C * plan.rows_per_block))
    lanes = [(u, lane, own) for u in range(plan.units)
             for lane, own in enumerate(class_axis_lanes(plan))
             if own is not None]
    if plan.bucketed:
        counts, starts, rows = bucket_level(pk, node0=node0, n_nodes=n_nodes,
                                            stride=stride)
        items = class_axis_items(counts, plan, K, R, shared_pos)
    n_items = int(items[-1]) if plan.bucketed else n_cg * per_g
    for x in range(-(-F // plan.feat_group)):
        f0 = x * plan.feat_group
        feats = torch.arange(f0, min(F, f0 + plan.feat_group))
        for item in range(n_items):  # cluster item % n_q takes it
            if plan.bucketed:
                ft = int(torch.searchsorted(items, item, right=True)) - 1
                z, t = divmod(ft, n_nodes)
                j = item - int(items[ft])
                step = class_axis_item_rows(
                    plan, int(counts[0 if shared_pos else z, t]), R,
                    shared_pos)
            else:
                (z, j), t = divmod(item, per_g), 0
                step = plan.rows_per_block
            k0, kg = z * KG, min(KG, K - z * KG)
            for rank in range(C):
                s0 = (j * C + rank) * step
                s1 = s0 + step
                block = torch.zeros((kg, len(feats), n_bin, 2))
                for kk in range(kg):
                    k = k0 + kk
                    if plan.bucketed:
                        l = 0 if shared_pos else k
                        n = int(counts[l, t])
                        at = int(starts[l, t])
                        walk = rows[at + min(s0, n):at + min(s1, n)]
                        in_node = torch.ones_like(walk, dtype=torch.bool)
                    else:
                        walk = torch.arange(min(s0, R), min(s1, R))
                        in_node = pk[0 if shared_pos else k][walk] == node0
                    walk = walk[in_node]
                    block[kk] = build_histogram_plain(
                        bins[walk][:, feats], gpair[walk, k],
                        torch.zeros(len(walk), dtype=torch.int32),
                        node0=0, n_nodes=1, n_bin=n_bin)[0]
                for u, _, (fsub, kk, ch) in lanes:
                    f = u * P + fsub
                    if kk < kg and f < len(feats):
                        out[k0 + kk, t, f0 + f, :, ch] += block[kk, f, :, ch]
    return out.permute(1, 2, 3, 0, 4) if shared_pos else out


def plan_q(n_rows: int, n_features: int, n_nodes: int, n_bin: int,
           n_ch: int, max_clusters: Callable[[bool, int, int], int],
           stride: int = 1) -> Plan:
    """K2's launch geometry (``_plan`` with cells of ``n_ch`` int32 limb
    sums; ``max_clusters`` from ``card_max_clusters(..., "hist_q")``)."""
    return _plan(n_rows, n_features, n_nodes, n_bin, n_ch, max_clusters,
                 stride, "hist_q")


def slice_units(n_units: int, cluster: int, rank: int) -> range:
    """The (node, feature) pairs, numbered slot * fg + feature, that block
    ``rank`` of a cluster sums over the cluster and flushes: the split of
    the flush in csrc/hist.cu and csrc/hist_q.cu."""
    return range(rank * n_units // cluster, (rank + 1) * n_units // cluster)


def card_max_clusters(device, bin_dtype, kernel: str = "hist_f32",
                      threads: int = THREADS
                      ) -> Callable[[bool, int, int], int]:
    """``max_clusters`` for ``plan_f32`` (or, with ``kernel="hist_q"``,
    ``plan_q``) on ``device``: the CUDA runtime's
    cudaOccupancyMaxActiveClusters for that kernel with ``bin_dtype``
    bins, queried once per (row loop, histogram bytes, C) and cached.
    Raises if the query fails."""
    code = _BIN_CODES[bin_dtype]
    lib = load_library(kernel)
    fn = getattr(lib, f"xtb_{kernel}_max_clusters")

    def query(staged: bool, smem: int, cluster: int) -> int:
        key = (kernel, str(device), code, staged, threads, smem, cluster)
        if key not in _clusters:
            n = _ci(0)
            with torch.cuda.device(device):
                rc = fn(code, smem, cluster, threads, int(staged),
                        ctypes.byref(n))
            if rc != 0:
                raise RuntimeError(
                    f"{kernel} occupancy query failed: "
                    + lib.xtb_cuda_error_string(rc).decode())
            _clusters[key] = n.value
        return _clusters[key]
    return query


def _planned(kernel: str, bins, n_nodes: int, n_bin: int, stride: int,
             words: int) -> Plan:
    """``kernel``'s launch for these inputs, planned once per (card, bin
    type, shapes, level) and cached."""
    R, F = bins.shape
    key = (kernel, str(bins.device), bins.dtype, R, F, words, n_nodes, n_bin,
           stride)
    if key not in _plans:
        _plans[key] = _plan(R, F, n_nodes, n_bin, words,
                            card_max_clusters(bins.device, bins.dtype, kernel),
                            stride, kernel)
    return _plans[key]


def run_f32(bins, gpair, pos, plan: Plan, *, node0: int, n_nodes: int,
            n_bin: int, stride: int = 1):
    """Launch K1 with ``plan``: hist (n_nodes, F, n_bin, 2) f32 on the
    inputs' card.  A launch the card refuses raises."""
    _check(bins, gpair, pos, torch.float32, (2,), n_nodes, n_bin, stride)
    R, F = bins.shape
    out = torch.zeros((n_nodes, F, n_bin, 2), dtype=torch.float32,
                      device=bins.device)
    if R == 0 or F == 0:
        return out
    lib = load_library("hist_f32")
    rc = on_device(
        bins.device, lib.xtb_hist_f32, bins.data_ptr(),
        _BIN_CODES[bins.dtype], gpair.data_ptr(), pos.data_ptr(),
        out.data_ptr(), R, F, n_bin, node0, n_nodes, stride,
        plan.feat_group, plan.node_tile, plan.row_blocks, plan.cluster,
        plan.threads, int(plan.staged))
    launched("hist_f32", lib, rc)
    return out


def build_histogram_cuda(bins, gpair, pos, *, node0: int, n_nodes: int,
                         n_bin: int, stride: int = 1):
    """Launch K1: hist (n_nodes, F, n_bin, 2) f32 on the inputs' card."""
    _check(bins, gpair, pos, torch.float32, (2,), n_nodes, n_bin, stride)
    return run_f32(bins, gpair, pos,
                   _planned("hist_f32", bins, n_nodes, n_bin, stride, 2),
                   node0=node0, n_nodes=n_nodes, n_bin=n_bin, stride=stride)


def run_f32_multi(bins, gpair, pos, plan: MultiPlan, *, node0: int,
                  n_nodes: int, n_bin: int, stride: int = 1,
                  shared_pos: bool = False):
    """Launch K1's class axis with ``plan``: K histograms from gpair
    (R, K, 2) f32 in one call on the inputs' card.  ``pos`` (K, R)
    int32, class k's rows at pos[k] (the lockstep grower), gives hist
    (K, n_nodes, F, n_bin, 2); with ``shared_pos`` one (R,) pos routes
    every class (a vector-leaf tree's targets) and hist is (n_nodes, F,
    n_bin, K, 2), written in that layout by the kernel.  A plan or launch
    the card refuses raises."""
    if gpair.dim() != 3 or gpair.shape[-1] != 2:
        raise ValueError(f"gpair must be (R, K, 2) f32, got "
                         f"{tuple(gpair.shape)}")
    R, K = gpair.shape[0], gpair.shape[1]
    if shared_pos:
        _check(bins, gpair, pos, torch.float32, (K, 2), n_nodes, n_bin,
               stride)
    else:
        if pos.dim() != 2 or tuple(pos.shape) != (K, R):
            raise ValueError(f"pos must be (K, R) = ({K}, {R}), got "
                             f"{tuple(pos.shape)}")
        _check(bins, gpair, pos[0], torch.float32, (K, 2), n_nodes, n_bin,
               stride)
        if not pos.is_contiguous():
            raise ValueError("bins, gradients and pos must be contiguous")
    if not plan.bucketed and (n_nodes != 1 or stride != 1):
        raise ValueError("an unbucketed class-axis plan takes one node at "
                         "stride 1")
    if plan.bucketed and not shared_pos and plan.class_group != 1:
        raise ValueError("a bucketed class-axis plan with a pos per class "
                         "takes one class a block")
    F = bins.shape[1]
    cells = n_nodes * F * n_bin
    if shared_pos:
        shape, out_class, out_cell = (n_nodes, F, n_bin, K, 2), 2, 2 * K
    else:
        shape, out_class, out_cell = (K, n_nodes, F, n_bin, 2), 2 * cells, 2
    if R == 0 or F == 0:
        return torch.zeros(shape, dtype=torch.float32, device=bins.device)
    # the kernel writes every cell of `out`, rounding the f64 sums `acc`
    out = torch.empty(shape, dtype=torch.float32, device=bins.device)
    acc = torch.zeros(shape, dtype=torch.float64, device=bins.device)
    scratch = torch.empty(
        multi_scratch(R, n_nodes, K, plan.class_group, shared_pos)
        if plan.bucketed else 0, dtype=torch.int32, device=bins.device)
    partial = torch.empty(multi_partial(plan, F, K, n_bin),
                          dtype=torch.float64, device=bins.device)
    lib = load_library("hist_f32_multi")
    rc = on_device(
        bins.device, lib.xtb_hist_f32_multi, bins.data_ptr(),
        _BIN_CODES[bins.dtype], gpair.data_ptr(), pos.data_ptr(),
        out.data_ptr(), acc.data_ptr(), scratch.data_ptr(),
        partial.data_ptr(), R, F,
        n_bin, node0, n_nodes,
        stride, K, int(shared_pos), out_class, out_cell, plan.units,
        plan.class_group, plan.feats_per_warp, plan.cell_row,
        plan.rows_per_block, plan.k1_rows, plan.row_blocks, plan.cluster,
        int(plan.bucketed))
    launched("hist_f32_multi", lib, rc)
    return out


def planned_multi(bins, n_classes: int, n_nodes: int, n_bin: int,
                  stride: int, shared_pos: bool) -> MultiPlan:
    """The class axis's launch for these inputs, planned from the card's
    occupancy of it and of K1 once per (card, bin type, shapes, level)
    and cached."""
    R, F = bins.shape
    key = ("hist_f32_multi", str(bins.device), bins.dtype, R, F, n_classes,
           n_nodes, n_bin, stride, shared_pos)
    if key not in _plans:
        _plans[key] = plan_f32_multi(
            R, F, n_nodes, n_bin, n_classes,
            card_max_clusters(bins.device, bins.dtype, "hist_f32_multi",
                              MULTI_THREADS),
            stride, card_max_clusters(bins.device, bins.dtype),
            shared_pos=shared_pos, bin_bytes=bins.element_size())
    return _plans[key]


def _multi_cuda(bins, gpair, pos, node0, n_nodes, n_bin, stride, shared):
    if not bins.is_cuda:
        raise ValueError("the histogram kernels need CUDA tensors")
    plan = planned_multi(bins, gpair.shape[1], n_nodes, n_bin, stride,
                         shared)
    return run_f32_multi(bins, gpair, pos, plan, node0=node0,
                         n_nodes=n_nodes, n_bin=n_bin, stride=stride,
                         shared_pos=shared)


def build_histogram_multi_cuda(bins, gpair, pos, *, node0: int,
                               n_nodes: int, n_bin: int, stride: int = 1):
    """Launch K1's class axis for K class trees: hist (K, n_nodes, F,
    n_bin, 2) f32 from gpair (R, K, 2) and pos (K, R)."""
    return _multi_cuda(bins, gpair, pos, node0, n_nodes, n_bin, stride,
                       False)


def build_level_hist_multi_cuda(bins, gpair, pos, *, node0: int,
                                n_nodes: int, n_bin: int, stride: int = 1):
    """Launch K1's class axis for a vector-leaf tree's K targets: hist
    (n_nodes, F, n_bin, K, 2) f32 from gpair (R, K, 2) and one pos (R,)."""
    return _multi_cuda(bins, gpair, pos, node0, n_nodes, n_bin, stride,
                       True)


def _check_q(bins, gq, pos, n_nodes, n_bin, stride):
    if gq.dim() != 3 or gq.shape[-1] != 3:
        raise ValueError(f"gq must be (R, C, 3) int8 limbs, got "
                         f"{tuple(gq.shape)}")
    _check(bins, gq, pos, torch.int8, tuple(gq.shape[1:]), n_nodes, n_bin,
           stride)


def run_q(bins, gq, pos, plan: Plan, *, node0: int, n_nodes: int,
          n_bin: int, stride: int = 1):
    """Launch K2 with ``plan``: exact limb hist (n_nodes, F, n_bin, C, 3)
    int32 from gq (R, C, 3) int8 on the inputs' card.  A launch the card
    refuses raises."""
    _check_q(bins, gq, pos, n_nodes, n_bin, stride)
    R, F = bins.shape
    C = gq.shape[1]
    out = torch.zeros((n_nodes, F, n_bin, C, 3), dtype=torch.int32,
                      device=bins.device)
    if R == 0 or F == 0:
        return out
    lib = load_library("hist_q")
    rc = on_device(
        bins.device, lib.xtb_hist_q, bins.data_ptr(), _BIN_CODES[bins.dtype],
        gq.data_ptr(), pos.data_ptr(), out.data_ptr(), R, F, n_bin, 3 * C,
        node0, n_nodes, stride, plan.feat_group, plan.node_tile,
        plan.row_blocks, plan.cluster, plan.threads, int(plan.staged))
    launched("hist_q", lib, rc)
    return out


def build_histogram_q_cuda(bins, gq, pos, *, node0: int, n_nodes: int,
                           n_bin: int, stride: int = 1):
    """Launch K2: exact limb hist (n_nodes, F, n_bin, C, 3) int32 from gq
    (R, C, 3) int8 on the inputs' card."""
    _check_q(bins, gq, pos, n_nodes, n_bin, stride)
    return run_q(bins, gq, pos,
                 _planned("hist_q", bins, n_nodes, n_bin, stride,
                          3 * gq.shape[1]),
                 node0=node0, n_nodes=n_nodes, n_bin=n_bin, stride=stride)


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


def build_histogram_multi(bins, gpair, pos, *, node0: int, n_nodes: int,
                          n_bin: int, stride: int = 1):
    """The lockstep grower's K class histograms (K, n_nodes, F, n_bin, 2):
    the plain version for a CPU tensor, one launch of K1's class axis for
    a CUDA tensor (which raises if it cannot run)."""
    fn = build_histogram_multi_cuda if bins.is_cuda \
        else build_histogram_multi_plain
    return fn(bins, gpair, pos, node0=node0, n_nodes=n_nodes, n_bin=n_bin,
              stride=stride)


def build_level_hist_multi(bins, gpair, pos, *, node0: int, n_nodes: int,
                           n_bin: int, stride: int = 1):
    """A vector-leaf tree's level histogram (n_nodes, F, n_bin, K, 2): the
    plain version for a CPU tensor, one launch of K1's class axis for a
    CUDA tensor (which raises if it cannot run)."""
    fn = build_level_hist_multi_cuda if bins.is_cuda \
        else build_level_hist_multi_plain
    return fn(bins, gpair, pos, node0=node0, n_nodes=n_nodes, n_bin=n_bin,
              stride=stride)
