"""Depthwise hist tree growing (port of the per-depth path of
xgboost_tpu/tree/grow.py; reference src/tree/updater_gpu_hist.cu:617).

The tree grows level by level over a heap-indexed node array (node i ->
children 2i+1, 2i+2).  One ``level_step`` per depth builds the histogram
(left children only below the root, right siblings by subtraction), picks
the best split per node, records it and routes rows to their children by
rewriting ``pos`` (the RowPartitioner analogue, without a physical
partition).  Everything in the level loop stays on the device: no value is
read back to the host until the finished tree is copied out.  The state's
tensors are updated in place, level after level.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.hist_cuda import build_histogram
from ..ops.histogram import combine_sibling_hists, node_sums
from ..ops.split import BestSplit, SplitParams, calc_weight, evaluate_splits

_EPS = 1e-6


@dataclasses.dataclass
class TreeState:
    """Device-side tree under construction (heap layout, max_nodes slots)."""

    pos: torch.Tensor  # (R_pad,) int32 node id per row, -1 = padded
    alive: torch.Tensor  # (max_nodes,) bool candidate for expansion
    totals: torch.Tensor  # (max_nodes, 2) f32 node (G, H)
    feat: torch.Tensor  # (max_nodes,) int64 split feature, -1 for leaf
    sbin: torch.Tensor  # (max_nodes,) int64 split bin (left = bins <= sbin)
    thr: torch.Tensor  # (max_nodes,) f32 raw split condition cuts[f][sbin]
    dleft: torch.Tensor  # (max_nodes,) bool default direction for missing
    is_leaf: torch.Tensor  # (max_nodes,) bool
    leaf_val: torch.Tensor  # (max_nodes,) f32 eta-scaled leaf weight
    gain: torch.Tensor  # (max_nodes,) f32 loss_chg of the split
    base_weight: torch.Tensor  # (max_nodes,) f32 raw node weight
    sum_hess: torch.Tensor  # (max_nodes,) f32


def max_nodes_for_depth(max_depth: int) -> int:
    return (1 << (max_depth + 1)) - 1


def init_tree_state(gpair, valid, *, max_nodes: int) -> TreeState:
    """All valid rows at the root; root totals summed."""
    dev = gpair.device
    pos = torch.where(valid, 0, -1).to(torch.int32)
    totals = torch.zeros((max_nodes, 2), dtype=torch.float32, device=dev)
    totals[0] = node_sums(gpair, pos, node0=0, n_nodes=1)[0]
    alive = torch.zeros(max_nodes, dtype=torch.bool, device=dev)
    alive[0] = True

    def zeros(dtype):
        return torch.zeros(max_nodes, dtype=dtype, device=dev)

    return TreeState(
        pos=pos, alive=alive, totals=totals,
        feat=torch.full((max_nodes,), -1, dtype=torch.int64, device=dev),
        sbin=zeros(torch.int64), thr=zeros(torch.float32),
        dleft=torch.ones(max_nodes, dtype=torch.bool, device=dev),
        is_leaf=zeros(torch.bool), leaf_val=zeros(torch.float32),
        gain=zeros(torch.float32), base_weight=zeros(torch.float32),
        sum_hess=zeros(torch.float32))


def _record_level(st: TreeState, best: BestSplit, sl: slice, can_split,
                  new_leaf, w, thr_lvl, totals_lvl, params: SplitParams):
    """Write one level's split decisions into the tree arrays, in place."""
    st.feat[sl] = torch.where(can_split, best.feature, -1)
    st.sbin[sl] = torch.where(can_split, best.bin, 0)
    st.thr[sl] = torch.where(can_split, thr_lvl, 0.0)
    st.dleft[sl] = best.default_left
    st.is_leaf[sl] = new_leaf
    st.leaf_val[sl] = torch.where(new_leaf, params.eta * w, 0.0)
    st.gain[sl] = torch.where(can_split, best.gain, 0.0)
    st.base_weight[sl] = w
    st.sum_hess[sl] = totals_lvl[:, 1]
    # children of level slots node0..node0+N-1 are 2*node0+1 .. 2*node0+2N,
    # left at odd and right at even heap ids
    ch = slice(2 * sl.start + 1, 2 * sl.stop + 1)
    st.alive[ch] = can_split.repeat_interleave(2)
    st.totals[ch] = torch.stack([best.left_sum, best.right_sum],
                                dim=1).reshape(-1, 2)


def _update_positions(bins, pos, best: BestSplit, can_split, node0: int,
                      N: int, B: int):
    """Route rows of splitting nodes to their children."""
    local = pos.long() - node0
    in_lvl = (local >= 0) & (local < N)
    lc = local.clamp(0, N - 1)
    fr = best.feature[lc].clamp(0, bins.shape[1] - 1)
    binval = bins.gather(1, fr[:, None])[:, 0].long()
    goleft = torch.where(binval >= B, best.default_left[lc],
                         binval <= best.bin[lc])  # sentinel B = missing
    child = 2 * pos + 1 + (~goleft).to(torch.int32)
    return torch.where(in_lvl & can_split[lc], child, pos)


def level_step(state: TreeState, bins, gpair, cuts_pad, n_bins,
               hist_prev=None, *, depth: int, params: SplitParams,
               last_level: bool, subtract: bool = False):
    """Expand every alive node at ``depth``: hist -> best split -> apply.

    Returns ``(state, hist)``; ``hist`` (N, F, B, 2) feeds the next level's
    subtraction (with ``subtract=True`` only left children are built and
    each right sibling is ``parent - left``).  ``hist`` is None on the last
    level, which builds no histogram.
    """
    node0 = (1 << depth) - 1
    N = 1 << depth
    B = cuts_pad.shape[1]
    sl = slice(node0, node0 + N)
    totals_lvl = state.totals[sl]
    alive_lvl = state.alive[sl]
    w = calc_weight(totals_lvl[:, 0], totals_lvl[:, 1], params)

    if last_level:  # every surviving node becomes a leaf
        state.is_leaf[sl] = alive_lvl
        state.leaf_val[sl] = torch.where(alive_lvl, params.eta * w, 0.0)
        state.base_weight[sl] = w
        state.sum_hess[sl] = totals_lvl[:, 1]
        return state, None

    if subtract:
        left = build_histogram(bins, gpair, state.pos, node0=node0,
                               n_nodes=N // 2, n_bin=B, stride=2)
        hist = combine_sibling_hists(left, hist_prev, alive_lvl)
    else:
        hist = build_histogram(bins, gpair, state.pos, node0=node0,
                               n_nodes=N, n_bin=B)
    best = evaluate_splits(hist, totals_lvl, n_bins, params)
    can_split = alive_lvl & (best.gain > max(params.gamma, _EPS))
    new_leaf = alive_lvl & ~can_split
    thr_lvl = cuts_pad[best.feature, best.bin.clamp(max=B - 1)]
    _record_level(state, best, sl, can_split, new_leaf, w, thr_lvl,
                  totals_lvl, params)
    state.pos = _update_positions(bins, state.pos, best, can_split, node0, N,
                                  B)
    return state, hist


def leaf_margin_delta(pos, leaf_val):
    """Per-row margin update from the finished tree: every row sits on its
    leaf already (reference: TreeUpdater::UpdatePredictionCache)."""
    safe = pos.long().clamp(0, leaf_val.shape[0] - 1)
    return torch.where(pos >= 0, leaf_val[safe], 0.0)


class GrownTree(NamedTuple):
    """Host copy of a finished tree (heap layout)."""

    feat: np.ndarray
    sbin: np.ndarray
    thr: np.ndarray
    dleft: np.ndarray
    is_leaf: np.ndarray
    leaf_val: np.ndarray
    gain: np.ndarray
    base_weight: np.ndarray
    sum_hess: np.ndarray


class HistTreeGrower:
    """Host loop over the per-depth level steps (reference:
    GPUHistMaker::Update, src/tree/updater_gpu_hist.cu:703)."""

    def __init__(self, max_depth: int, params: SplitParams) -> None:
        self.max_depth = max_depth
        self.params = params
        self.max_nodes = max_nodes_for_depth(max_depth)

    def grow(self, bins, gpair, valid, cuts_pad, n_bins) -> TreeState:
        """bins (R_pad, F), gpair (R_pad, 2) f32, valid (R_pad,) bool."""
        state = init_tree_state(gpair, valid, max_nodes=self.max_nodes)
        hist: Optional[torch.Tensor] = None
        for d in range(self.max_depth + 1):
            state, hist = level_step(
                state, bins, gpair, cuts_pad, n_bins, hist, depth=d,
                params=self.params, last_level=(d == self.max_depth),
                subtract=hist is not None)
        return state

    @staticmethod
    def to_host(state: TreeState) -> GrownTree:
        return GrownTree(**{f: getattr(state, f).cpu().numpy()
                            for f in GrownTree._fields})
