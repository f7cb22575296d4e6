"""Vector-leaf (multi-target) tree growing, ``multi_strategy=
"multi_output_tree"`` (port of xgboost_tpu/tree/grow_multi.py; reference
include/xgboost/multi_target_tree_model.h, src/tree/gpu_hist/
multi_evaluate_splits.cu).

One tree carries all K targets: each level's histogram has 2K channels
over one ``pos`` (the plain version a 2K-channel ``build_histogram``, one
launch of K1's class axis on the card), the split is chosen by the sum of
the per-target gains (ops/split.py ``evaluate_splits_multi``), and every
leaf stores a K-vector.  The level loop is the scalar grower's: heap
layout, right siblings by subtraction, the ``max_leaves`` budget spent by
gain under lossguide and in node order otherwise (level-synchronous in
both, as the reference grows it), rows routed by the scalar grower's
``_update_positions``.  The state's tensors are updated in place and stay
on the device until the finished tree is copied out.

With ``distributed=True`` the rows are sharded over ranks: the root's
totals and each level's built histogram are summed over the ranks before
the subtraction (reference grow_multi.py:252-302, the AllReduceHist of
updater_quantile_hist.cc:156).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.hist_cuda import build_level_hist_multi
from ..ops.histogram import combine_sibling_hists, node_sums
from ..ops.split import (SplitParams, calc_weight, evaluate_splits_multi,
                         mean_last_f32)
from .grow import (FeatureMasks, _children, _update_positions,
                   max_nodes_for_depth, sync_root_totals)

_EPS = 1e-6


@dataclasses.dataclass
class MultiTreeState:
    """Device-side vector-leaf tree under construction (heap layout)."""

    pos: torch.Tensor  # (R_pad,) int32 node id per row, -1 = padded
    alive: torch.Tensor  # (max_nodes,) bool
    totals: torch.Tensor  # (max_nodes, K, 2) f32 per-target (G, H)
    feat: torch.Tensor  # (max_nodes,) int64, -1 for leaf
    sbin: torch.Tensor  # (max_nodes,) int64
    thr: torch.Tensor  # (max_nodes,) f32
    dleft: torch.Tensor  # (max_nodes,) bool
    is_leaf: torch.Tensor  # (max_nodes,) bool
    leaf_val: torch.Tensor  # (max_nodes, K) eta-scaled leaf vector
    gain: torch.Tensor  # (max_nodes,) f32
    base_weight: torch.Tensor  # (max_nodes, K) raw node weights
    sum_hess: torch.Tensor  # (max_nodes,) mean per-target hessian
    splits_left: torch.Tensor  # (1,) int32


def init_multi_state(gpair, valid, *, max_nodes: int,
                     max_splits: int = 0) -> MultiTreeState:
    """gpair (R_pad, K, 2); all valid rows at the root."""
    R, K = gpair.shape[0], gpair.shape[1]
    dev = gpair.device
    pos = torch.where(valid, 0, -1).to(torch.int32)
    totals = torch.zeros((max_nodes, K, 2), dtype=torch.float32, device=dev)
    totals[0] = node_sums(gpair.reshape(R, 2 * K), pos, node0=0,
                          n_nodes=1)[0].reshape(K, 2)
    alive = torch.zeros(max_nodes, dtype=torch.bool, device=dev)
    alive[0] = True
    budget = max_splits if max_splits > 0 else torch.iinfo(torch.int32).max

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((max_nodes, *shape), dtype=dtype, device=dev)

    return MultiTreeState(
        pos=pos, alive=alive, totals=totals,
        feat=torch.full((max_nodes,), -1, dtype=torch.int64, device=dev),
        sbin=zeros(dtype=torch.int64), thr=zeros(),
        dleft=torch.ones(max_nodes, dtype=torch.bool, device=dev),
        is_leaf=zeros(dtype=torch.bool), leaf_val=zeros(K), gain=zeros(),
        base_weight=zeros(K), sum_hess=zeros(),
        splits_left=torch.full((1,), budget, dtype=torch.int32, device=dev))


def _finalize_leaves_multi(st: MultiTreeState, params: SplitParams,
                           sl: slice) -> None:
    """Last level: every surviving node becomes a leaf."""
    totals_lvl, alive_lvl = st.totals[sl], st.alive[sl]
    w = calc_weight(totals_lvl[..., 0], totals_lvl[..., 1], params)
    st.is_leaf[sl] = alive_lvl
    st.leaf_val[sl] = torch.where(alive_lvl[:, None], params.eta * w, 0.0)
    st.base_weight[sl] = w
    st.sum_hess[sl] = mean_last_f32(totals_lvl[..., 1])


def _decide_body(st: MultiTreeState, hist, bins, cuts_pad, n_bins,
                 feature_mask, *, depth: int, params: SplitParams,
                 lossguide: bool, budget: bool) -> None:
    """Evaluate, record and route one level from its final (N, F, B, K, 2)
    histogram, in place (reference grow_multi.py:98-161)."""
    node0 = (1 << depth) - 1
    N = 1 << depth
    B = cuts_pad.shape[1]
    sl = slice(node0, node0 + N)
    totals_lvl, alive_lvl = st.totals[sl], st.alive[sl]
    w = calc_weight(totals_lvl[..., 0], totals_lvl[..., 1], params)  # (N, K)
    best = evaluate_splits_multi(hist, totals_lvl, n_bins, params,
                                 feature_mask)
    can_split = alive_lvl & (best.gain > max(params.gamma, _EPS))
    if budget:
        # max_leaves: by gain under lossguide, in node order otherwise
        # (driver.h); ranks of a stable sort, as jnp.argsort's
        idx = torch.arange(node0, node0 + N, device=w.device)
        prio = best.gain if lossguide else -idx.to(torch.float32)
        prio = torch.where(can_split, prio, -torch.inf)
        ranks = torch.argsort(torch.argsort(-prio, stable=True), stable=True)
        splits_left = st.splits_left[0]
        can_split = can_split & (ranks < splits_left)
        st.splits_left.copy_((splits_left - can_split.sum().to(torch.int32))
                             .reshape(1))
    new_leaf = alive_lvl & ~can_split
    st.feat[sl] = torch.where(can_split, best.feature, -1)
    st.sbin[sl] = torch.where(can_split, best.bin, 0)
    st.thr[sl] = torch.where(
        can_split, cuts_pad[best.feature, best.bin.clamp(max=B - 1)], 0.0)
    st.dleft[sl] = best.default_left
    st.is_leaf[sl] = new_leaf
    st.leaf_val[sl] = torch.where(new_leaf[:, None], params.eta * w, 0.0)
    st.gain[sl] = torch.where(can_split, best.gain, 0.0)
    st.base_weight[sl] = w
    st.sum_hess[sl] = mean_last_f32(totals_lvl[..., 1])
    ch = slice(2 * node0 + 1, 2 * (node0 + N) + 1)
    st.alive[ch] = _children(can_split, can_split)
    st.totals[ch] = _children(best.left_sum, best.right_sum)
    st.pos = _update_positions(bins, st.pos, best, can_split, node0, N, B)


def level_step_multi(st: MultiTreeState, bins, gpair, cuts_pad, n_bins,
                     feature_mask=None, hist_prev=None, *, depth: int,
                     params: SplitParams, last_level: bool,
                     subtract: bool = False, lossguide: bool = False,
                     budget: bool = False, reduce=None):
    """One level: 2K-channel histogram -> summed-gain split -> apply.
    Returns (state, hist), hist (N, F, B, K, 2) for the next level's
    subtraction (right sibling = parent - left); None on the last level.
    ``reduce``: applied to the built histogram before the subtraction
    (the sum over the ranks)."""
    if reduce is None:
        def reduce(h):
            return h
    node0 = (1 << depth) - 1
    N = 1 << depth
    B = cuts_pad.shape[1]
    if last_level:
        _finalize_leaves_multi(st, params, slice(node0, node0 + N))
        return st, None
    if subtract:
        left = reduce(build_level_hist_multi(bins, gpair, st.pos,
                                             node0=node0, n_nodes=N // 2,
                                             n_bin=B, stride=2))
        hist = combine_sibling_hists(left, hist_prev,
                                     st.alive[node0:node0 + N])
    else:
        hist = reduce(build_level_hist_multi(bins, gpair, st.pos,
                                             node0=node0, n_nodes=N,
                                             n_bin=B))
    _decide_body(st, hist, bins, cuts_pad, n_bins, feature_mask, depth=depth,
                 params=params, lossguide=lossguide, budget=budget)
    return st, hist


def leaf_margin_delta_multi(pos, leaf_val):
    """(R_pad, K) margin update: every row adds its leaf's vector."""
    safe = pos.long().clamp(0, leaf_val.shape[0] - 1)
    return torch.where((pos >= 0)[:, None], leaf_val[safe], 0.0)


class GrownMultiTree(NamedTuple):
    """Host copy of a finished vector-leaf tree (heap layout)."""

    feat: np.ndarray
    sbin: np.ndarray
    thr: np.ndarray
    dleft: np.ndarray
    is_leaf: np.ndarray
    leaf_val: np.ndarray  # (max_nodes, K)
    gain: np.ndarray
    base_weight: np.ndarray  # (max_nodes, K)
    sum_hess: np.ndarray
    totals: np.ndarray


class MultiTargetTreeGrower:
    """Host loop over the vector-leaf level steps (reference
    grow_multi.py:198-307); ``distributed``: rows sharded over ranks."""

    def __init__(self, max_depth: int, params: SplitParams, n_targets: int,
                 *, max_leaves: int = 0, lossguide: bool = False,
                 distributed: bool = False) -> None:
        self.max_depth = max_depth
        self.params = params
        self.n_targets = n_targets
        self.max_leaves = max_leaves
        self.lossguide = lossguide
        self.max_nodes = max_nodes_for_depth(max_depth)
        self.exchange = None
        if distributed:
            from ..parallel.process import HostExchange

            self.exchange = HostExchange()

    def grow(self, bins, gpair, valid, cuts_pad, n_bins,
             feature_masks: Optional[FeatureMasks] = None) -> MultiTreeState:
        """bins (R_pad, F), gpair (R_pad, K, 2) f32, valid (R_pad,)."""
        state = init_multi_state(
            gpair, valid, max_nodes=self.max_nodes,
            max_splits=self.max_leaves - 1 if self.max_leaves > 0 else 0)
        reduce = None
        if self.exchange is not None:
            sync_root_totals(state)
            reduce = self.exchange.allreduce
        hist = None
        for d in range(self.max_depth + 1):
            # the last level draws its mask too, as the reference does
            fm = None if feature_masks is None else feature_masks(d, 1 << d)
            state, hist = level_step_multi(
                state, bins, gpair, cuts_pad, n_bins, fm, hist, depth=d,
                params=self.params, last_level=d == self.max_depth,
                subtract=hist is not None, lossguide=self.lossguide,
                budget=self.max_leaves > 0, reduce=reduce)
        return state

    @staticmethod
    def to_host(state: MultiTreeState) -> GrownMultiTree:
        return GrownMultiTree(**{f: getattr(state, f).cpu().numpy()
                                 for f in GrownMultiTree._fields})
