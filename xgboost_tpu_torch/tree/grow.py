"""Depthwise hist tree growing (port of the per-depth path of
xgboost_tpu/tree/grow.py; reference src/tree/updater_gpu_hist.cu:617).

The tree grows level by level over a heap-indexed node array (node i ->
children 2i+1, 2i+2).  One ``level_step`` per depth builds the histogram
(left children only below the root, right siblings by subtraction), picks
the best split per node under the feature mask, interaction sets and
monotone bounds, spends the ``max_leaves`` budget in node order, records
the splits and routes rows to their children by rewriting ``pos`` (the
RowPartitioner analogue, without a physical partition).

With ``quantised=True`` (``deterministic_histogram=1``) the gradients are
int8 limbs (ops/quantise.py), the histograms exact int32 limb sums (K2 on
the card), the sibling subtraction runs on the limbs, and ``dequantise`` is
the one rounding step before the split scan, so the trees do not depend on
the order of any sum.

With categorical features (``cat_mask``) the split scan is the categorical
one (ops/split.py) and a categorical split routes a row by its bin's
membership in the node's ``cat_set``: in the set goes right, the missing
sentinel takes the default direction (common/categorical.h Decision).

Everything in the level loop stays on the device: no value is read back to
the host until the finished tree is copied out.  The state's tensors are
updated in place, level after level.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.hist_cuda import build_histogram, build_histogram_q
from ..ops.histogram import combine_sibling_hists, node_sums
from ..ops.quantise import dequantise_parts, prepare_quantised
from ..ops.split import (BestSplit, SplitParams, calc_weight,
                         evaluate_splits, is_monotone, monotone_vec)

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
    lower: torch.Tensor  # (max_nodes,) f32 monotone weight lower bound
    upper: torch.Tensor  # (max_nodes,) f32 monotone weight upper bound
    setcompat: torch.Tensor  # (max_nodes, n_sets) bool interaction sets alive
    splits_left: torch.Tensor  # (1,) int32 remaining split budget
    # categorical splits (None without categorical features)
    is_cat: Optional[torch.Tensor] = None  # (max_nodes,) bool
    cat_set: Optional[torch.Tensor] = None  # (max_nodes, B) bool, go right


def max_nodes_for_depth(max_depth: int) -> int:
    return (1 << (max_depth + 1)) - 1


def make_set_matrix(interaction_sets, n_features: int) -> np.ndarray:
    """(n_sets, F) bool membership matrix; unlisted features become
    singleton sets (they cannot interact with listed ones).  None -> one
    all-True set (no constraint)."""
    if not interaction_sets:
        return np.ones((1, n_features), dtype=bool)
    listed = set()
    rows = []
    for grp in interaction_sets:
        row = np.zeros(n_features, dtype=bool)
        for f in grp:
            row[f] = True
            listed.add(int(f))
        rows.append(row)
    for f in range(n_features):
        if f not in listed:
            row = np.zeros(n_features, dtype=bool)
            row[f] = True
            rows.append(row)
    return np.stack(rows)


def init_tree_state(gpair, valid, *, max_nodes: int, n_sets: int = 1,
                    max_splits: int = 0, n_cat_bin: int = 0) -> TreeState:
    """All valid rows at the root; root totals summed.  ``max_splits``: the
    split budget (max_leaves - 1), 0 = unlimited.  ``n_cat_bin``: B for the
    categorical split arrays, 0 without categorical features."""
    dev = gpair.device
    pos = torch.where(valid, 0, -1).to(torch.int32)
    totals = torch.zeros((max_nodes, 2), dtype=torch.float32, device=dev)
    totals[0] = node_sums(gpair, pos, node0=0, n_nodes=1)[0]
    alive = torch.zeros(max_nodes, dtype=torch.bool, device=dev)
    alive[0] = True
    budget = max_splits if max_splits > 0 else torch.iinfo(torch.int32).max

    def zeros(dtype):
        return torch.zeros(max_nodes, dtype=dtype, device=dev)

    def full(v):
        return torch.full((max_nodes,), v, dtype=torch.float32, device=dev)

    return TreeState(
        pos=pos, alive=alive, totals=totals,
        feat=torch.full((max_nodes,), -1, dtype=torch.int64, device=dev),
        sbin=zeros(torch.int64), thr=zeros(torch.float32),
        dleft=torch.ones(max_nodes, dtype=torch.bool, device=dev),
        is_leaf=zeros(torch.bool), leaf_val=zeros(torch.float32),
        gain=zeros(torch.float32), base_weight=zeros(torch.float32),
        sum_hess=zeros(torch.float32), lower=full(-torch.inf),
        upper=full(torch.inf),
        setcompat=torch.ones((max_nodes, n_sets), dtype=torch.bool,
                             device=dev),
        splits_left=torch.full((1,), budget, dtype=torch.int32, device=dev),
        is_cat=zeros(torch.bool) if n_cat_bin else None,
        cat_set=(torch.zeros((max_nodes, n_cat_bin), dtype=torch.bool,
                             device=dev) if n_cat_bin else None))


def _children(left, right):
    """Interleave per-node (N, ...) left and right values to the children's
    heap order (left at odd, right at even ids)."""
    return torch.stack([left, right], dim=1).reshape(-1, *left.shape[1:])


def _record_level(st: TreeState, best: BestSplit, sl: slice, can_split,
                  new_leaf, w, thr_lvl, totals_lvl, compat_lvl, member,
                  new_budget, lower_lvl, upper_lvl, params: SplitParams):
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
    if st.is_cat is not None:
        st.is_cat[sl] = can_split & best.is_cat
        st.cat_set[sl] = best.cat_set & can_split[:, None]
    # children of level slots node0..node0+N-1 are 2*node0+1 .. 2*node0+2N
    ch = slice(2 * sl.start + 1, 2 * sl.stop + 1)
    st.alive[ch] = _children(can_split, can_split)
    st.totals[ch] = _children(best.left_sum, best.right_sum)
    if new_budget is not None:
        st.splits_left.copy_(new_budget.reshape(1))
    if member is not None:
        child_compat = compat_lvl & member
        st.setcompat[ch] = _children(child_compat, child_compat)
    if params.monotone is not None and any(c != 0 for c in params.monotone):
        # bounds propagation: mid = (wL + wR) / 2 splits the feasible
        # interval (reference: constraints.cc ValueConstraint::SetChild)
        cvec = monotone_vec(params.monotone, w.device)
        c_at = cvec[best.feature.clamp(0, len(params.monotone) - 1)]
        mid = 0.5 * (best.left_weight + best.right_weight)
        st.lower[ch] = _children(torch.where(c_at < 0, mid, lower_lvl),
                                 torch.where(c_at > 0, mid, lower_lvl))
        st.upper[ch] = _children(torch.where(c_at > 0, mid, upper_lvl),
                                 torch.where(c_at < 0, mid, upper_lvl))


def _update_positions(bins, pos, best: BestSplit, can_split, node0: int,
                      N: int, B: int, has_cat: bool = False):
    """Route rows of splitting nodes to their children: a numeric split
    by bin <= the split bin, a categorical one by the bin not being in the
    node's set."""
    local = pos.long() - node0
    in_lvl = (local >= 0) & (local < N)
    lc = local.clamp(0, N - 1)
    fr = best.feature[lc].clamp(0, bins.shape[1] - 1)
    binval = bins.gather(1, fr[:, None])[:, 0].long()
    goleft_split = binval <= best.bin[lc]
    if has_cat:
        member = best.cat_set.reshape(-1)[lc * B + binval.clamp(0, B - 1)]
        goleft_split = torch.where(best.is_cat[lc], ~member, goleft_split)
    goleft = torch.where(binval >= B, best.default_left[lc],
                         goleft_split)  # sentinel B = missing
    child = 2 * pos + 1 + (~goleft).to(torch.int32)
    return torch.where(in_lvl & can_split[lc], child, pos)


def decide_level(state: TreeState, hist, cuts_pad, n_bins,
                 feature_mask=None, set_matrix=None, rho=None,
                 cat_mask=None, *, depth: int, params: SplitParams,
                 last_level: bool, budget: bool = False,
                 lossguide: bool = False, fused_dequantise: bool = True):
    """Decide the nodes at ``depth`` from their histogram ``hist``: the
    best split under the feature mask, interaction sets and monotone
    bounds, the ``max_leaves`` budget, and the level's records written
    into ``state`` in place; the rows are not routed (``level_step`` and
    the streaming grower route them).  Returns ``(best, can_split)``, both
    None on the last level, where every surviving node becomes a leaf.

    ``hist`` is the level's f32 histogram, or its int32 limbs with
    ``rho`` (C,) under deterministic_histogram.  ``budget`` spends
    ``state.splits_left`` in node order, or in order of gain with
    ``lossguide`` (the reference's level-wise lossguide,
    tree/stream.py:_decide_level).  ``fused_dequantise``: with categorical
    features the split scan takes the dequantisation's factors, as the
    reference's compiled in-core level fuses them into its one-hot sums;
    False takes the dequantised histogram, as its streaming grower does."""
    node0 = (1 << depth) - 1
    N = 1 << depth
    B = cuts_pad.shape[1]
    sl = slice(node0, node0 + N)
    totals_lvl = state.totals[sl]
    alive_lvl = state.alive[sl]
    lower_lvl = state.lower[sl]
    upper_lvl = state.upper[sl]
    w = calc_weight(totals_lvl[:, 0], totals_lvl[:, 1], params, lower_lvl,
                    upper_lvl)

    if last_level:  # every surviving node becomes a leaf
        state.is_leaf[sl] = alive_lvl
        state.leaf_val[sl] = torch.where(alive_lvl, params.eta * w, 0.0)
        state.base_weight[sl] = w
        state.sum_hess[sl] = totals_lvl[:, 1]
        return None, None

    hist_eval, dq = hist, None
    if rho is not None:
        comb, scale = dequantise_parts(hist, rho)
        hist_eval = comb * scale
        if cat_mask is not None and fused_dequantise:
            dq = (comb, scale)

    fmask, compat_lvl, member = feature_mask, None, None
    if set_matrix is not None:
        # interaction constraints: a node may split on the union of the
        # sets still compatible with its path (constraints.cc
        # FeatureInteractionConstraint)
        compat_lvl = state.setcompat[sl]
        allowed = (compat_lvl[:, :, None] & set_matrix[None, :, :]).any(dim=1)
        fmask = allowed if fmask is None else allowed & fmask
    # the node bounds are read by the monotone scan only
    bounds = (torch.stack([lower_lvl, upper_lvl], dim=1)
              if is_monotone(params) else None)
    best = evaluate_splits(hist_eval, totals_lvl, n_bins, params, fmask,
                           bounds, cat_mask, dq)
    can_split = alive_lvl & (best.gain > max(params.gamma, _EPS))

    new_budget = None
    if budget:  # max_leaves, spent in node order (or by gain) in a level
        idx = torch.arange(node0, node0 + N, device=w.device)
        splits_left = state.splits_left[0]
        prio = torch.where(can_split,
                           best.gain if lossguide else -idx.to(torch.float32),
                           -torch.inf)
        ranks = torch.argsort(torch.argsort(-prio, stable=True), stable=True)
        can_split = can_split & (ranks < splits_left)
        new_budget = splits_left - can_split.sum().to(torch.int32)

    new_leaf = alive_lvl & ~can_split
    thr_lvl = cuts_pad[best.feature, best.bin.clamp(max=B - 1)]
    if set_matrix is not None:
        member = set_matrix.T[best.feature.clamp(0, set_matrix.shape[1] - 1)]
    _record_level(state, best, sl, can_split, new_leaf, w, thr_lvl,
                  totals_lvl, compat_lvl, member, new_budget, lower_lvl,
                  upper_lvl, params)
    return best, can_split


def level_step(state: TreeState, bins, gpair, cuts_pad, n_bins,
               feature_mask=None, set_matrix=None, hist_prev=None, rho=None,
               cat_mask=None,
               *, depth: int, params: SplitParams, last_level: bool,
               subtract: bool = False, quantised: bool = False,
               budget: bool = False):
    """Expand every alive node at ``depth``: hist -> best split -> apply.

    ``feature_mask`` (1|N, F) bool (column sampling) and ``set_matrix``
    (n_sets, F) bool (interaction sets) restrict each node's candidate
    features; None means no restriction.  ``cat_mask`` (F,) bool on the
    device marks the categorical features.  ``budget`` spends
    ``state.splits_left`` (max_leaves).  With ``quantised`` ``gpair`` is the
    (R, C, 3) int8 limb array and ``rho`` its (C,) scale.

    Returns ``(state, hist)``; ``hist`` (N, F, B, 2) f32, or (N, F, B, 2, 3)
    int32 limbs when quantised, feeds the next level's subtraction (with
    ``subtract=True`` only left children are built and each right sibling
    is ``parent - left``).  ``hist`` is None on the last level, which
    builds no histogram.
    """
    node0 = (1 << depth) - 1
    N = 1 << depth
    B = cuts_pad.shape[1]
    hist = None
    if not last_level:
        build = build_histogram_q if quantised else build_histogram
        if subtract:
            left = build(bins, gpair, state.pos, node0=node0,
                         n_nodes=N // 2, n_bin=B, stride=2)
            hist = combine_sibling_hists(left, hist_prev,
                                         state.alive[node0: node0 + N])
        else:
            hist = build(bins, gpair, state.pos, node0=node0, n_nodes=N,
                         n_bin=B)
    best, can_split = decide_level(
        state, hist, cuts_pad, n_bins, feature_mask, set_matrix,
        rho if quantised else None, cat_mask, depth=depth, params=params,
        last_level=last_level, budget=budget)
    if not last_level:
        state.pos = _update_positions(bins, state.pos, best, can_split,
                                      node0, N, B, cat_mask is not None)
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
    is_cat: Optional[np.ndarray] = None
    cat_set: Optional[np.ndarray] = None


# (depth, n_nodes) -> (1|n_nodes, F) bool: the column sampler's per-level
# hook (Booster._feature_masks)
FeatureMasks = Callable[[int, int], torch.Tensor]


class HistTreeGrower:
    """Host loop over the per-depth level steps (reference:
    GPUHistMaker::Update, src/tree/updater_gpu_hist.cu:703)."""

    def __init__(self, max_depth: int, params: SplitParams, *,
                 interaction_sets=None, max_leaves: int = 0,
                 quantised: bool = False) -> None:
        self.max_depth = max_depth
        self.params = params
        self.interaction_sets = interaction_sets
        self.max_leaves = max_leaves
        # exact limb histograms: trees independent of summation order
        # (deterministic_histogram, ops/quantise.py)
        self.quantised = quantised
        self.max_nodes = max_nodes_for_depth(max_depth)
        self._setmat = {}  # (n_features, device) -> set matrix there
        self._catmask = {}  # (mask bytes, device) -> cat mask there

    def _set_matrix(self, n_features: int, device):
        """The interaction sets on ``device``, made once; None without
        constraints."""
        if not self.interaction_sets:
            return None
        key = (n_features, device)
        if key not in self._setmat:
            self._setmat[key] = torch.from_numpy(make_set_matrix(
                self.interaction_sets, n_features)).to(device)
        return self._setmat[key]

    def _cat_mask(self, cat_mask, device):
        """The (F,) categorical mask on ``device``, made once; None without
        categorical features."""
        if cat_mask is None or not np.any(cat_mask):
            return None
        cm = np.asarray(cat_mask, bool)
        key = (cm.tobytes(), device)
        if key not in self._catmask:
            self._catmask[key] = torch.from_numpy(cm).to(device)
        return self._catmask[key]

    def grow(self, bins, gpair, valid, cuts_pad, n_bins,
             feature_masks: Optional[FeatureMasks] = None,
             cat_mask=None) -> TreeState:
        """bins (R_pad, F), gpair (R_pad, 2) f32, valid (R_pad,) bool;
        ``cat_mask`` (F,) numpy bool of the categorical features or None."""
        setmat = self._set_matrix(bins.shape[1], bins.device)
        cm = self._cat_mask(cat_mask, bins.device)
        state = init_tree_state(
            gpair, valid, max_nodes=self.max_nodes,
            n_sets=1 if setmat is None else setmat.shape[0],
            max_splits=self.max_leaves - 1 if self.max_leaves > 0 else 0,
            n_cat_bin=0 if cm is None else cuts_pad.shape[1])
        rho = None
        if self.quantised:
            gpair, rho, state = prepare_quantised(gpair, valid, state)
        hist: Optional[torch.Tensor] = None
        for d in range(self.max_depth + 1):
            last = d == self.max_depth
            # the last level splits nothing and takes no mask, but it draws
            # one as the reference does: the K class trees of a round share
            # one sampler, so the next tree's draws continue after it
            fm = None if feature_masks is None else feature_masks(d, 1 << d)
            if last:
                fm = None
            state, hist = level_step(
                state, bins, gpair, cuts_pad, n_bins, fm, setmat, hist, rho,
                cm, depth=d, params=self.params, last_level=last,
                subtract=hist is not None, quantised=self.quantised,
                budget=self.max_leaves > 0)
        return state

    @staticmethod
    def to_host(state: TreeState) -> GrownTree:
        return GrownTree(**{f: getattr(state, f).cpu().numpy()
                            for f in GrownTree._fields
                            if getattr(state, f) is not None})
