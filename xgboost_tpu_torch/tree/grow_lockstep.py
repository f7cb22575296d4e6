"""Class-batched (lockstep) depthwise growing of the K class trees of one
multi:softprob / multi:softmax round (port of
xgboost_tpu/tree/grow_lockstep.py, the reference's opt-in ``_lockstep=1``).

The K independent trees advance level by level together: one histogram
call builds all K class histograms (K1's class axis on the card, one
launch a level; K calls of the plain version on the CPU), one split scan
scores all K x N nodes of the level (one K3 launch on the card), and one
rewrite routes all K ``pos`` arrays.  Each class's histogram, scan and
routing are the sequential grower's arithmetic on the same inputs, so on
the CPU the trees are bitwise the sequential loop's
(tests/test_torch_lockstep.py); on the card K1's f32 atomics add in no
fixed order, as in the sequential loop.

State: tree/grow.py's TreeState with a leading K axis (pos (K, R), node
arrays (K, max_nodes, ...), splits_left (K,)).  Numeric features, f32
histograms, one device, no column sampling: core.py's gate sends every
other case to the sequential loop, as the reference's does.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.hist_cuda import build_histogram_multi
from ..ops.histogram import combine_sibling_hists, node_sums
from ..ops.split import (SplitParams, calc_weight, evaluate_splits,
                         is_monotone, monotone_vec)
from .grow import GrownTree, TreeState, make_set_matrix, max_nodes_for_depth

_EPS = 1e-6


def init_lockstep_state(gpair, valid, *, max_nodes: int, n_sets: int = 1,
                        max_splits: int = 0) -> TreeState:
    """Fresh K-tree state from gpair (R_pad, K, 2): all rows at every
    class's root.  The root totals are each class's ``node_sums``, as the
    sequential grower sums them, so they carry its bits."""
    R, K, _ = gpair.shape
    dev = gpair.device
    pos_row = torch.where(valid, 0, -1).to(torch.int32)
    totals = torch.zeros((K, max_nodes, 2), dtype=torch.float32, device=dev)
    for k in range(K):
        totals[k, 0] = node_sums(gpair[:, k].contiguous(), pos_row, node0=0,
                                 n_nodes=1)[0]
    alive = torch.zeros((K, max_nodes), dtype=torch.bool, device=dev)
    alive[:, 0] = True
    budget = max_splits if max_splits > 0 else torch.iinfo(torch.int32).max

    def zeros(dtype=torch.float32):
        return torch.zeros((K, max_nodes), dtype=dtype, device=dev)

    def full(v, dtype=torch.float32):
        return torch.full((K, max_nodes), v, dtype=dtype, device=dev)

    return TreeState(
        pos=pos_row.expand(K, R).contiguous(), alive=alive, totals=totals,
        feat=full(-1, torch.int64), sbin=zeros(torch.int64), thr=zeros(),
        dleft=full(True, torch.bool), is_leaf=zeros(torch.bool),
        leaf_val=zeros(), gain=zeros(), base_weight=zeros(), sum_hess=zeros(),
        lower=full(-torch.inf), upper=full(torch.inf),
        setcompat=torch.ones((K, max_nodes, n_sets), dtype=torch.bool,
                             device=dev),
        splits_left=torch.full((K,), budget, dtype=torch.int32, device=dev))


def _update_positions_k(bins, pos, feat, sbin, dleft, can_split, node0: int,
                        N: int, B: int):
    """Route the rows of every class's splitting nodes to their children
    (tree/grow.py ``_update_positions`` for numeric splits, over a leading
    class axis): pos (K, R), the level's split arrays (K, N)."""
    local = pos.long() - node0
    in_lvl = (local >= 0) & (local < N)
    lc = local.clamp(0, N - 1)
    fr = feat.gather(1, lc).clamp(0, bins.shape[1] - 1)  # (K, R)
    binval = bins.gather(1, fr.T).T.long()
    goleft = torch.where(binval >= B, dleft.gather(1, lc),
                         binval <= sbin.gather(1, lc))  # sentinel B: missing
    child = 2 * pos + 1 + (~goleft).to(torch.int32)
    return torch.where(in_lvl & can_split.gather(1, lc), child, pos)


def level_step_lockstep(st: TreeState, bins, gpair, cuts_pad, n_bins,
                        set_matrix=None, hist_prev=None, *, depth: int,
                        params: SplitParams, last_level: bool,
                        subtract: bool = False, budget: bool = False):
    """One level of all K trees at once (tree/grow.py ``level_step`` with a
    class axis), in place.  Returns (state, hist), hist (K, N, F, B, 2)
    for the next level's subtraction; None on the last level."""
    node0 = (1 << depth) - 1
    N = 1 << depth
    B = cuts_pad.shape[1]
    K = gpair.shape[1]
    sl = slice(node0, node0 + N)
    totals_lvl = st.totals[:, sl]  # (K, N, 2)
    alive_lvl = st.alive[:, sl]
    lower_lvl, upper_lvl = st.lower[:, sl], st.upper[:, sl]
    w = calc_weight(totals_lvl[..., 0], totals_lvl[..., 1], params,
                    lower_lvl, upper_lvl)
    if last_level:
        st.is_leaf[:, sl] = alive_lvl
        st.leaf_val[:, sl] = torch.where(alive_lvl, params.eta * w, 0.0)
        st.base_weight[:, sl] = w
        st.sum_hess[:, sl] = totals_lvl[..., 1]
        return st, None

    if subtract:  # right sibling = parent - left, per class
        left = build_histogram_multi(bins, gpair, st.pos, node0=node0,
                                     n_nodes=N // 2, n_bin=B, stride=2)
        hist = combine_sibling_hists(
            left.flatten(0, 1), hist_prev.flatten(0, 1),
            alive_lvl.reshape(K * N)).reshape(K, N, *left.shape[2:])
    else:
        hist = build_histogram_multi(bins, gpair, st.pos, node0=node0,
                                     n_nodes=N, n_bin=B)
    F = bins.shape[1]

    fmask = compat_lvl = None
    if set_matrix is not None:  # interaction constraints, per (class, node)
        compat_lvl = st.setcompat[:, sl]
        fmask = (compat_lvl[..., None] & set_matrix[None, None]).any(
            dim=2).reshape(K * N, F)
    bounds = (torch.stack([lower_lvl, upper_lvl], dim=-1).reshape(K * N, 2)
              if is_monotone(params) else None)
    # the level's K x N nodes in one scan (one K3 launch on the card)
    best = evaluate_splits(hist.reshape(K * N, F, B, 2),
                           totals_lvl.reshape(K * N, 2), n_bins, params,
                           fmask, bounds)

    def kn(a):
        return a.reshape(K, N, *a.shape[1:])

    b_gain, b_feat, b_bin = kn(best.gain), kn(best.feature), kn(best.bin)
    b_dleft = kn(best.default_left)
    can_split = alive_lvl & (b_gain > max(params.gamma, _EPS))
    if budget:  # max_leaves, spent in node order per class
        idx = torch.arange(node0, node0 + N, device=w.device)
        prio = torch.where(can_split, -idx.to(torch.float32)[None], -torch.inf)
        ranks = torch.argsort(torch.argsort(-prio, dim=1, stable=True), dim=1,
                              stable=True)
        can_split = can_split & (ranks < st.splits_left[:, None])
        st.splits_left -= can_split.sum(dim=1).to(torch.int32)
    new_leaf = alive_lvl & ~can_split

    st.feat[:, sl] = torch.where(can_split, b_feat, -1)
    st.sbin[:, sl] = torch.where(can_split, b_bin, 0)
    st.thr[:, sl] = torch.where(
        can_split, cuts_pad[b_feat, b_bin.clamp(max=B - 1)], 0.0)
    st.dleft[:, sl] = b_dleft
    st.is_leaf[:, sl] = new_leaf
    st.leaf_val[:, sl] = torch.where(new_leaf, params.eta * w, 0.0)
    st.gain[:, sl] = torch.where(can_split, b_gain, 0.0)
    st.base_weight[:, sl] = w
    st.sum_hess[:, sl] = totals_lvl[..., 1]
    ch = slice(2 * node0 + 1, 2 * (node0 + N) + 1)

    def children(a, b):  # (K, N, ...) pairs -> (K, 2N, ...) heap order
        return torch.stack([a, b], dim=2).reshape(K, 2 * N, *a.shape[2:])

    st.alive[:, ch] = children(can_split, can_split)
    st.totals[:, ch] = children(kn(best.left_sum), kn(best.right_sum))
    if set_matrix is not None:
        member = set_matrix.T[b_feat.clamp(0, set_matrix.shape[1] - 1)]
        child_compat = compat_lvl & member
        st.setcompat[:, ch] = children(child_compat, child_compat)
    if is_monotone(params):
        # bounds propagation per class (constraints.cc SetChild)
        cvec = monotone_vec(params.monotone, w.device)
        c_at = cvec[b_feat.clamp(0, len(params.monotone) - 1)]
        mid = 0.5 * (kn(best.left_weight) + kn(best.right_weight))
        st.lower[:, ch] = children(torch.where(c_at < 0, mid, lower_lvl),
                                   torch.where(c_at > 0, mid, lower_lvl))
        st.upper[:, ch] = children(torch.where(c_at > 0, mid, upper_lvl),
                                   torch.where(c_at < 0, mid, upper_lvl))
    st.pos = _update_positions_k(bins, st.pos, b_feat, b_bin, b_dleft,
                                 can_split, node0, N, B)
    return st, hist


def leaf_margin_delta_k(pos, leaf_val):
    """(K, R_pad) margin deltas of K finished trees: every row of class k
    sits on its leaf of tree k already."""
    safe = pos.long().clamp(0, leaf_val.shape[1] - 1)
    return torch.where(pos >= 0, leaf_val.gather(1, safe), 0.0)


class LockstepHistGrower:
    """Grow the K class trees of one boosting round in lockstep (reference
    grow_lockstep.py:224-280, one device)."""

    def __init__(self, max_depth: int, params: SplitParams, *,
                 interaction_sets=None, max_leaves: int = 0) -> None:
        self.max_depth = max_depth
        self.params = params
        self.interaction_sets = interaction_sets
        self.max_leaves = max_leaves
        self.max_nodes = max_nodes_for_depth(max_depth)
        self._setmat = {}  # (n_features, device) -> set matrix there

    def _set_matrix(self, n_features: int, device) -> Optional[torch.Tensor]:
        if not self.interaction_sets:
            return None
        key = (n_features, device)
        if key not in self._setmat:
            self._setmat[key] = torch.from_numpy(make_set_matrix(
                self.interaction_sets, n_features)).to(device)
        return self._setmat[key]

    def grow(self, bins, gpair, valid, cuts_pad, n_bins) -> TreeState:
        """bins (R_pad, F), gpair (R_pad, K, 2) f32, valid (R_pad,)."""
        setmat = self._set_matrix(bins.shape[1], bins.device)
        state = init_lockstep_state(
            gpair, valid, max_nodes=self.max_nodes,
            n_sets=1 if setmat is None else setmat.shape[0],
            max_splits=self.max_leaves - 1 if self.max_leaves > 0 else 0)
        hist = None
        for d in range(self.max_depth + 1):
            state, hist = level_step_lockstep(
                state, bins, gpair, cuts_pad, n_bins, setmat, hist, depth=d,
                params=self.params, last_level=d == self.max_depth,
                subtract=hist is not None, budget=self.max_leaves > 0)
        return state

    @staticmethod
    def to_host_class(state: TreeState, k: int) -> GrownTree:
        """Class ``k``'s finished tree, copied to the host."""
        return GrownTree(**{f: getattr(state, f)[k].cpu().numpy()
                            for f in GrownTree._fields
                            if getattr(state, f) is not None})
