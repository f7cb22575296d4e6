"""Global best-first (lossguide) tree growing (port of
xgboost_tpu/tree/bestfirst.py; reference: XGBoost's priority queue of open
leaves under lossguide).

Expand the one open leaf of highest gain anywhere in the tree, until the
``max_leaves`` budget is spent or no gain above ``gamma`` remains.  The
tree lives in a node table of ``2 * max_leaves`` slots in creation order
(root 0, the children of each expansion the next two ids), so depth is
bounded only by ``max_depth`` (0 = unbounded).

Per expansion the device work is: route the chosen node's rows (an
elementwise rewrite of ``pos``), one histogram for both children (their
ids are consecutive, so one launch of the level dispatcher covers them
with ``node0`` = the left child, two nodes, stride 1: K1 on the card), and
the split scan of the two (K3 on the card).  The host reads one pair
(node, gain) per expansion, as the reference pops its queue.  A
categorical split routes by set membership, as the level grower's does.
The state's tensors are updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.tree import RegTree
from ..ops.hist_cuda import build_histogram
from ..ops.histogram import node_sums
from ..ops.split import SplitParams, calc_weight, evaluate_splits, \
    is_monotone, monotone_vec
from .grow import FeatureMasks, HistTreeGrower

_EPS = 1e-6


@dataclasses.dataclass
class BFState:
    """Device-side node table (creation order, ``n_slots`` slots)."""

    pos: torch.Tensor  # (R_pad,) int32 table node id per row, -1 = padded
    parent: torch.Tensor  # (N,) int32
    left: torch.Tensor  # (N,) int32, -1 = leaf or unused
    right: torch.Tensor  # (N,) int32
    depth: torch.Tensor  # (N,) int32
    feat: torch.Tensor  # (N,) int64
    sbin: torch.Tensor  # (N,) int64
    dleft: torch.Tensor  # (N,) bool
    gain: torch.Tensor  # (N,) f32 loss_chg of applied splits
    totals: torch.Tensor  # (N, 2) f32
    lower: torch.Tensor  # (N,) f32 monotone bounds
    upper: torch.Tensor  # (N,) f32
    setcompat: torch.Tensor  # (N, n_sets) bool
    # the candidate split of each open leaf, found when it was created
    cand_gain: torch.Tensor  # (N,) f32, -inf when closed or invalid
    cand_feat: torch.Tensor  # (N,) int64
    cand_bin: torch.Tensor  # (N,) int64
    cand_dleft: torch.Tensor  # (N,) bool
    cand_lsum: torch.Tensor  # (N, 2)
    cand_rsum: torch.Tensor  # (N, 2)
    cand_lw: torch.Tensor  # (N,) f32 clipped child weights
    cand_rw: torch.Tensor  # (N,) f32
    n_nodes: int = 1  # table slots in use
    # categorical splits (None without categorical features): the applied
    # ones and each open leaf's candidate
    is_cat: Optional[torch.Tensor] = None  # (N,) bool
    cat_set: Optional[torch.Tensor] = None  # (N, B) bool, routed right
    cand_is_cat: Optional[torch.Tensor] = None
    cand_cat_set: Optional[torch.Tensor] = None


def _init_state(gpair, valid, n_slots: int, n_sets: int,
                n_cat_bin: int = 0) -> BFState:
    dev = gpair.device
    pos = torch.where(valid, 0, -1).to(torch.int32)
    totals = torch.zeros((n_slots, 2), dtype=torch.float32, device=dev)
    totals[0] = node_sums(gpair, pos, node0=0, n_nodes=1)[0]

    def full(v, dtype):
        return torch.full((n_slots,), v, dtype=dtype, device=dev)

    st = BFState(
        pos=pos, parent=full(-1, torch.int32), left=full(-1, torch.int32),
        right=full(-1, torch.int32), depth=full(0, torch.int32),
        feat=full(-1, torch.int64), sbin=full(0, torch.int64),
        dleft=full(True, torch.bool), gain=full(0.0, torch.float32),
        totals=totals, lower=full(-torch.inf, torch.float32),
        upper=full(torch.inf, torch.float32),
        setcompat=torch.ones((n_slots, n_sets), dtype=torch.bool,
                             device=dev),
        cand_gain=full(-torch.inf, torch.float32),
        cand_feat=full(0, torch.int64), cand_bin=full(0, torch.int64),
        cand_dleft=full(True, torch.bool),
        cand_lsum=torch.zeros((n_slots, 2), dtype=torch.float32, device=dev),
        cand_rsum=torch.zeros((n_slots, 2), dtype=torch.float32, device=dev),
        cand_lw=full(0.0, torch.float32), cand_rw=full(0.0, torch.float32))
    if n_cat_bin:
        st.is_cat = full(False, torch.bool)
        st.cand_is_cat = full(False, torch.bool)
        st.cat_set = torch.zeros((n_slots, n_cat_bin), dtype=torch.bool,
                                 device=dev)
        st.cand_cat_set = torch.zeros_like(st.cat_set)
    return st


def _eval_nodes(st: BFState, hist, n_bins, feature_mask, set_matrix,
                cat_mask, i0: int, n: int, params: SplitParams,
                max_depth: int) -> None:
    """Split candidates of the consecutive nodes [i0, i0 + n) from their
    histogram, in place."""
    ids = slice(i0, i0 + n)
    fm = feature_mask
    if set_matrix is not None:
        # interaction constraints: the union of the sets still compatible
        # with the node's path (constraints.cc)
        allowed = (st.setcompat[ids][:, :, None]
                   & set_matrix[None, :, :]).any(dim=1)
        fm = allowed if fm is None else allowed & fm
    bounds = (torch.stack([st.lower[ids], st.upper[ids]], dim=1)
              if is_monotone(params) else None)
    best = evaluate_splits(hist, st.totals[ids], n_bins, params, fm, bounds,
                           cat_mask)
    gain = best.gain
    if max_depth > 0:
        gain = torch.where(st.depth[ids] < max_depth, gain, -torch.inf)
    st.cand_gain[ids] = gain
    st.cand_feat[ids] = best.feature
    st.cand_bin[ids] = best.bin
    st.cand_dleft[ids] = best.default_left
    st.cand_lsum[ids] = best.left_sum
    st.cand_rsum[ids] = best.right_sum
    st.cand_lw[ids] = best.left_weight
    st.cand_rw[ids] = best.right_weight
    if st.cand_is_cat is not None:
        st.cand_is_cat[ids] = best.is_cat
        st.cand_cat_set[ids] = best.cat_set


def _apply_split(st: BFState, bins, set_matrix, nid: int, l_id: int,
                 r_id: int, params: SplitParams, n_bin: int) -> None:
    """Expand node ``nid`` into (``l_id``, ``r_id``): record its split and
    route its rows, in place."""
    F = bins.shape[1]
    f = st.cand_feat[nid]
    fc = f.clamp(0, F - 1)
    sb = st.cand_bin[nid]
    dl = st.cand_dleft[nid]
    st.left[nid] = l_id
    st.right[nid] = r_id
    st.feat[nid] = f
    st.sbin[nid] = sb
    st.dleft[nid] = dl
    st.gain[nid] = st.cand_gain[nid]
    st.cand_gain[nid] = -torch.inf  # closed
    kids = slice(l_id, r_id + 1)
    st.parent[kids] = nid
    st.depth[kids] = st.depth[nid] + 1
    st.totals[l_id] = st.cand_lsum[nid]
    st.totals[r_id] = st.cand_rsum[nid]
    if set_matrix is not None:  # children keep the sets that contain f
        member = set_matrix.index_select(1, fc.reshape(1))[:, 0]
        st.setcompat[kids] = (st.setcompat[nid] & member)[None, :]
    if is_monotone(params):
        # bounds propagation (constraints.cc ValueConstraint::SetChild)
        c_at = monotone_vec(params.monotone, bins.device).index_select(
            0, fc.reshape(1))[0]
        mid = 0.5 * (st.cand_lw[nid] + st.cand_rw[nid])
        lo, hi = st.lower[nid].clone(), st.upper[nid].clone()
        st.lower[l_id] = torch.where(c_at < 0, mid, lo)
        st.lower[r_id] = torch.where(c_at > 0, mid, lo)
        st.upper[l_id] = torch.where(c_at > 0, mid, hi)
        st.upper[r_id] = torch.where(c_at < 0, mid, hi)
    binval = bins.index_select(1, fc.reshape(1))[:, 0].long()
    goleft = binval <= sb
    if st.is_cat is not None:  # categorical: in the set goes right
        st.is_cat[nid] = st.cand_is_cat[nid]
        st.cat_set[nid] = st.cand_cat_set[nid]
        in_set = st.cand_cat_set[nid][binval.clamp(0, n_bin - 1)]
        goleft = torch.where(st.cand_is_cat[nid], ~in_set, goleft)
    goleft = torch.where(binval >= n_bin, dl, goleft)
    child = torch.where(goleft, l_id, r_id).to(torch.int32)
    st.pos = torch.where(st.pos == nid, child, st.pos)


def _pick_best(cand_gain) -> Tuple[int, float]:
    """The open leaf of highest gain (the first of equals) and its gain: one
    read from the device."""
    nid = torch.argmax(cand_gain).reshape(1)
    pair = torch.cat([nid.to(torch.float32), cand_gain.gather(0, nid)])
    pair = pair.tolist()
    return int(pair[0]), pair[1]


class BestFirstGrower:
    """Lossguide: a host loop of device expansions (the queue's pop and
    push)."""

    def __init__(self, max_depth: int, params: SplitParams, *,
                 max_leaves: int, interaction_sets=None) -> None:
        if max_leaves <= 1:
            raise ValueError("the best-first grower needs max_leaves > 1")
        self.max_depth = max_depth  # 0 = unbounded
        self.params = params
        self.max_leaves = max_leaves
        self.interaction_sets = interaction_sets
        self.n_slots = 2 * max_leaves  # any L-leaf binary tree: 2L-1 nodes
        self._setmat = {}  # (n_features, device) -> set matrix there
        self._catmask = {}  # (mask bytes, device) -> cat mask there

    # the interaction sets and categorical mask on the device, made once
    # (as the level grower)
    _set_matrix = HistTreeGrower._set_matrix
    _cat_mask = HistTreeGrower._cat_mask

    def grow(self, bins, gpair, valid, cuts_pad, n_bins,
             feature_masks: Optional[FeatureMasks] = None,
             cat_mask=None) -> BFState:
        """bins (R_pad, F), gpair (R_pad, 2) f32, valid (R_pad,) bool;
        ``cat_mask`` (F,) numpy bool of the categorical features or None."""
        B = cuts_pad.shape[1]
        setmat = self._set_matrix(bins.shape[1], bins.device)
        cm = self._cat_mask(cat_mask, bins.device)
        st = _init_state(gpair, valid, self.n_slots,
                         1 if setmat is None else setmat.shape[0],
                         0 if cm is None else B)
        p, md = self.params, self.max_depth
        # column sampling: a fresh bylevel/bynode draw per expansion (the
        # reference's ColumnSampler draws as nodes are created)
        fm = None if feature_masks is None else feature_masks(0, 1)
        hist = build_histogram(bins, gpair, st.pos, node0=0, n_nodes=1,
                               n_bin=B)
        _eval_nodes(st, hist, n_bins, fm, setmat, cm, 0, 1, p, md)
        gamma_eps = max(p.gamma, _EPS)
        for _ in range(self.max_leaves - 1):
            nid, gain = _pick_best(st.cand_gain)
            if gain <= gamma_eps:  # the queue is exhausted
                break
            l_id = st.n_nodes
            _apply_split(st, bins, setmat, nid, l_id, l_id + 1, p, B)
            fm = None if feature_masks is None else feature_masks(0, 2)
            hist = build_histogram(bins, gpair, st.pos, node0=l_id,
                                   n_nodes=2, n_bin=B)
            _eval_nodes(st, hist, n_bins, fm, setmat, cm, l_id, 2, p, md)
            st.n_nodes += 2
        return st

    def leaf_mask(self, st: BFState) -> torch.Tensor:
        """(n_slots,) bool on the device: which of the table's nodes are
        leaves (the adaptive refit's mask)."""
        slots = torch.arange(self.n_slots, device=st.left.device)
        return (st.left == -1) & (slots < st.n_nodes)

    def to_regtree(self, st: BFState, cuts_host: np.ndarray
                   ) -> Tuple[RegTree, torch.Tensor]:
        """(the RegTree in table order, the (n_slots,) leaf values on the
        device for the margin update).  ``cuts_host``: (F, B) f32 cuts."""
        n = st.n_nodes

        def host(t):
            return t[:n].cpu()

        left, right, parent = host(st.left), host(st.right), host(st.parent)
        feat, sbin, dleft = host(st.feat), host(st.sbin), host(st.dleft)
        gain, totals = host(st.gain), host(st.totals)
        p = self.params
        w = calc_weight(totals[:, 0], totals[:, 1], p, host(st.lower),
                        host(st.upper))
        leaf = left == -1
        eta_w = p.eta * w
        B = cuts_host.shape[1]
        thr = torch.from_numpy(cuts_host[feat.clamp(min=0).numpy(),
                                         sbin.clamp(max=B - 1).numpy()])
        leaf_val = torch.zeros(self.n_slots, dtype=torch.float32)
        leaf_val[:n] = torch.where(leaf, eta_w, 0.0)
        split_type = np.zeros(n, np.int32)
        cats = {}
        if st.is_cat is not None:
            is_cat, cat_set = host(st.is_cat).numpy(), host(st.cat_set).numpy()
            split_type = is_cat.astype(np.int32)
            for i in np.nonzero(is_cat & ~leaf.numpy())[0]:
                cats[int(i)] = np.nonzero(cat_set[i])[0].astype(np.int32)
        tree = RegTree(
            left_children=left.numpy().astype(np.int32),
            right_children=right.numpy().astype(np.int32),
            parents=parent.numpy().astype(np.int32),
            split_indices=torch.where(leaf, 0, feat).numpy().astype(np.int32),
            split_conditions=torch.where(leaf, eta_w, thr).numpy(),
            default_left=dleft.numpy().astype(bool),
            base_weights=w.numpy(),
            loss_changes=torch.where(leaf, 0.0, gain).numpy(),
            sum_hessian=totals[:, 1].numpy().copy(),
            split_type=split_type,
            categories=cats,
        )
        return tree, leaf_val.to(st.pos.device)
