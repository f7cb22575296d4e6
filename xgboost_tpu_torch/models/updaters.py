"""Non-growing tree updaters: prune, refresh and sync, which
``process_type="update"`` runs over an existing model's trees (port of
xgboost_tpu/models/updaters.py).

Reference: src/tree/updater_prune.cc (TreePruner: collapse, bottom up,
splits whose recorded loss_chg is below gamma), updater_refresh.cc
(TreeRefresher: per-node statistics and leaf values recomputed from the
current gradients, the structure kept), updater_sync.cc (TreeSyncher:
rank 0's trees to every worker) and gbtree.cc InitUpdater.

Tree surgery is pointer work on the host RegTree arrays, not device math,
so this module is numpy, as the reference's is: the booster copies a
round's gradients to the host once and hands the trees back.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .tree import RegTree


def _route_masks(tree: RegTree, X: np.ndarray) -> np.ndarray:
    """(n_nodes, R) bool: which rows reach each node."""
    R = X.shape[0]
    n = tree.n_nodes
    masks = np.zeros((n, R), dtype=bool)
    masks[0] = True
    st = (tree.split_type if tree.split_type is not None
          else np.zeros(n, np.int32))
    for nid in range(n):
        l, r = tree.left_children[nid], tree.right_children[nid]
        if l == -1:
            continue
        x = X[:, tree.split_indices[nid]]
        nanmask = np.isnan(x)
        if st[nid] == 1 and tree.categories and nid in tree.categories:
            cats = set(int(c) for c in tree.categories[nid])
            code = np.nan_to_num(x, nan=-1.0).astype(np.int64)
            goleft = ~np.isin(code, list(cats))
        else:
            goleft = x < tree.split_conditions[nid]
        goleft = np.where(nanmask, bool(tree.default_left[nid]), goleft)
        masks[l] = masks[nid] & goleft
        masks[r] = masks[nid] & ~goleft
    return masks


def refresh_tree(tree: RegTree, X: np.ndarray, grad: np.ndarray,
                 hess: np.ndarray, *, eta: float, lambda_: float,
                 alpha: float = 0.0, refresh_leaf: bool = True) -> RegTree:
    """Recompute each node's hessian sum, weight and split gain, and with
    ``refresh_leaf`` the leaf values, from the given gradients (f64 sums);
    the structure stays (updater_refresh.cc TreeRefresher::Update).  The
    tree's arrays are rewritten in place."""
    masks = _route_masks(tree, X)
    G = masks @ grad.astype(np.float64)
    H = masks @ hess.astype(np.float64)

    def thr_l1(g):
        return np.sign(g) * np.maximum(np.abs(g) - alpha, 0.0)

    w = -thr_l1(G) / (H + lambda_)
    tree.sum_hessian[:] = H.astype(np.float32)
    tree.base_weights[:] = w.astype(np.float32)
    for nid in range(tree.n_nodes):
        l, r = tree.left_children[nid], tree.right_children[nid]
        if l == -1:
            if refresh_leaf:
                tree.split_conditions[nid] = np.float32(eta * w[nid])
        else:
            gain = (thr_l1(G[l]) ** 2 / (H[l] + lambda_)
                    + thr_l1(G[r]) ** 2 / (H[r] + lambda_)
                    - thr_l1(G[nid]) ** 2 / (H[nid] + lambda_))
            tree.loss_changes[nid] = np.float32(gain)
    return tree


def prune_tree(tree: RegTree, *, gamma: float, eta: float,
               max_depth: int = 0) -> Tuple[RegTree, int]:
    """Collapse, bottom up and repeatedly, every split of two leaves whose
    loss_chg is below gamma (or that lies at max_depth or deeper, when
    set) into a leaf of its own weight; returns (the compacted tree, the
    number of splits removed) (updater_prune.cc TreePruner::DoPrune)."""
    n = tree.n_nodes
    left = tree.left_children.copy()
    right = tree.right_children.copy()
    depth = np.zeros(n, np.int32)
    for i in range(1, n):
        depth[i] = depth[tree.parents[i]] + 1
    is_leaf = left == -1
    pruned = 0
    changed = True
    while changed:
        changed = False
        for nid in range(n - 1, -1, -1):
            l, r = left[nid], right[nid]
            if l == -1:
                continue
            if is_leaf[l] and is_leaf[r]:
                too_deep = max_depth > 0 and depth[nid] >= max_depth
                if tree.loss_changes[nid] < gamma or too_deep:
                    left[nid] = -1
                    right[nid] = -1
                    is_leaf[nid] = True
                    tree.split_conditions[nid] = np.float32(
                        eta * tree.base_weights[nid])
                    pruned += 1
                    changed = True
    if pruned == 0:
        return tree, 0
    # drop the unreachable nodes, renumbered in depth-first creation order
    remap = {}
    order = []

    def rec(nid):
        remap[nid] = len(order)
        order.append(nid)
        if left[nid] != -1:
            rec(left[nid])
            rec(right[nid])

    rec(0)
    m = len(order)
    out = RegTree(
        left_children=np.asarray(
            [remap[left[i]] if left[i] != -1 else -1 for i in order],
            np.int32),
        right_children=np.asarray(
            [remap[right[i]] if left[i] != -1 else -1 for i in order],
            np.int32),
        parents=np.asarray(
            [remap[tree.parents[i]] if i != 0 else -1 for i in order],
            np.int32),
        split_indices=np.asarray(
            [tree.split_indices[i] if left[i] != -1 else 0 for i in order],
            np.int32),
        split_conditions=tree.split_conditions[order].astype(np.float32),
        default_left=tree.default_left[order].astype(bool),
        base_weights=tree.base_weights[order].astype(np.float32),
        loss_changes=np.asarray(
            [tree.loss_changes[i] if left[i] != -1 else 0.0 for i in order],
            np.float32),
        sum_hessian=tree.sum_hessian[order].astype(np.float32),
        split_type=(tree.split_type[order].astype(np.int32)
                    if tree.split_type is not None
                    else np.zeros(m, np.int32)),
        categories={remap[k]: v for k, v in (tree.categories or {}).items()
                    if k in remap and left[k] != -1} or {},
    )
    return out, pruned


def sync_trees(trees, tree_info, tree_weights):
    """Rank 0's model to every worker (updater_sync.cc TreeSyncher): the
    port trains in one process, so the model is already everyone's."""
    return trees, tree_info, tree_weights
