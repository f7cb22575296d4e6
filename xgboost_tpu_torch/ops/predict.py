"""Vectorized tree-traversal prediction (port of ``_traverse_one_tree``,
``predict_margin_delta``, ``predict_margin_delta_multi`` and
``predict_leaf_ids`` of xgboost_tpu/ops/predict.py).

All rows and all trees of a stacked ensemble advance one level per step
(rows at leaves stick); the per-row feature read is a gather.  Raw feature
values and thresholds are used (not bins), so the same code serves
training-eval and inference on fresh data.  Leaf values are then added to
the margin tree by tree, in tree order, as the reference accumulates them.

A categorical node (reference ops/predict.py:109-134) reads its value as
the code ``int(x)``: a code in its set goes right, any other code, one out
of the set's range included, goes left, and NaN takes the default
direction.
"""
from __future__ import annotations

import torch


def _traverse(X, feat, thr, dleft, left, right, depth: int, is_cat=None,
              catm=None):
    """Leaf node id per (row, tree): (R, T).  X (R, F) f32, NaN missing;
    feat..right (T, M) stacked padded node arrays (feat -1 at leaves);
    ``is_cat`` (T, M) bool and ``catm`` (T, M, Bc) bool, the categories each
    node routes right, for trees with categorical splits."""
    R, F = X.shape
    T = feat.shape[0]
    tree = torch.arange(T, device=X.device)[None, :]
    nid = torch.zeros((R, T), dtype=torch.long, device=X.device)
    for _ in range(depth):
        fi = feat[tree, nid]  # (R, T)
        x = X.gather(1, fi.clamp(0, F - 1))
        gol = x < thr[tree, nid]
        if is_cat is not None:
            Bc = catm.shape[2]
            c = torch.nan_to_num(x, nan=-1.0).to(torch.int32).long()
            member = catm[tree, nid, c.clamp(0, Bc - 1)] & (c >= 0) & (c < Bc)
            gol = torch.where(is_cat[tree, nid], ~member, gol)
        goleft = torch.where(torch.isnan(x), dleft[tree, nid], gol)
        nxt = torch.where(goleft, left[tree, nid], right[tree, nid])
        nid = torch.where(fi < 0, nid, nxt)
    return nid


def predict_margin_delta(X, feat, thr, dleft, left, right, value, groups,
                         init=None, is_cat=None, catm=None, *,
                         n_groups: int, depth: int):
    """Sum leaf values of a stack of trees into (R, n_groups) margins.

    feat..value: (T, M) stacked padded tree arrays; groups: output group
    of each tree (a host sequence of T ints).  ``init``: optional
    (R, n_groups) starting margin, accumulated into in tree order.
    ``is_cat``/``catm``: the categorical routing tables, or None.
    """
    R = X.shape[0]
    margin = (torch.zeros((R, n_groups), dtype=torch.float32, device=X.device)
              if init is None else init.to(torch.float32).clone())
    nid = _traverse(X, feat.long(), thr, dleft, left.long(), right.long(),
                    depth, is_cat, catm)
    leaf = value.gather(1, nid.T).T  # (R, T)
    for t, g in enumerate(groups):
        margin[:, g] += leaf[:, t]
    return margin


def predict_margin_delta_multi(X, feat, thr, dleft, left, right, value_vec,
                               init=None, *, depth: int):
    """Sum the leaf vectors of a stack of vector-leaf trees into (R, K)
    margins: every tree adds its leaf's K-vector to all K outputs, in tree
    order (reference ops/predict.py:222-250).  value_vec (T, M, K)."""
    R, K = X.shape[0], value_vec.shape[2]
    margin = (torch.zeros((R, K), dtype=torch.float32, device=X.device)
              if init is None else init.to(torch.float32).clone())
    nid = _traverse(X, feat.long(), thr, dleft, left.long(), right.long(),
                    depth)
    for t in range(value_vec.shape[0]):
        margin += value_vec[t][nid[:, t]]
    return margin


def predict_leaf_ids(X, feat, thr, dleft, left, right, is_cat=None,
                     catm=None, *, depth: int):
    """(R, T) int32 leaf node id of every row in every tree of a stack
    (reference: ops/predict.py:253 predict_leaf_ids, Predictor::
    PredictLeaf)."""
    return _traverse(X, feat.long(), thr, dleft, left.long(), right.long(),
                     depth, is_cat, catm).to(torch.int32)
