"""Vectorized tree-traversal prediction (port of ``_traverse_one_tree`` and
``predict_margin_delta`` of xgboost_tpu/ops/predict.py).

All rows and all trees of a stacked ensemble advance one level per step
(rows at leaves stick); the per-row feature read is a gather.  Raw feature
values and thresholds are used (not bins), so the same code serves
training-eval and inference on fresh data.  Leaf values are then added to
the margin tree by tree, in tree order, as the reference accumulates them.
"""
from __future__ import annotations

import torch


def _traverse(X, feat, thr, dleft, left, right, depth: int):
    """Leaf node id per (row, tree): (R, T).  X (R, F) f32, NaN missing;
    feat..right (T, M) stacked padded node arrays (feat -1 at leaves)."""
    R, F = X.shape
    T = feat.shape[0]
    tree = torch.arange(T, device=X.device)[None, :]
    nid = torch.zeros((R, T), dtype=torch.long, device=X.device)
    for _ in range(depth):
        fi = feat[tree, nid]  # (R, T)
        x = X.gather(1, fi.clamp(0, F - 1))
        goleft = torch.where(torch.isnan(x), dleft[tree, nid],
                             x < thr[tree, nid])
        nxt = torch.where(goleft, left[tree, nid], right[tree, nid])
        nid = torch.where(fi < 0, nid, nxt)
    return nid


def predict_margin_delta(X, feat, thr, dleft, left, right, value, groups,
                         init=None, *, n_groups: int, depth: int):
    """Sum leaf values of a stack of trees into (R, n_groups) margins.

    feat..value: (T, M) stacked padded tree arrays; groups: output group
    of each tree (a host sequence of T ints).  ``init``: optional
    (R, n_groups) starting margin, accumulated into in tree order.
    """
    R = X.shape[0]
    margin = (torch.zeros((R, n_groups), dtype=torch.float32, device=X.device)
              if init is None else init.to(torch.float32).clone())
    nid = _traverse(X, feat.long(), thr, dleft, left.long(), right.long(),
                    depth)
    leaf = value.gather(1, nid.T).T  # (R, T)
    for t, g in enumerate(groups):
        margin[:, g] += leaf[:, t]
    return margin
