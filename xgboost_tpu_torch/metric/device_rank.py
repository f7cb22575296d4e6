"""Ranking metrics as segment sums on the booster's device (port of
xgboost_tpu/metric/device_rank.py; reference src/metric/rank_metric.cc).

The loop over query groups in ``metric/__init__.py`` crawls at MSLR scale
(30k+ groups an evaluation).  Here one stable sort (group first, score
descending: ``ops/lambdarank_cuda.py:sorted_order``) puts every group's
docs in rank order, blocks kept contiguous, so the rank within a group is
the position less the group's start; DCG, average precision and
precision@k become masked ``index_add_`` sums over the group ids, and the
hits above a position a global cumulative sum less its value at the
group's start.  The sums are taken in float64.

Each function returns ``(sum_g w_g val_g, sum_g w_g)`` over the groups
with docs, as floats.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.lambdarank_cuda import sorted_order

_F64 = torch.float64


def _segments(group_ptr, k: int, device):
    """(gid, starts, sizes, rank within the group, per-group cut) on
    ``device``; the cut is the group's size where ``k`` <= 0."""
    ptr = torch.as_tensor(np.asarray(group_ptr, np.int64), device=device)
    starts, sizes = ptr[:-1], ptr[1:] - ptr[:-1]
    gid = torch.repeat_interleave(
        torch.arange(len(sizes), device=device), sizes)
    rank = torch.arange(gid.shape[0], device=device) - starts[gid]
    kk = sizes if k <= 0 else torch.clamp(sizes, max=k)
    return gid, starts, sizes, rank, kk


def _group_weights(weights, group_ptr, device):
    """A weight a group: the vector itself, or each group's first row's
    weight (the host metrics' choice), as f32 values."""
    G = len(group_ptr) - 1
    if weights is None:
        w = np.ones(G, np.float32)
    else:
        w = np.asarray(weights, np.float32)
        if len(w) != G:
            w = w[np.minimum(np.asarray(group_ptr[:-1]), len(w) - 1)]
    return torch.as_tensor(w, device=device).to(_F64)


def _inputs(preds, labels, group_ptr, device):
    r = int(group_ptr[-1])
    p = torch.as_tensor(np.asarray(preds, np.float32)[:r], device=device)
    y = torch.as_tensor(np.asarray(labels, np.float32)[:r], device=device)
    return p, y


def _segment_sum(v, gid, G):
    return torch.zeros(G, dtype=_F64, device=v.device).index_add_(0, gid, v)


def _reduce(vals, ws, sizes):
    valid = (sizes > 0).to(_F64)
    return (float(torch.sum(vals * ws * valid)), float(torch.sum(ws * valid)))


def ndcg_pair(preds, labels, group_ptr, weights, k: int, minus: bool,
              device=None):
    device = torch.device("cpu") if device is None else device
    gid, _, sizes, rank, kk = _segments(group_ptr, k, device)
    G = sizes.shape[0]
    p, y = _inputs(preds, labels, group_ptr, device)
    cut = (rank < kk[gid]).to(_F64)
    disc = 1.0 / torch.log2(rank.to(_F64) + 2.0)

    def dcg(key):
        y_s = y[sorted_order(key, gid)].to(_F64)
        return _segment_sum((torch.exp2(y_s) - 1.0) * disc * cut, gid, G)

    d, ideal = dcg(p), dcg(y)
    empty = 0.0 if minus else 1.0
    vals = torch.where(ideal > 0, d / torch.clamp(ideal, min=1e-32),
                       torch.full_like(d, empty))
    return _reduce(vals, _group_weights(weights, group_ptr, device), sizes)


def map_pair(preds, labels, group_ptr, weights, k: int, minus: bool,
             device=None):
    device = torch.device("cpu") if device is None else device
    gid, starts, sizes, rank, kk = _segments(group_ptr, k, device)
    G = sizes.shape[0]
    p, y = _inputs(preds, labels, group_ptr, device)
    y_s = (y[sorted_order(p, gid)] > 0).to(_F64)
    yk = y_s * (rank < kk[gid]).to(_F64)
    cs = torch.cumsum(yk, 0)
    base = torch.where(starts > 0, cs[torch.clamp(starts - 1, min=0)],
                       torch.zeros_like(starts, dtype=_F64))
    hits = cs - base[gid]
    ap = _segment_sum(yk * hits / (rank.to(_F64) + 1.0), gid, G)
    npos = _segment_sum(yk, gid, G)
    empty = 0.0 if minus else 1.0
    vals = torch.where(npos > 0, ap / torch.clamp(npos, min=1e-32),
                       torch.full_like(ap, empty))
    return _reduce(vals, _group_weights(weights, group_ptr, device), sizes)


def precision_pair(preds, labels, group_ptr, weights, k: int, device=None):
    device = torch.device("cpu") if device is None else device
    gid, _, sizes, rank, n = _segments(group_ptr, k, device)
    G = sizes.shape[0]
    p, y = _inputs(preds, labels, group_ptr, device)
    y_s = y[sorted_order(p, gid)].to(_F64)
    top = _segment_sum(y_s * (rank < n[gid]).to(_F64), gid, G)
    vals = top / torch.clamp(n, min=1).to(_F64)
    return _reduce(vals, _group_weights(weights, group_ptr, device), sizes)
