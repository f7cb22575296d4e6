"""Adaptive (quantile) leaf values for the absolute and quantile error
objectives (port of xgboost_tpu/ops/adaptive.py; reference
src/objective/adaptive.cc UpdateTreeLeaf).

After a tree is grown and every row sits on its leaf, each leaf's value
becomes eta times the alpha-quantile of the residuals (label - margin
before the tree) of its rows: the exact minimiser of the pinball loss,
which the second-order step cannot reach.

One lexicographic sort by (leaf id, residual), then each leaf's segment by
``searchsorted`` on the sorted leaf ids and the interpolated quantile; no
per-leaf loop and no host round trip, on the rows' device.
"""
from __future__ import annotations

import torch

from ..utils.fp import fma_f32


def _sort_key(v):
    """The residual as the reference's sort compares it: -0.0 equal to
    +0.0 and every NaN equal and last (lax.sort's comparator), so that a
    stable sort keeps the rows' order among equals on any device (a radix
    sort on the card would put -0.0 first)."""
    v = torch.where(v == 0, torch.zeros_like(v), v)
    return torch.where(torch.isnan(v), torch.full_like(v, float("nan")), v)


def lexsort_stable(key, value):
    """Stable lexicographic order of (key, value) rows: a stable sort by
    value, then a stable sort by key; returns the permutation."""
    by_value = torch.sort(_sort_key(value), stable=True).indices
    by_key = torch.sort(key[by_value], stable=True).indices
    return by_value[by_key]


def segment_quantile_leaf(pos, residual, valid, leaf_mask, alpha: float,
                          eta: float, *, max_nodes: int):
    """Per-leaf residual quantiles.

    pos      : (R,) int — leaf node id per row (-1 padded)
    residual : (R,) f32 — label - margin before this tree
    valid    : (R,) bool
    leaf_mask: (max_nodes,) bool — which node slots are leaves
    Returns (max_nodes,) f32 leaf values (eta-scaled), zero for non-leaves
    and for leaves without rows."""
    R = pos.shape[0]
    dev = residual.device
    key = torch.where(valid, pos.to(torch.int64),
                      torch.full_like(pos, max_nodes, dtype=torch.int64))
    order = lexsort_stable(key, residual)
    sk, sr = key[order], residual[order]
    node_ids = torch.arange(max_nodes, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(sk, node_ids, right=False)
    ends = torch.searchsorted(sk, node_ids, right=True)
    cnt = (ends - starts).to(torch.float32)
    q = torch.clamp(cnt - 1.0, min=0.0) * alpha
    lo = torch.floor(q).to(torch.int64)
    frac = q - lo.to(torch.float32)
    i0 = torch.clamp(starts + lo, 0, R - 1)
    i1 = torch.clamp(starts + torch.minimum(
        lo + 1, torch.clamp(ends - starts - 1, min=0)), 0, R - 1)
    # XLA's CPU code fuses the second product into the sum
    v = fma_f32(sr[i1], frac, sr[i0] * (1.0 - frac))
    ok = leaf_mask.to(dev) & (cnt > 0)
    return torch.where(ok, v * eta, torch.zeros_like(v))
