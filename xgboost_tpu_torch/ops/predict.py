"""Vectorized tree-traversal prediction (port of the bucket policy,
``run_stacked_margin``, ``_traverse_one_tree``, ``predict_margin_delta``,
``predict_margin_delta_multi`` and ``predict_leaf_ids`` of
xgboost_tpu/ops/predict.py).

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

import threading

import torch

# --------------------------------------------------------------- bucket policy
# The reference's shape buckets (xgboost_tpu/ops/predict.py:17-72).  Its jit
# specialises per shape; here the serving engine captures one CUDA graph per
# (snapshot, row bucket, output kind), so steady traffic lands on a few
# padded shapes whose graphs are already captured.  Pad rows are NaN:
# traversal is row-independent, so they change nothing and are sliced off.

_MIN_ROW_BUCKET = 8
# past this, pow2 padding could waste up to 2x; fall back to chunk multiples
_POW2_ROW_CEILING = 4096


def round_up_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def bucket_rows(n: int) -> int:
    """Padded row count for a batch of ``n`` rows: power-of-two buckets up to
    4096, then multiples of 4096."""
    n = int(n)
    if n <= _MIN_ROW_BUCKET:
        return _MIN_ROW_BUCKET
    if n <= _POW2_ROW_CEILING:
        return round_up_pow2(n)
    c = _POW2_ROW_CEILING
    return ((n + c - 1) // c) * c


def bucket_width(w: int) -> int:
    """Padded node count for a stacked tree ensemble: the next power of
    two, at least 2."""
    return round_up_pow2(max(int(w), 2))


def pad_rows(X, bucket: int):
    """Pad an (R, F) batch with NaN rows up to ``bucket`` (X itself when it
    has that many rows)."""
    R = X.shape[0]
    if R == bucket:
        return X
    return torch.nn.functional.pad(X, (0, 0, 0, bucket - R), value=float("nan"))


def pad_margin(init, bucket: int):
    """Pad an optional (R, K) starting margin to the row bucket with zeros."""
    if init is None:
        return None
    R = init.shape[0]
    if R == bucket:
        return init
    return torch.nn.functional.pad(init, (0, 0, 0, bucket - R))


# Serve programs alive in the process (a captured graph on the card, a
# prepared eager program on the CPU): the counterpart of the reference's
# ``predict_cache_size``, the serving engine's no-recompile gauge.  And the
# graphs replayed, which no kernel wrapper sees (``hist_cuda.launched``
# counts the launches Python makes).
_gauge_lock = threading.Lock()
_programs = 0
_replays = 0


def predict_cache_size() -> int:
    """Serve programs alive in the process."""
    return _programs


def note_programs(delta: int) -> None:
    """Count ``delta`` serve programs prepared (positive) or released."""
    global _programs
    with _gauge_lock:
        _programs += int(delta)


def graph_replays() -> int:
    """Serve graphs replayed in the process since it started."""
    return _replays


def note_replay() -> None:
    global _replays
    with _gauge_lock:
        _replays += 1


def run_stacked_margin(X, stacked, groups, depth: int, n_groups: int,
                       init=None):
    """The margin of a stacked ensemble (``Booster._stacked``'s dict) over
    an (R, F) batch: vector leaves, categorical sets or plain scalar
    leaves.  The one place the stacked dict's fields are read, so that
    ``Booster.predict`` and the serving snapshot give the same bits."""
    s = stacked
    if "value_vec" in s:
        return predict_margin_delta_multi(
            X, s["feat"], s["thr"], s["dleft"], s["left"], s["right"],
            s["value_vec"], init, depth=depth)
    return predict_margin_delta(
        X, s["feat"], s["thr"], s["dleft"], s["left"], s["right"],
        s["value"], groups, init, s.get("is_cat"), s.get("catm"),
        n_groups=n_groups, depth=depth)


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


def predict_margin_delta_binned(bins, feat, sbin, dleft, left, right, value,
                                groups, init=None, is_cat=None, catm=None, *,
                                n_groups: int, depth: int, n_bin: int):
    """Sum leaf values into (R, n_groups) margins over a binned page
    (reference ops/predict.py:264, the external-memory predict path).

    Rows are routed by the trees' stored split bins (``RegTree.split_bins``),
    which reproduces the training partition exactly: bin <= sbin goes
    left, the sentinel ``n_bin`` (missing) takes the default direction, a
    categorical node sends the bins of its set right.  ``init``: optional
    starting margin, accumulated into in tree order."""
    R, F = bins.shape
    T = feat.shape[0]
    dev = bins.device
    feat, left, right = feat.long(), left.long(), right.long()
    sbin = sbin.long()
    tree = torch.arange(T, device=dev)[None, :]
    nid = torch.zeros((R, T), dtype=torch.long, device=dev)
    for _ in range(depth):
        fi = feat[tree, nid]  # (R, T)
        b = bins.gather(1, fi.clamp(0, F - 1)).long()
        gol = b <= sbin[tree, nid]
        if is_cat is not None:
            Bc = catm.shape[2]
            member = catm[tree, nid, b.clamp(0, Bc - 1)] & (b < Bc)
            gol = torch.where(is_cat[tree, nid], ~member, gol)
        gol = torch.where(b >= n_bin, dleft[tree, nid], gol)
        nxt = torch.where(gol, left[tree, nid], right[tree, nid])
        nid = torch.where(fi < 0, nid, nxt)
    margin = (torch.zeros((R, n_groups), dtype=torch.float32, device=dev)
              if init is None else init.to(torch.float32).clone())
    leaf = value.gather(1, nid.T).T  # (R, T)
    for t, g in enumerate(groups):
        margin[:, g] += leaf[:, t]
    return margin
