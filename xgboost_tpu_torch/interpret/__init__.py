"""Feature attribution: exact TreeSHAP, the Saabas approximation and SHAP
interaction values (port of xgboost_tpu/interpret/__init__.py).

Three paths, dispatched as the reference dispatches them:

- Exact SHAP and interactions of scalar, numeric trees go to the path
  tables of ``interpret/device.py``: on a CUDA tensor K6
  (``csrc/treeshap.cu``), on a CPU tensor the plain PyTorch version of the
  reference's bucket programs.  Interactions take it from 128 rows up.
- Categorical trees (and interactions below 128 rows) take the host walk:
  the EXTEND/UNWIND recursion of path-dependent TreeSHAP (Lundberg et al.
  2018) in numpy f64.  It walks every row at once: the extend and unwind
  calls along a root->leaf path are the same for every row, only the one
  fractions differ, so each leaf's contributions are vectors over the rows,
  computed in the scalar recursion's operation order.  They are then added
  into each row in the order that row's recursion visits the leaves (the
  hot child first), so every sum is taken as the reference's scalar walk
  takes it.
- Saabas (``approx_contribs=True``) runs on the booster's device: each
  tree's node values on the host in f64, then one step a level over all
  rows, adding ``nodeval[next] - nodeval[node]`` at (row, feature) in f64.

Contributions sum to the margin without the matrix's base margin, which is
not added (as in the reference).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["predict_contribs", "predict_interactions", "saabas_values_tree",
           "shap_interactions_tree", "shap_values_tree"]


class _Path:
    """The m-path of (feature, zero fraction, one fraction, weight) tuples;
    one fractions and weights are vectors over the rows."""

    __slots__ = ("feat", "zero", "one", "pw")

    def __init__(self, capacity: int, n_rows: int):
        self.feat = np.full(capacity, -1, np.int64)
        self.zero = np.zeros(capacity, np.float64)
        self.one = np.zeros((capacity, n_rows), np.float64)
        self.pw = np.zeros((capacity, n_rows), np.float64)

    def copy(self, length: int) -> "_Path":
        p = _Path(len(self.feat), self.one.shape[1])
        p.feat[:length] = self.feat[:length]
        p.zero[:length] = self.zero[:length]
        p.one[:length] = self.one[:length]
        p.pw[:length] = self.pw[:length]
        return p


def _extend(p: _Path, length: int, pz: float, po, pi: int) -> int:
    p.feat[length] = pi
    p.zero[length] = pz
    p.one[length] = po
    p.pw[length] = 1.0 if length == 0 else 0.0
    for i in range(length - 1, -1, -1):
        p.pw[i + 1] += po * p.pw[i] * (i + 1) / (length + 1)
        p.pw[i] = pz * p.pw[i] * (length - i) / (length + 1)
    return length + 1


def _unwind(p: _Path, length: int, i: int) -> int:
    length -= 1
    po, pz = p.one[i], p.zero[i]
    hot = po != 0.0
    n = p.pw[length].copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        for j in range(length - 1, -1, -1):
            t = p.pw[j].copy()
            p.pw[j] = np.where(hot, n * (length + 1) / ((j + 1) * po),
                               p.pw[j] * (length + 1) / (pz * (length - j)))
            n = np.where(hot, t - p.pw[j] * pz * (length - j) / (length + 1),
                         n)
    for j in range(i, length):
        p.feat[j] = p.feat[j + 1]
        p.zero[j] = p.zero[j + 1]
        p.one[j] = p.one[j + 1]
    return length


def _unwound_sum(p: _Path, length: int, i: int):
    po, pz = p.one[i], p.zero[i]
    hot = po != 0.0
    total = np.zeros_like(po)
    n = p.pw[length - 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        for j in range(length - 2, -1, -1):
            t = n * length / ((j + 1) * po)
            total = total + np.where(
                hot, t, p.pw[j] * length / (pz * (length - 1 - j)))
            n = np.where(hot, p.pw[j] - t * pz * (length - 1 - j) / length, n)
    return total


def _tree_shap_recurse(t, X, leaves, node: int, p: _Path, length: int,
                       pz: float, po, pi: int):
    """The reference's recursion for all rows: the left child always comes
    first here (its one fraction is the row's ``io`` where the row goes
    left, else 0), and each leaf's terms ``(feature, (R,) value)`` are
    appended to ``leaves`` under its node id."""
    p = p.copy(length)
    length = _extend(p, length, pz, po, pi)
    left, right = t["left"][node], t["right"][node]
    if left < 0:  # leaf
        v = t["value"][node]
        leaves[node] = [(int(p.feat[i]),
                         _unwound_sum(p, length, i) * (p.one[i] - p.zero[i])
                         * v) for i in range(1, length)]
        return
    f = t["feat"][node]
    go_left = _go_left_rows(t, node, X[:, f])
    cover = t["cover"]
    rj = cover[node]
    iz, io = 1.0, np.ones(X.shape[0])
    # if this feature already on the path, undo its previous contribution
    k = -1
    for i in range(1, length):
        if p.feat[i] == f:
            k = i
            break
    if k >= 0:
        iz, io = p.zero[k], p.one[k].copy()
        length = _unwind(p, length, k)
    _tree_shap_recurse(t, X, leaves, left, p, length, iz * cover[left] / rj,
                       np.where(go_left, io, 0.0), f)
    _tree_shap_recurse(t, X, leaves, right, p, length,
                       iz * cover[right] / rj, np.where(go_left, 0.0, io), f)


def _visit_rank(t, X):
    """{leaf: (R,) the leaf's place in each row's order of the reference's
    recursion}, which visits the child a row goes to (the hot one) first:
    a leaf's place is the sum, over its ancestors whose cold child holds
    it, of the leaves under the hot sibling."""
    n_leaves = {}

    def count(node):
        if t["left"][node] < 0:
            n_leaves[node] = 1
        else:
            n_leaves[node] = count(t["left"][node]) + count(t["right"][node])
        return n_leaves[node]

    count(0)
    R = X.shape[0]
    ranks = {}

    def rec(node, rank):
        if t["left"][node] < 0:
            ranks[node] = rank
            return
        left, right = t["left"][node], t["right"][node]
        gl = _go_left_rows(t, node, X[:, t["feat"][node]])
        rec(left, rank + np.where(gl, 0, n_leaves[right]))
        rec(right, rank + np.where(gl, n_leaves[left], 0))

    rec(0, np.zeros(R, np.int64))
    return ranks


def _tree_arrays(tree) -> dict:
    n = tree.n_nodes
    value = np.where(tree.left_children == -1, tree.split_conditions,
                     0.0).astype(np.float64)
    cover = tree.sum_hessian.astype(np.float64)
    cover = np.maximum(cover, 1e-16)
    st = (tree.split_type if tree.split_type is not None
          else np.zeros(n, np.int32))
    cats = {nid: frozenset(int(c) for c in arr)
            for nid, arr in (tree.categories or {}).items()}
    return dict(
        left=tree.left_children, right=tree.right_children,
        feat=tree.split_indices, thr=tree.split_conditions.astype(np.float64),
        dleft=tree.default_left, value=value, cover=cover,
        is_cat=(st == 1), cats=cats,
    )


def _go_left_rows(t, node: int, xv: np.ndarray) -> np.ndarray:
    """The split decision of every row, categorical routing included
    (common/categorical.h: in the right set -> right; out of range or
    negative -> left; missing -> the default direction)."""
    missing = np.isnan(xv)
    if t["is_cat"][node]:
        cats = t["cats"].get(int(node))
        c = np.trunc(np.where(missing, -1.0, xv))  # int(xv)
        right = (c >= 0) & np.isin(c, np.fromiter(cats or (), np.float64))
        decide = ~right
    else:
        with np.errstate(invalid="ignore"):
            decide = xv < t["thr"][node]
    return np.where(missing, bool(t["dleft"][node]), decide)


def _expected_value(t) -> float:
    """Cover-weighted expectation of the tree output (phi_0 component)."""
    def rec(node: int) -> float:
        if t["left"][node] < 0:
            return t["value"][node]
        l, r = t["left"][node], t["right"][node]
        cl, cr = t["cover"][l], t["cover"][r]
        tot = max(cl + cr, 1e-16)
        return (cl * rec(l) + cr * rec(r)) / tot

    return rec(0)


# rows a host walk takes at once: its per-leaf terms are (leaves, depth, rows)
HOST_ROWS = 2048


def shap_values_tree(tree, X: np.ndarray) -> np.ndarray:
    """(R, F+1) exact TreeSHAP values of one tree (last column the bias),
    X f64: the reference's host walk (shap_values_tree), ``HOST_ROWS`` rows
    at once and each sum in the reference's order."""
    R, F = X.shape
    t = _tree_arrays(tree)
    out = np.zeros((R, F + 1), np.float64)
    for lo in range(0, R, HOST_ROWS):
        out[lo:lo + HOST_ROWS, :F] = _shap_rows(t, tree.max_depth + 2,
                                                X[lo:lo + HOST_ROWS])
    out[:, F] = _expected_value(t)
    return out


def _shap_rows(t, maxd: int, X: np.ndarray) -> np.ndarray:
    """(R, F) the features' SHAP values of one tree for the rows of X."""
    R, F = X.shape
    leaves: dict = {}
    _tree_shap_recurse(t, X, leaves, 0, _Path(maxd + 1, R), 0, 1.0,
                       np.ones(R), -1)
    ranks = _visit_rank(t, X)
    ids = sorted(leaves)
    width = max(len(leaves[n]) for n in ids)
    feat = np.full((len(ids), width), F, np.int64)  # column F takes the pads
    vals = np.zeros((len(ids), width, R), np.float64)
    order = np.empty((R, len(ids)), np.int64)
    rows = np.arange(R)
    for li, n in enumerate(ids):
        for i, (f, v) in enumerate(leaves[n]):
            feat[li, i], vals[li, i] = f, v
        order[rows, ranks[n]] = li
    out = np.zeros((R, F + 1), np.float64)
    for k in range(len(ids)):  # each row's k-th leaf in its visiting order
        li = order[:, k]
        for i in range(width):
            cols = feat[li, i]
            out[rows, cols] = out[rows, cols] + vals[li, i, rows]
    return out[:, :F]


def _node_values(t) -> np.ndarray:
    """Each node's cover-weighted expectation of the leaves below it, f64
    (the reference's ``fill``)."""
    nodeval = np.zeros(len(t["left"]), np.float64)

    def fill(node: int) -> float:
        if t["left"][node] < 0:
            nodeval[node] = t["value"][node]
            return nodeval[node]
        l, r = t["left"][node], t["right"][node]
        vl, vr = fill(l), fill(r)
        cl, cr = t["cover"][l], t["cover"][r]
        nodeval[node] = (cl * vl + cr * vr) / max(cl + cr, 1e-16)
        return nodeval[node]

    fill(0)
    return nodeval


def saabas_values_tree(tree, X: torch.Tensor) -> torch.Tensor:
    """(R, F+1) f64 Saabas contributions of one tree on X's device: per
    split on a row's decision path, ``nodeval[next] - nodeval[node]`` added
    at (row, feature), one level at a time (reference:
    saabas_values_tree, ApproximateFeatureContributions in shap.cc)."""
    R, F = X.shape
    dev = X.device
    t = _tree_arrays(tree)
    nodeval = torch.from_numpy(_node_values(t)).to(dev)
    left = torch.from_numpy(np.asarray(tree.left_children, np.int64)).to(dev)
    right = torch.from_numpy(np.asarray(tree.right_children, np.int64)).to(dev)
    feat = torch.from_numpy(np.asarray(tree.split_indices, np.int64)).to(dev)
    thr = torch.from_numpy(np.asarray(tree.split_conditions,
                                      np.float32)).to(dev)
    dleft = torch.from_numpy(np.asarray(tree.default_left, bool)).to(dev)
    catm = is_cat = None
    if tree.has_categorical:
        is_cat = torch.from_numpy(t["is_cat"]).to(dev)
        n_cats = tree.max_category + 1
        catm = torch.from_numpy(tree.cat_matrix(tree.n_nodes, n_cats)).to(dev)
    out = torch.zeros((R, F + 1), dtype=torch.float64, device=dev)
    out[:, F] += nodeval[0]
    node = torch.zeros(R, dtype=torch.int64, device=dev)
    for _ in range(tree.max_depth):
        inner = left[node] >= 0
        f = torch.where(inner, feat[node], 0)
        x = X.gather(1, f[:, None])[:, 0]
        gol = x < thr[node]
        if is_cat is not None:
            Bc = catm.shape[1]
            c = torch.nan_to_num(x, nan=-1.0).trunc()
            ci = c.clamp(0, Bc - 1).to(torch.int64)
            right_set = catm[node, ci] & (c >= 0) & (c < Bc)
            gol = torch.where(is_cat[node], ~right_set, gol)
        gol = torch.where(torch.isnan(x), dleft[node], gol)
        nxt = torch.where(gol, left[node], right[node])
        nxt = torch.where(inner, nxt, node)
        delta = torch.where(inner, nodeval[nxt] - nodeval[node], 0.0)
        out.scatter_add_(1, f[:, None], delta[:, None])
        node = nxt
    return out


def _trees_of(booster, tree_slice: slice):
    trees = booster.trees[tree_slice]
    if any(t.leaf_vector is not None for t in trees):
        raise ValueError(
            "pred_contribs and pred_interactions are not defined for "
            "vector-leaf (multi_strategy='multi_output_tree') models")
    return (trees, booster.tree_info[tree_slice],
            list(booster.tree_weights[tree_slice]))


def predict_contribs(booster, data, tree_slice: slice,
                     approx: bool = False) -> np.ndarray:
    """(R, F+1) or (R, K, F+1) contributions summing to the margin
    (reference: interpret/__init__.py predict_contribs).  Exact SHAP runs
    on the path tables whenever the ensemble qualifies (K6 on the card);
    categorical trees take the host walk; Saabas runs on the booster's
    device."""
    from .device import device_shap_supported, shap_values_device

    trees, info, wts = _trees_of(booster, tree_slice)
    R, F = data.num_row(), data.num_col()
    K = booster.n_groups
    base = np.asarray(booster.base_score, np.float64).reshape(-1)[:K]
    if approx or (trees and device_shap_supported(trees)):
        X = booster._device_X(data)
        out = torch.zeros((R, K, F + 1), dtype=torch.float64,
                          device=X.device)
        if approx:
            for tree, grp, w in zip(trees, info, wts):
                out[:, grp, :] += w * saabas_values_tree(tree, X)
        else:
            for grp in range(K):
                g_trees = [t for t, g in zip(trees, info) if g == grp]
                g_wts = [w for w, g in zip(wts, info) if g == grp]
                if g_trees:
                    out[:, grp, :] += shap_values_device(g_trees, g_wts, X)
        out = out.cpu().numpy()
    else:
        Xh = booster._host_dense(data).astype(np.float64)
        out = np.zeros((R, K, F + 1), np.float64)
        for tree, grp, w in zip(trees, info, wts):
            out[:, grp, :] += w * shap_values_tree(tree, Xh)
    out[:, :, F] += base[None, :]
    return out[:, 0, :] if K == 1 else out


def _leaf_paths_host(tree):
    """Per-leaf path tables with the node ids kept, so the per-row decision
    can go through the categorical routing (the device tables inline
    numeric thresholds only)."""
    t = _tree_arrays(tree)
    cover = np.maximum(t["cover"].astype(np.float64), 1e-16)
    out = []

    def rec(node, nodes):
        if t["left"][node] < 0:
            slots = {}
            z = []
            entries = []  # (node_id, went_left, slot)
            for nid, go_left in nodes:
                f = int(t["feat"][nid])
                child = t["left"][nid] if go_left else t["right"][nid]
                frac = cover[child] / cover[nid]
                if f not in slots:
                    slots[f] = len(z)
                    z.append(frac)
                else:
                    z[slots[f]] *= frac
                entries.append((nid, go_left, slots[f]))
            out.append(dict(entries=entries, z=np.asarray(z),
                            slot_feat=np.asarray(
                                sorted(slots, key=slots.get), np.int64),
                            v=float(t["value"][node])))
            return
        rec(int(t["left"][node]), nodes + [(node, True)])
        rec(int(t["right"][node]), nodes + [(node, False)])

    if t["left"][0] >= 0:
        rec(0, [])
    return t, out


def shap_interactions_tree(tree, X: np.ndarray) -> np.ndarray:
    """(R, F+1, F+1) interaction values of one tree, X f64 (reference:
    shap_interactions_tree): per leaf path and slot pair (i, j),

        phi_ij += v/2 (o_i - z_i)(o_j - z_j)
                  sum_k k!(m-2-k)!/(m-1)! e_k^{(-i,-j)}

    into both orientations; the diagonal is the SHAP value minus the row's
    off-diagonal sum; the bias row and column stay empty but for [F, F].
    Every row at once, each in the reference's order."""
    R, F = X.shape
    t, paths = _leaf_paths_host(tree)
    out = np.zeros((R, F + 1, F + 1), np.float64)
    base = shap_values_tree(tree, X)
    for p in paths:
        m = len(p["z"])
        if m < 2:
            continue
        o = np.ones((m, R))
        for nid, went_left, slot in p["entries"]:
            gl = _go_left_rows(t, nid, X[:, t["feat"][nid]])
            o[slot] = np.where(gl != went_left, 0.0, o[slot])
        z = p["z"]
        sf = p["slot_feat"]
        omz = o - z[:, None]
        for i in range(m):
            for j in range(i + 1, m):
                # elementary-symmetric coefficients without slots i, j
                c = [np.ones(R)] + [np.zeros(R)] * (m - 2)
                for e in range(m):
                    if e in (i, j):
                        continue
                    c = [c[k] * z[e] + (c[k - 1] * o[e] if k else 0.0)
                         for k in range(m - 1)]
                W = 0
                for k in range(m - 1):
                    W = W + (math.factorial(k) * math.factorial(m - 2 - k)
                             / math.factorial(m - 1)) * c[k]
                term = 0.5 * p["v"] * omz[i] * omz[j] * W
                out[:, sf[i], sf[j]] += term
                out[:, sf[j], sf[i]] += term
    # main effects on the diagonal: phi_i - sum_j!=i interactions
    for f in range(F + 1):
        out[:, f, f] = base[:, f] - (out[:, f, :].sum(axis=1) - out[:, f, f])
    return out


def predict_interactions(booster, data, tree_slice: slice,
                         use_device=None) -> np.ndarray:
    """(R, F+1, F+1) or (R, K, F+1, F+1) SHAP interaction values
    (reference: interpret/__init__.py predict_interactions): the path
    tables (K6 on the card) for numeric scalar ensembles from 128 rows,
    else the host walk."""
    from .device import device_shap_supported, shap_interactions_device

    trees, infos, ws = _trees_of(booster, tree_slice)
    R, F = data.num_row(), data.num_col()
    K = booster.n_groups
    base = np.asarray(booster.base_score, np.float64).reshape(-1)[:K]
    if use_device is None:
        use_device = device_shap_supported(trees) and R >= 128
    if use_device and device_shap_supported(trees):
        X = booster._device_X(data)
        out = torch.zeros((R, K, F + 1, F + 1), dtype=torch.float64,
                          device=X.device)
        for grp in range(K):
            tg = [t for t, g in zip(trees, infos) if g == grp]
            wg = [w for w, g in zip(ws, infos) if g == grp]
            if tg:
                out[:, grp] += shap_interactions_device(tg, wg, X)
        out = out.cpu().numpy()
    else:
        Xh = booster._host_dense(data).astype(np.float64)
        out = np.zeros((R, K, F + 1, F + 1), np.float64)
        for tree, grp, w in zip(trees, infos, ws):
            out[:, grp] += w * shap_interactions_tree(tree, Xh)
    out[:, :, F, F] += base[None, :]
    return out[:, 0] if K == 1 else out
