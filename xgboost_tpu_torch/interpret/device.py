"""Exact TreeSHAP and its interaction values over path tables (port of
xgboost_tpu/interpret/device.py).

Every root->leaf path of a scalar, numeric ensemble is extracted once on
the host into fixed-shape tables, grouped into buckets by (m unique
features, D nodes).  A leaf L reached through unique features 1..m, each
with a zero fraction z_i (product of cover ratios) and a row's one fraction
o_i in {0, 1}, adds

    phi_i += v_L (o_i - z_i) sum_k e_k(i) k! (m-1-k)! / m!

where e_k(i) are the coefficients of prod_{j != i} (z_j + o_j t), rebuilt
for each element in f32 (Lundberg et al. 2018, path-dependent).

``bucket_phi_plain`` and ``bucket_interactions_plain`` are the reference's
per-bucket XLA programs (``_bucket_phi``, ``_bucket_interactions``) in
PyTorch operations, in the same per-element f32 order; ``index_add_`` is
the scatter.  A bucket sums in f32, buckets (and row chunks) meet in f64.
``shap_values_device`` and ``shap_interactions_device`` send a CPU tensor
through them and a CUDA tensor to K6 (``ops/treeshap_cuda.py``), which
computes every bucket of every row in one launch.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["PathTables", "bucket_interactions_plain", "bucket_phi_plain",
           "device_shap_supported", "path_tables", "shap_interactions_device",
           "shap_interactions_plain", "shap_values_device",
           "shap_values_plain", "shapley_weights"]

_KEYS = ("node_feat", "node_thr", "node_dleft", "node_dir", "node_slot", "z",
         "slot_feat", "v")


def _leaf_paths(tree) -> List[dict]:
    """Walk root->leaf; per leaf return node-level arrays + unique-slot map."""
    t_left = tree.left_children
    t_right = tree.right_children
    t_feat = tree.split_indices
    t_thr = tree.split_conditions
    t_dleft = tree.default_left
    cover = np.maximum(tree.sum_hessian.astype(np.float64), 1e-16)
    leaf_val = np.where(t_left == -1, tree.split_conditions, 0.0)

    out: List[dict] = []

    def rec(node: int, nodes: list):
        if t_left[node] == -1:
            # condense duplicate features into unique slots
            slots: Dict[int, int] = {}
            z_mult: List[float] = []
            node_feat, node_thr, node_dleft, node_dir, node_slot = \
                [], [], [], [], []
            for (nid, go_left) in nodes:
                f = int(t_feat[nid])
                child = t_left[nid] if go_left else t_right[nid]
                frac = cover[child] / cover[nid]
                if f not in slots:
                    slots[f] = len(z_mult)
                    z_mult.append(frac)
                else:
                    z_mult[slots[f]] *= frac
                node_feat.append(f)
                node_thr.append(float(t_thr[nid]))
                node_dleft.append(bool(t_dleft[nid]))
                node_dir.append(bool(go_left))
                node_slot.append(slots[f])
            out.append(dict(
                node_feat=np.asarray(node_feat, np.int32),
                node_thr=np.asarray(node_thr, np.float32),
                node_dleft=np.asarray(node_dleft, bool),
                node_dir=np.asarray(node_dir, bool),
                node_slot=np.asarray(node_slot, np.int32),
                z=np.asarray(z_mult, np.float64),
                slot_feat=np.asarray(sorted(slots, key=slots.get), np.int32),
                v=float(leaf_val[node]),
            ))
            return
        rec(int(t_left[node]), nodes + [(node, True)])
        rec(int(t_right[node]), nodes + [(node, False)])

    if t_left[0] == -1:  # stump: all mass at the bias
        return []
    rec(0, [])
    return out


def _bucket_paths(paths: List[dict], tree_weight: float):
    """Group per-leaf paths by (m, D) -> stacked fixed-shape arrays."""
    buckets: Dict[Tuple[int, int], List[dict]] = {}
    for p in paths:
        buckets.setdefault((len(p["z"]), len(p["node_feat"])), []).append(p)
    out = {}
    for (m, D), plist in buckets.items():
        out[(m, D)] = dict(
            node_feat=np.stack([p["node_feat"] for p in plist]),
            node_thr=np.stack([p["node_thr"] for p in plist]),
            node_dleft=np.stack([p["node_dleft"] for p in plist]),
            node_dir=np.stack([p["node_dir"] for p in plist]),
            node_slot=np.stack([p["node_slot"] for p in plist]),
            z=np.stack([p["z"] for p in plist]).astype(np.float32),
            slot_feat=np.stack([p["slot_feat"] for p in plist]),
            v=np.asarray([p["v"] * tree_weight for p in plist], np.float32),
        )
    return out


def device_shap_supported(trees) -> bool:
    """The path tables cover scalar-leaf, non-categorical ensembles."""
    return all(not t.has_categorical and t.leaf_vector is None for t in trees)


def shapley_weights(m: int) -> np.ndarray:
    """(m,) f32 k! (m-1-k)! / m!, the Shapley weights of m elements."""
    return np.asarray(
        [math.factorial(k) * math.factorial(m - 1 - k) / math.factorial(m)
         for k in range(m)], np.float32)


class PathTables:
    """An ensemble's path tables: ``buckets`` {(m, D): {name: array}} with
    their paths in tree order, merged across trees and sorted by (m, D);
    ``bias`` the f64 sum of each tree's weight times its expectation, in
    tree order; ``n_feat`` F."""

    def __init__(self, buckets: dict, bias: float, n_feat: int):
        self.buckets = buckets
        self.bias = bias
        self.n_feat = n_feat
        self._packed: dict = {}

    def packed(self, interactions: bool, device):
        """The flat tables K6 reads, on ``device`` (made once each)."""
        key = (interactions, str(device))
        if key not in self._packed:
            from ..ops.treeshap_cuda import pack_tables

            self._packed[key] = pack_tables(self, interactions, device)
        return self._packed[key]


def path_tables(trees, tree_weights, n_feat: int) -> PathTables:
    from . import _expected_value, _tree_arrays

    bias = 0.0
    merged: Dict[Tuple[int, int], List[dict]] = {}
    for tree, w in zip(trees, tree_weights):
        bias += w * _expected_value(_tree_arrays(tree))
        for key, b in _bucket_paths(_leaf_paths(tree), w).items():
            merged.setdefault(key, []).append(b)
    buckets = {key: {k: np.concatenate([p[k] for p in parts]) for k in _KEYS}
               for key, parts in sorted(merged.items())}
    return PathTables(buckets, bias, n_feat)


def _tensors(b: dict, device) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(b[k])).to(device)
                 for k in _KEYS)


def _one_fractions(X, node_feat, node_thr, node_dleft, node_dir, node_slot,
                   m: int):
    """(R, P, m) f32 o: 1 where the row follows every node of the slot."""
    R = X.shape[0]
    P, D = node_feat.shape
    xv = X[:, node_feat.reshape(-1).long()].reshape(R, P, D)
    gol = torch.where(torch.isnan(xv), node_dleft[None], xv < node_thr[None])
    ok = gol == node_dir[None]  # (R, P, D)
    bad = torch.zeros((R, P, m), dtype=torch.uint8, device=X.device)
    bad.scatter_reduce_(2, node_slot[None].long().expand(R, P, D),
                        (~ok).to(torch.uint8), reduce="amax")
    return (bad == 0).to(torch.float32)


def bucket_phi_plain(X, node_feat, node_thr, node_dleft, node_dir, node_slot,
                     z, slot_feat, v, wk, *, m: int, n_feat: int):
    """(R, F+1) f32 SHAP contribution of one bucket of paths (reference
    interpret/device.py:114 ``_bucket_phi``).  X (R, F) f32; path tables
    (P, D) / (P, m); wk (m,) = k! (m-1-k)! / m!."""
    R = X.shape[0]
    P = node_feat.shape[0]
    o = _one_fractions(X, node_feat, node_thr, node_dleft, node_dir,
                       node_slot, m)
    zf = z[None]  # (1, P, m)
    phis = []
    for i in range(m):
        # poly of the other elements: c[k] coefficients, built in f32
        c = [torch.ones((R, P), device=X.device)] + \
            [torch.zeros((R, P), device=X.device)] * (m - 1)
        for j in range(m):
            if j == i:
                continue
            zj = zf[..., j]
            oj = o[..., j]
            nc = []
            for k in range(m):
                term = c[k] * zj
                if k > 0:
                    term = term + c[k - 1] * oj
                nc.append(term)
            c = nc
        W = 0
        for k in range(m):
            W = W + wk[k] * c[k]  # (R, P)
        phis.append((o[..., i] - zf[..., i]) * v[None] * W)
    phi_elems = torch.stack(phis, dim=-1)  # (R, P, m)
    out = torch.zeros((R, n_feat + 1), dtype=torch.float32, device=X.device)
    out.index_add_(1, slot_feat.reshape(-1).long(),
                   phi_elems.reshape(R, P * m))
    return out


def bucket_interactions_plain(X, node_feat, node_thr, node_dleft, node_dir,
                              node_slot, z, slot_feat, v, wk1, *, m: int,
                              n_feat: int):
    """(R, F+1, F+1) f32 off-diagonal interaction terms of one bucket
    (reference interpret/device.py:210 ``_bucket_interactions``): per path
    and unordered slot pair (s, j),

        term = v/2 (o_s - z_s)(o_j - z_j) sum_k wk1[k] c_k^{(-s, -j)}

    added into [f_s, f_j] and [f_j, f_s]; wk1 (m-1,) the Shapley weights of
    m-1 elements."""
    R = X.shape[0]
    P = node_feat.shape[0]
    F1 = n_feat + 1
    o = _one_fractions(X, node_feat, node_thr, node_dleft, node_dir,
                       node_slot, m)
    zf = z[None].expand(o.shape)
    omz = o - zf
    out = torch.zeros((R, F1 * F1), dtype=torch.float32, device=X.device)
    sf = slot_feat.long()
    for s in range(m):
        for j in range(s + 1, m):
            # poly over the other m-2 elements, f32
            c = [torch.ones((R, P), device=X.device)] + \
                [torch.zeros((R, P), device=X.device)] * max(m - 2, 0)
            for e in range(m):
                if e == s or e == j:
                    continue
                ze = zf[..., e]
                oe = o[..., e]
                nc = []
                for k in range(m - 1):
                    term = c[k] * ze
                    if k > 0:
                        term = term + c[k - 1] * oe
                    nc.append(term)
                c = nc
            W = 0
            for k in range(m - 1):
                W = W + wk1[k] * c[k]
            term = 0.5 * v[None] * omz[..., s] * omz[..., j] * W
            out.index_add_(1, sf[:, s] * F1 + sf[:, j], term)
            out.index_add_(1, sf[:, j] * F1 + sf[:, s], term)
    return out.reshape(R, F1, F1)


def _row_chunk(R: int, per_row: int, budget: int, floor: int) -> int:
    return int(min(R, max(floor, budget // max(per_row, 1))))


def shap_values_plain(X, tables: PathTables,
                      budget_elems: int = 1 << 24) -> torch.Tensor:
    """(R, F+1) f64 summed SHAP values of the tables' buckets by the plain
    version, bias column included, on X's device: each bucket in f32 over
    row chunks of about ``budget_elems`` (R, P, D) elements, added in f64
    in (m, D) order (reference ``shap_values_device``)."""
    R, F = X.shape
    out = torch.zeros((R, F + 1), dtype=torch.float64, device=X.device)
    out[:, F] = tables.bias
    for (m, D), b in tables.buckets.items():
        args = _tensors(b, X.device)
        wk = torch.from_numpy(shapley_weights(m)).to(X.device)
        chunk = _row_chunk(R, len(b["v"]) * D, budget_elems, 256)
        for lo in range(0, R, chunk):
            out[lo:lo + chunk] += bucket_phi_plain(
                X[lo:lo + chunk], *args, wk, m=m, n_feat=F).double()
    return out


def shap_interactions_plain(X, tables: PathTables,
                            budget_elems: int = 1 << 22) -> torch.Tensor:
    """(R, F+1, F+1) f64 summed off-diagonal interaction terms of the
    tables' buckets by the plain version (diagonal zero), on X's device."""
    R, F = X.shape
    out = torch.zeros((R, F + 1, F + 1), dtype=torch.float64, device=X.device)
    for (m, D), b in tables.buckets.items():
        if m < 2:
            continue  # single-feature paths have no pairs
        args = _tensors(b, X.device)
        wk1 = torch.from_numpy(shapley_weights(m - 1)).to(X.device)
        chunk = _row_chunk(R, len(b["v"]) * m * m, budget_elems, 64)
        for lo in range(0, R, chunk):
            out[lo:lo + chunk] += bucket_interactions_plain(
                X[lo:lo + chunk], *args, wk1, m=m, n_feat=F).double()
    return out


def shap_values_device(trees, tree_weights, X) -> torch.Tensor:
    """(R, F+1) f64 summed exact SHAP values of scalar, non-categorical
    trees on X's device: K6 for a CUDA tensor, the plain version for a CPU
    tensor."""
    tables = path_tables(trees, tree_weights, X.shape[1])
    if X.is_cuda:
        from ..ops.treeshap_cuda import treeshap_cuda

        return treeshap_cuda(X, tables)
    return shap_values_plain(X, tables)


def shap_interactions_device(trees, tree_weights, X) -> torch.Tensor:
    """(R, F+1, F+1) f64 summed exact SHAP interactions of scalar,
    non-categorical trees on X's device (reference
    ``shap_interactions_device``): off-diagonals from K6 (CUDA) or the
    plain version (CPU); each diagonal the SHAP value minus the row's
    off-diagonal sum."""
    tables = path_tables(trees, tree_weights, X.shape[1])
    if X.is_cuda:
        from ..ops.treeshap_cuda import treeshap_cuda

        out = treeshap_cuda(X, tables, interactions=True)
        phi = treeshap_cuda(X, tables)
    else:
        out = shap_interactions_plain(X, tables)
        phi = shap_values_plain(X, tables)
    diag = torch.diagonal(out, dim1=1, dim2=2)  # zero: only pairs were added
    diag.copy_(phi - (out.sum(dim=2) - diag))
    return out
