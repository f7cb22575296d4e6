"""K6 (csrc/treeshap.cu): exact TreeSHAP values and interaction terms of an
ensemble's path tables on the card, every bucket of every row in one
launch.

``pack_tables`` lays the buckets of ``interpret/device.py:PathTables`` out
flat, as the kernel reads them: per bucket a row of ``meta`` (path begin
and end, m, D, node base, slot base, weight offset, cell begin and end),
the nodes' features, thresholds, flags (bit 0 default left, bit 1 went
left) and slots, the paths' zero fractions, slot features and leaf
values, the Shapley weights of each bucket and the cells it touches
(which the kernel adds into its f64 totals at the bucket's end).  ``plan``
picks the rows of a block whose tiles fit in shared memory (0: the tiles
in global memory).  ``launch`` launches K6 once over packed tables and
counts it in ``hist_cuda.launches`` (``treeshap`` for the values,
``treeshap_interactions`` for the interaction terms); ``treeshap_cuda``
packs, launches and lays the result out by row; ``treeshap_model`` walks the
packed tables in the kernel's order in PyTorch, which the CPU tests hold
against the plain version.  ``work`` counts the bytes and f32 operations
a call needs, for its bound.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .hist_cuda import SMEM_BUDGET, launched, load_library, on_device

__all__ = ["Packed", "SMALL_M", "launch", "pack_tables", "plan",
           "treeshap_cuda", "treeshap_model", "work"]

SMALL_M = 8  # the kernel's kSmallM: paths up to this m keep registers
ROWS = (128, 64, 32)  # rows a block, largest first, where the tiles fit
META = 9


class Packed(NamedTuple):
    """A call's flat tables on one device, and the host facts of them."""
    meta: torch.Tensor  # (n_buckets, 9) int32
    node_feat: torch.Tensor
    node_thr: torch.Tensor
    node_flags: torch.Tensor  # uint8
    node_slot: torch.Tensor
    z: torch.Tensor
    slot_feat: torch.Tensor
    v: torch.Tensor
    wk: torch.Tensor
    cells: torch.Tensor
    interactions: bool
    n_feat: int
    max_m: int
    shapes: tuple  # ((m, D, P), ...) of the buckets, in order


def _shapley(m: int) -> np.ndarray:
    from ..interpret.device import shapley_weights

    return shapley_weights(m)


def pack_tables(tables, interactions: bool, device) -> Packed:
    """The flat tables of ``tables``' buckets (those with m >= 2 for the
    interactions) on ``device``."""
    F1 = tables.n_feat + 1
    meta, shapes = [], []
    cols = {k: [] for k in ("node_feat", "node_thr", "node_flags",
                            "node_slot", "z", "slot_feat", "v", "wk",
                            "cells")}
    n_path = n_node = n_slot = n_wk = n_cell = 0
    for (m, D), b in tables.buckets.items():
        if interactions and m < 2:
            continue
        P = len(b["v"])
        sf = b["slot_feat"].astype(np.int64)
        if interactions:
            s, j = np.triu_indices(m, 1)
            touched = np.concatenate([sf[:, s] * F1 + sf[:, j],
                                      sf[:, j] * F1 + sf[:, s]], axis=None)
            wk = _shapley(m - 1)
        else:
            touched = sf.reshape(-1)
            wk = _shapley(m)
        touched = np.unique(touched).astype(np.int32)
        meta.append([n_path, n_path + P, m, D, n_node, n_slot, n_wk, n_cell,
                     n_cell + len(touched)])
        shapes.append((m, D, P))
        cols["node_feat"].append(b["node_feat"].reshape(-1))
        cols["node_thr"].append(b["node_thr"].reshape(-1))
        cols["node_flags"].append((b["node_dleft"].astype(np.uint8)
                                   | (b["node_dir"].astype(np.uint8) << 1))
                                  .reshape(-1))
        cols["node_slot"].append(b["node_slot"].reshape(-1))
        cols["z"].append(b["z"].reshape(-1))
        cols["slot_feat"].append(b["slot_feat"].reshape(-1))
        cols["v"].append(b["v"])
        cols["wk"].append(wk)
        cols["cells"].append(touched)
        n_path += P
        n_node += P * D
        n_slot += P * m
        n_wk += len(wk)
        n_cell += len(touched)
    dtypes = dict(node_feat=np.int32, node_thr=np.float32,
                  node_flags=np.uint8, node_slot=np.int32, z=np.float32,
                  slot_feat=np.int32, v=np.float32, wk=np.float32,
                  cells=np.int32)

    def flat(k):
        a = (np.concatenate(cols[k]) if cols[k]
             else np.zeros(1, dtypes[k]))  # one pad: no empty pointers
        return torch.from_numpy(np.ascontiguousarray(a, dtypes[k])).to(device)

    return Packed(
        meta=torch.from_numpy(np.asarray(meta, np.int32).reshape(-1, META))
        .to(device),
        **{k: flat(k) for k in cols}, interactions=interactions,
        n_feat=tables.n_feat, max_m=max((s[0] for s in shapes), default=1),
        shapes=tuple(shapes))


def n_cells(n_feat: int, interactions: bool) -> int:
    return (n_feat + 1) ** 2 if interactions else n_feat + 1


def plan(n_feat: int, interactions: bool, budget: int = SMEM_BUDGET):
    """(rows a block, shared-memory bytes): the most rows of ``ROWS`` whose
    f64 totals, f32 sums and X rows fit ``budget``, at a stride of rows + 1;
    (0, 0) where none does (the tiles in global memory)."""
    cells = n_cells(n_feat, interactions)
    for rows in ROWS:
        smem = (rows + 1) * (cells * 8 + (n_feat + cells) * 4)
        if smem <= budget:
            return rows, smem
    return 0, 0


def launch(X, pk: Packed, rows_per_block=None):
    """One K6 launch on X's card over the packed tables ``pk``: the
    (cells, R) f64 totals, cell-major.  ``rows_per_block`` overrides the
    plan (the card tests force it).  A launch the card refuses raises."""
    if not X.is_cuda:
        raise ValueError("the TreeSHAP kernel needs a CUDA tensor")
    if X.dtype != torch.float32 or X.dim() != 2:
        raise TypeError("X must be a 2-D float32 tensor")
    R, F = X.shape
    if F != pk.n_feat or pk.meta.device != X.device:
        raise ValueError(f"X ({F} features, {X.device}) does not match the "
                         f"tables ({pk.n_feat} features, {pk.meta.device})")
    X = X.contiguous()
    cells = n_cells(F, pk.interactions)
    out = torch.empty((cells, R), dtype=torch.float64, device=X.device)
    if R == 0 or not pk.shapes:
        return out.zero_()
    rows = plan(F, pk.interactions)[0] if rows_per_block is None \
        else rows_per_block
    scratch = (None if rows else
               torch.empty((cells, R), dtype=torch.float32, device=X.device))
    poly = (None if pk.max_m <= SMALL_M else
            torch.empty((2 * pk.max_m, R), dtype=torch.float32,
                        device=X.device))
    lib = load_library("treeshap")
    entry = (lib.xtb_treeshap_interactions if pk.interactions
             else lib.xtb_treeshap)
    rc = on_device(
        X.device, entry, X.data_ptr(), R, F, len(pk.shapes),
        pk.meta.data_ptr(), pk.node_feat.data_ptr(), pk.node_thr.data_ptr(),
        pk.node_flags.data_ptr(), pk.node_slot.data_ptr(), pk.z.data_ptr(),
        pk.slot_feat.data_ptr(), pk.v.data_ptr(), pk.wk.data_ptr(),
        pk.cells.data_ptr(), pk.max_m, int(rows), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if poly is None else poly.data_ptr())
    launched("treeshap_interactions" if pk.interactions else "treeshap",
             lib, rc)
    return out


def treeshap_cuda(X, tables, interactions: bool = False,
                  rows_per_block=None):
    """K6 on X's card: the (R, F+1) f64 SHAP values of ``tables`` (bias
    column included), or the (R, F+1, F+1) f64 off-diagonal interaction
    terms; one launch."""
    if not X.is_cuda:
        raise ValueError("the TreeSHAP kernel needs a CUDA tensor")
    R, F = X.shape
    out = launch(X, tables.packed(interactions, X.device),
                 rows_per_block).t()
    if interactions:
        return out.reshape(R, F + 1, F + 1)
    out = out.contiguous()
    out[:, F] += tables.bias
    return out


def treeshap_model(X, tables, interactions: bool = False):
    """What K6 computes, in its order, as PyTorch operations over all rows
    at once: each bucket's paths in order, each path's slots (or slot
    pairs) in order, f32 sums of the cells, added into f64 totals at the
    bucket's end.  Returns what ``treeshap_cuda`` returns."""
    R, F = X.shape
    F1 = F + 1
    pk = pack_tables(tables, interactions, "cpu")
    X = X.cpu()
    meta = pk.meta.numpy()
    nf, thr = pk.node_feat.numpy(), pk.node_thr
    flags, slot = pk.node_flags.numpy(), pk.node_slot.numpy()
    z, sfeat, v, wk = pk.z, pk.slot_feat.numpy(), pk.v, pk.wk
    cells = n_cells(F, interactions)
    total = torch.zeros((cells, R), dtype=torch.float64)
    for p0, p1, m, D, nb0, sb0, wo, c0, c1 in meta:
        tile = torch.zeros((cells, R), dtype=torch.float32)
        for p in range(p0, p1):
            nb, sb = nb0 + (p - p0) * D, sb0 + (p - p0) * m
            o = torch.ones((m, R))
            for d in range(nb, nb + D):
                x = X[:, nf[d]]
                gol = torch.where(torch.isnan(x), bool(flags[d] & 1),
                                  x < thr[d])
                o[slot[d]] = torch.where(gol != bool(flags[d] & 2), 0.0,
                                         o[slot[d]])
            zp = z[sb:sb + m]

            def weight_sum(skip, n):
                c = [torch.ones(R)] + [None] * n
                others = [e for e in range(m) if e not in skip]
                for jj, e in enumerate(others):
                    c[jj + 1] = c[jj] * o[e]
                    for k in range(jj, 0, -1):
                        c[k] = c[k] * zp[e] + c[k - 1] * o[e]
                    c[0] = c[0] * zp[e]
                W = torch.zeros(R)
                for k in range(n + 1):
                    W = W + wk[wo + k] * c[k]
                return W

            if not interactions:
                for i in range(m):
                    phi = (o[i] - zp[i]) * v[p] * weight_sum((i,), m - 1)
                    tile[sfeat[sb + i]] += phi
            else:
                hv = 0.5 * v[p]
                for s in range(m):
                    for j in range(s + 1, m):
                        term = (hv * (o[s] - zp[s]) * (o[j] - zp[j])
                                * weight_sum((s, j), m - 2))
                        fs, fj = sfeat[sb + s], sfeat[sb + j]
                        tile[fs * F1 + fj] += term
                        tile[fj * F1 + fs] += term
        touched = pk.cells[c0:c1].long()
        total[touched] += tile[touched].double()
    out = total.t()
    if interactions:
        return out.reshape(R, F1, F1)
    out = out.contiguous()
    out[:, F] += tables.bias
    return out


def work(tables, n_rows: int, interactions: bool = False):
    """(bytes, f32 operations) a call needs: X read once and the f64
    output written once; per (row, path) of a bucket of m slots the
    kernel's multiplies, adds and subtracts: for each element (or pair)
    the polynomial over the n = m-1 (m-2) others (2n + 1.5 n(n-1)), its
    n+1 weighted terms (2(n+1)) and the term with its add (4; 7 for a
    pair, whose term also takes the 1/2 and is added twice)."""
    F = tables.n_feat
    bytes_ = 4 * n_rows * F + 8 * n_rows * n_cells(F, interactions)
    ops = 0
    for (m, D), b in tables.buckets.items():
        P = len(b["v"])
        if interactions:
            n, terms, extra = m - 2, m * (m - 1) // 2, 7
        else:
            n, terms, extra = m - 1, m, 4
        if n < 0:
            continue
        per = 2 * n + 1.5 * n * (n - 1) + 2 * (n + 1) + extra
        ops += n_rows * P * terms * per
    return bytes_, ops
