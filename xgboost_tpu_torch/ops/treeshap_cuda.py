"""K6 (csrc/treeshap.cu): exact TreeSHAP values and interaction terms of an
ensemble's path tables on the card, every bucket of every row in one
launch.

A term depends on a row only through the m-bit mask of the path's slots
the row leaves, so K6 first tabulates every path's terms at each of its
2^m masks (paths of up to ``SMALL_M`` slots, in buckets that fit the
table's budget ``TAB_BYTES``, in calls of at least 2^m rows) and each row
then reads its terms at its mask; the other paths compute their terms a
row.  Either way each term is the same f32 operations on the same values
as the plain version's, and ``term_ops`` counts them.

``pack_tables`` lays the buckets of ``interpret/device.py:PathTables`` out
flat, as the kernel reads them: per bucket a row of ``meta`` (path begin
and end, m, D, node base, slot base, weight offset, touched-cell begin
and end, path-cell base, table base or -1), one 8-byte record a node (feature,
slot and flags in one int, the threshold's bits), the paths' zero
fractions and leaf values, the Shapley weights of each bucket, each
bucket's touched cells (as indices into the union of every bucket's),
each path's cells as indices into its bucket's list, and each output
cell's index into the union (-1: no bucket touches it).  ``plan`` picks
the rows of a block and of a thread whose tiles fit in shared memory (0:
the tiles in global memory).  ``launch`` launches K6 once over packed
tables and counts it in ``hist_cuda.launches`` (``treeshap`` for the
values, ``treeshap_interactions`` for the interaction terms);
``treeshap_cuda`` launches and shapes the result; ``treeshap_model`` walks
the packed tables in the kernel's order in PyTorch, which the CPU tests
hold against the plain version.  ``work`` counts the bytes and
operations a call needs, for its bound.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .hist_cuda import SMEM_BUDGET, launched, load_library, on_device

__all__ = ["Packed", "SMALL_M", "TAB_BYTES", "launch", "pack_tables",
           "path_terms", "plan", "tab_floats", "tabulated", "term_ops",
           "treeshap_cuda", "treeshap_model", "work"]

SMALL_M = 8  # the kernel's kSmallM: paths up to this m are tabulated
# the tabulated terms' scratch a launch at most (buckets in order, each
# whole or not at all; the rest compute their terms a row): 8 KB a path of
# m = 8 for the values, 28 KB for the interactions
TAB_BYTES = 1 << 28
INT32_MAX = (1 << 31) - 1  # the kernel's offsets are int32
THREADS = (128, 64, 32)  # threads a block, largest first, where tiles fit
ROWS_PER_THREAD = (2, 1)  # rows a thread the kernel takes, preferred first
# two rows a thread only where an SM still holds this many warps beside
# the blocks' shared memory (H100: 228 KB an SM, 1 KB of it a block)
MIN_WARPS = 16
SMEM_PER_SM = 228 * 1024
GLOBAL_ROWS = 128  # the kernel's kGlobalRows: a block with global tiles
META = 11
MAX_FEAT = 1 << 21  # a node record's feature field
MAX_SLOTS = 256  # a node record's slot field


class Packed(NamedTuple):
    """A call's flat tables on one device, and the host facts of them."""
    meta: torch.Tensor  # (n_buckets, 11) int32
    node: torch.Tensor  # (n_nodes, 2) int32: the packed word, thr's bits
    z: torch.Tensor
    v: torch.Tensor
    wk: torch.Tensor
    cells: torch.Tensor  # each bucket's touched cells, as union indices
    pcell: torch.Tensor  # each path's cells, as bucket-local indices
    out_u: torch.Tensor  # each output cell's union index, or -1
    interactions: bool
    n_feat: int
    max_m: int
    tile_max: int  # the longest touched list of a bucket
    n_union: int
    tab_off: tuple  # each bucket's table base, or -1 (not tabulated)
    bias: float
    shapes: tuple  # ((m, D, P), ...) of the buckets, in order


def _shapley(m: int) -> np.ndarray:
    from ..interpret.device import shapley_weights

    return shapley_weights(m)


def n_cells(n_feat: int, interactions: bool) -> int:
    return (n_feat + 1) ** 2 if interactions else n_feat + 1


def n_terms(m: int, interactions: bool) -> int:
    return m * (m - 1) // 2 if interactions else m


def pack_tables(tables, interactions: bool, device,
                tab_bytes: int = TAB_BYTES) -> Packed:
    """The flat tables of ``tables``' buckets (those with m >= 2 for the
    interactions) on ``device``; a bucket of m <= ``SMALL_M`` has room in
    the table where its terms fit what is left of ``tab_bytes``."""
    F1 = tables.n_feat + 1
    if tables.n_feat >= MAX_FEAT:
        raise ValueError(f"K6 takes fewer than {MAX_FEAT} features")
    meta, shapes, touched_lists = [], [], []
    cols = {k: [] for k in ("node", "z", "v", "wk", "pcell")}
    n_path = n_node = n_slot = n_wk = n_cell = n_pcell = n_tab = 0
    for (m, D), b in tables.buckets.items():
        if interactions and m < 2:
            continue
        if m > MAX_SLOTS:
            raise ValueError(f"K6 takes paths of at most {MAX_SLOTS} "
                             f"features (this one has {m})")
        P = len(b["v"])
        sf = b["slot_feat"].astype(np.int64)
        if interactions:  # [f_s, f_j] and [f_j, f_s] share one sum
            s, j = np.triu_indices(m, 1)  # the (s, j) order
            lo = np.minimum(sf[:, s], sf[:, j])
            cells = lo * F1 + np.maximum(sf[:, s], sf[:, j])
            wk = _shapley(m - 1)
        else:
            cells = sf
            wk = _shapley(m)
        touched, local = np.unique(cells.reshape(-1), return_inverse=True)
        tab = P * n_terms(m, interactions) << m if m <= SMALL_M else 0
        tab_at = n_tab if tab and 4 * (n_tab + tab) <= tab_bytes else -1
        meta.append([n_path, n_path + P, m, D, n_node, n_slot, n_wk, n_cell,
                     n_cell + len(touched), n_pcell, tab_at])
        shapes.append((m, D, P))
        word = (b["node_feat"].astype(np.int64) << 10
                | b["node_slot"].astype(np.int64) << 2
                | b["node_dir"].astype(np.int64) << 1
                | b["node_dleft"].astype(np.int64))
        thr = np.ascontiguousarray(b["node_thr"], np.float32).view(np.int32)
        cols["node"].append(np.stack([word.reshape(-1), thr.reshape(-1)],
                                     axis=-1))
        cols["z"].append(b["z"].reshape(-1))
        cols["v"].append(b["v"])
        cols["wk"].append(wk)
        cols["pcell"].append(local.reshape(-1))
        touched_lists.append(touched)
        n_path += P
        n_node += P * D
        n_slot += P * m
        n_wk += len(wk)
        n_cell += len(touched)
        n_pcell += cells.size
        n_tab += tab if tab_at >= 0 else 0
        if max(n_node, n_slot, n_pcell, n_tab) > INT32_MAX:
            raise ValueError("K6's tables need offsets past int32")
    union = (np.unique(np.concatenate(touched_lists)) if touched_lists
             else np.zeros(0, np.int64))
    out_u = np.full(n_cells(tables.n_feat, interactions), -1, np.int32)
    out_u[union] = np.arange(len(union))
    if interactions:  # the transposed cell reads the same sum
        out_u[union % F1 * F1 + union // F1] = np.arange(len(union))
    flat = {k: np.concatenate(v) for k, v in cols.items() if v}
    flat["cells"] = (np.searchsorted(union, np.concatenate(touched_lists))
                     if touched_lists else None)
    dtypes = dict(node=np.int32, z=np.float32, v=np.float32, wk=np.float32,
                  cells=np.int32, pcell=np.int32)

    def dev(k):
        a = flat.get(k)
        if a is None:  # one pad: no empty pointers
            a = np.zeros((1, 2) if k == "node" else 1, dtypes[k])
        return torch.from_numpy(np.ascontiguousarray(a, dtypes[k])).to(device)

    return Packed(
        meta=torch.from_numpy(np.asarray(meta, np.int32).reshape(-1, META))
        .to(device),
        **{k: dev(k) for k in dtypes},
        out_u=torch.from_numpy(out_u).to(device), interactions=interactions,
        n_feat=tables.n_feat, max_m=max((s[0] for s in shapes), default=1),
        tile_max=max((len(t) for t in touched_lists), default=0),
        n_union=len(union), tab_off=tuple(r[10] for r in meta),
        bias=0.0 if interactions else float(tables.bias),
        shapes=tuple(shapes))


def tabulated(pk: Packed, i: int, n_rows: int) -> bool:
    """Does phase 1 tabulate bucket ``i``'s terms in a call of ``n_rows``
    rows?  (The kernel's ``tabulated``: where it has room in the table
    and the call has at least 2^m rows.)"""
    return pk.tab_off[i] >= 0 and (1 << pk.shapes[i][0]) <= n_rows


def tab_floats(pk: Packed, n_rows: int) -> int:
    """The table's floats a call of ``n_rows`` rows fills."""
    return max((pk.tab_off[i] + (P * n_terms(m, pk.interactions) << m)
                for i, (m, _, P) in enumerate(pk.shapes)
                if tabulated(pk, i, n_rows)), default=0)


def smem_bytes(pk: Packed, rows: int) -> int:
    """Shared memory of a block of ``rows`` rows: the f64 totals of the
    union at a stride of rows + 1, X's rows and the bucket's f32 sums."""
    return 8 * pk.n_union * (rows + 1) + 4 * rows * (pk.n_feat + pk.tile_max)


def warps_per_sm(threads: int, smem: int) -> int:
    """Warps an SM holds of blocks of ``threads`` and ``smem`` bytes, by
    their shared memory and threads (not their registers)."""
    return min(SMEM_PER_SM // (smem + 1024), 2048 // threads) * threads // 32


def plan(pk: Packed, rows_per_thread=None, budget: int = SMEM_BUDGET):
    """(rows a block, rows a thread, shared-memory bytes): the most
    threads of ``THREADS`` whose block fits ``budget`` at
    ``rows_per_thread`` rows each (default: two, where an SM still holds
    ``MIN_WARPS`` warps of such blocks, else one), else 32 rows of one a
    thread; (0, 1, 0) where none fits (the tiles in global memory)."""
    for rt in ((rows_per_thread,) if rows_per_thread else ROWS_PER_THREAD):
        for threads in THREADS:
            smem = smem_bytes(pk, threads * rt)
            if smem > budget or (not rows_per_thread and rt > 1 and
                                 warps_per_sm(threads, smem) < MIN_WARPS):
                continue
            return threads * rt, rt, smem
    smem = smem_bytes(pk, THREADS[-1])
    return (THREADS[-1], 1, smem) if smem <= budget else (0, 1, 0)


def launch(X, pk: Packed, rows_per_block=None, rows_per_thread=None):
    """One K6 launch on X's card over the packed tables ``pk``: the (R,
    cells) f64 result, row-major, the bias in column F of the values.
    ``rows_per_block`` and ``rows_per_thread`` override the plan (the card
    tests force them; 0 rows a block: the global tiles).  A launch the
    card refuses raises."""
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
    out = torch.empty((R, cells), dtype=torch.float64, device=X.device)
    if R == 0 or not pk.shapes:
        out.zero_()
        if not pk.interactions:
            out[:, F] += pk.bias
        return out
    if rows_per_block is None:
        rows, rt, _ = plan(pk, rows_per_thread)
    else:
        rows, rt = rows_per_block, rows_per_thread or ROWS_PER_THREAD[0]
    if rows == 0:
        rt = 1
    block = rows if rows else GLOBAL_ROWS
    r_pad = -(-R // block) * block
    dev = X.device

    def scratch(n, dtype):
        return torch.empty((n, r_pad), dtype=dtype, device=dev)

    gtile = None if rows else scratch(max(pk.tile_max, 1), torch.float32)
    gtotal = None if rows else scratch(max(pk.n_union, 1), torch.float64)
    poly = None if all(tabulated(pk, i, R) for i in range(len(pk.shapes))) \
        else scratch(4 * pk.max_m, torch.float32)  # terms computed a row
    tab = torch.empty(max(tab_floats(pk, R), 1), dtype=torch.float32,
                      device=dev)
    barrier = torch.empty(1, dtype=torch.int32, device=dev)
    lib = load_library("treeshap")
    entry = (lib.xtb_treeshap_interactions if pk.interactions
             else lib.xtb_treeshap)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = on_device(
        dev, entry, X.data_ptr(), R, F, len(pk.shapes), pk.meta.data_ptr(),
        pk.node.data_ptr(), pk.z.data_ptr(), pk.v.data_ptr(),
        pk.wk.data_ptr(), pk.cells.data_ptr(), pk.pcell.data_ptr(),
        pk.out_u.data_ptr(), pk.n_union, pk.tile_max, pk.max_m, r_pad,
        pk.bias, int(rows), int(rt), tab.data_ptr(), out.data_ptr(),
        ptr(gtile), ptr(gtotal), ptr(poly), barrier.data_ptr())
    launched("treeshap_interactions" if pk.interactions else "treeshap",
             lib, rc)
    return out


def treeshap_cuda(X, tables, interactions: bool = False,
                  rows_per_block=None, rows_per_thread=None):
    """K6 on X's card: the (R, F+1) f64 SHAP values of ``tables`` (bias
    column included), or the (R, F+1, F+1) f64 off-diagonal interaction
    terms; one launch."""
    if not X.is_cuda:
        raise ValueError("the TreeSHAP kernel needs a CUDA tensor")
    R, F = X.shape
    out = launch(X, tables.packed(interactions, X.device), rows_per_block,
                 rows_per_thread)
    return out.view(R, F + 1, F + 1) if interactions else out


# ------------------------------------------------------- the kernel's order
def _extend(c, pos, z, o):
    """The coefficients c (of pos elements) times (z + o t), in place."""
    c[pos + 1] = c[pos] * o  # c_{pos+1} was 0: 0 z + c_pos o
    for k in range(pos, 0, -1):
        c[k] = c[k] * z + c[k - 1] * o
    c[0] = c[0] * z


def _weight_sum(c, w, n):
    s = w[0] * c[0]  # 0 + x is x: every product is +0 or positive
    for k in range(1, n):
        s = s + w[k] * c[k]
    return s


def path_terms(o, z, v, w, interactions: bool):
    """Every term of a path, in the kernel's order (element i, or pair
    (s, j)), from its one fractions o (..., m) f32, zero fractions z
    (..., m), leaf value v (...) and Shapley weights w: (..., terms) f32.
    Each element's coefficients start from the prefix of the elements
    before it, built once (a pair's from its elements before j): the same
    operations in the same order as the plain version's, computed once."""
    m = o.shape[-1]
    zs = [z[..., s] for s in range(m)]
    os_ = [o[..., s] for s in range(m)]
    one = torch.ones_like(o[..., 0])
    pre = [one] + [None] * m
    out = []
    if not interactions:
        for i in range(m):
            c = list(pre)
            for j in range(i + 1, m):
                _extend(c, j - 1, zs[j], os_[j])
            W = _weight_sum(c, w, m)
            out.append((os_[i] - zs[i]) * v * W)
            if i + 1 < m:
                _extend(pre, i, zs[i], os_[i])
    else:
        hv = 0.5 * v
        for s in range(m - 1):
            omz_s = os_[s] - zs[s]
            qc = list(pre)
            for j in range(s + 1, m):
                c = list(qc)
                for e in range(j + 1, m):
                    _extend(c, e - 2, zs[e], os_[e])
                W = _weight_sum(c, w, m - 1)
                out.append(hv * omz_s * (os_[j] - zs[j]) * W)
                if j + 1 < m:
                    _extend(qc, j - 1, zs[j], os_[j])
            if s + 2 < m:
                _extend(pre, s, zs[s], os_[s])
    return torch.stack(out, dim=-1)


def term_ops(m: int, interactions: bool) -> int:
    """f32 operations of ``path_terms`` at one set of one fractions."""
    def ext(pos):
        return 2 + 3 * pos

    ops = 0
    if not interactions:
        for i in range(m):
            ops += sum(ext(j - 1) for j in range(i + 1, m))
            ops += 2 * m - 1 + 3  # the weight sum, then the term
            if i + 1 < m:
                ops += ext(i)
        return ops
    ops += 1  # v/2
    for s in range(m - 1):
        ops += 1  # o_s - z_s
        for j in range(s + 1, m):
            ops += sum(ext(e - 2) for e in range(j + 1, m))
            ops += 2 * (m - 1) - 1 + 4  # the weight sum, o_j - z_j, term
            if j + 1 < m:
                ops += ext(j - 1)
        if s + 2 < m:
            ops += ext(s)
    return ops


def treeshap_model(X, tables, interactions: bool = False,
                   tab_bytes: int = TAB_BYTES):
    """What K6 computes, in its order, as PyTorch operations over all rows
    at once: each bucket's paths in order, a tabulated bucket's
    (``tabulated``) through its terms at each of the 2^m masks, read at
    each row's mask (the others' terms a row), each term added into the
    row's f32 sum of its cell (of an interaction term, the one sum of its
    unordered pair of features), added into the f64 totals of the union's cells at the bucket's end;
    the bias added to column F last.  Returns what ``treeshap_cuda``
    returns (``launch`` on tables packed with ``tab_bytes``)."""
    R, F = X.shape
    pk = pack_tables(tables, interactions, "cpu", tab_bytes)
    X = X.cpu()
    node = pk.node.numpy()
    word, thr = node[:, 0], node[:, 1].copy().view(np.float32)
    cells_u = pk.cells.long()
    total = torch.zeros((pk.n_union, R), dtype=torch.float64)
    for i, (p0, p1, m, D, nb0, sb0, wo, c0, c1, pc0, _) in enumerate(
            pk.meta.numpy()):
        tab_it = tabulated(pk, i, R)
        nt = n_terms(m, interactions)
        w = pk.wk[wo:wo + (m - 1 if interactions else m)]
        z = pk.z[sb0:sb0 + (p1 - p0) * m].reshape(-1, m)
        tile = torch.zeros((c1 - c0, R), dtype=torch.float32)
        if tab_it:  # every path's terms at each of its 2^m masks
            masks = torch.arange(1 << m)
            o = ((masks[:, None] >> torch.arange(m)) & 1 == 0).float()
            tab = path_terms(o[None], z[:, None], pk.v[p0:p1, None], w,
                             interactions)  # (P, 2^m, terms)
        for p in range(p1 - p0):
            leaves = torch.zeros((R, m), dtype=torch.bool)
            for d in range(nb0 + p * D, nb0 + (p + 1) * D):
                x = X[:, word[d] >> 10]
                gol = torch.where(torch.isnan(x), bool(word[d] & 1),
                                  x < float(thr[d]))
                leaves[:, (word[d] >> 2) & 255] |= gol != bool(word[d] & 2)
            if tab_it:
                mask = (leaves.long() << torch.arange(m)).sum(1)
                terms = tab[p][mask]
            else:
                terms = path_terms((~leaves).float(), z[p], pk.v[p0 + p], w,
                                   interactions)
            pc = pk.pcell[pc0 + p * nt:pc0 + (p + 1) * nt].long()
            for c in range(nt):
                tile[pc[c]] += terms[:, c]
        total[cells_u[c0:c1]] += tile.double()
    out = torch.zeros((R, n_cells(F, interactions)), dtype=torch.float64)
    union = torch.nonzero(pk.out_u >= 0)[:, 0]
    out[:, union] = total[pk.out_u[union].long()].t()
    if interactions:
        return out.reshape(R, F + 1, F + 1)
    out[:, F] += pk.bias
    return out


def work(tables, n_rows: int, interactions: bool = False):
    """(bytes, f32 operations, f64 operations) a call needs: X and the
    packed tables read once and the f64 output written once; the f32
    operations of every path's terms (``term_ops``) at each of its 2^m
    masks (a tabulated bucket's) or at each row (the others'), and each row's adds of its terms into its sums (an interaction
    term's one, into its pair's sum); the f64 adds of each bucket's
    touched cells into each row's totals, and the bias."""
    F = tables.n_feat
    pk = pack_tables(tables, interactions, "cpu")
    table_bytes = sum(t.numel() * t.element_size() for t in (
        pk.meta, pk.node, pk.z, pk.v, pk.wk, pk.cells, pk.pcell, pk.out_u))
    bytes_ = (4 * n_rows * F + 8 * n_rows * n_cells(F, interactions)
              + table_bytes)
    f32 = 0
    for i, (m, _, P) in enumerate(pk.shapes):
        per = term_ops(m, interactions)
        f32 += (P * per << m if tabulated(pk, i, n_rows)
                else n_rows * P * per)
        f32 += n_rows * P * n_terms(m, interactions)
    meta = pk.meta.numpy()
    f64 = n_rows * (int((meta[:, 8] - meta[:, 7]).sum())
                    + (0 if interactions else 1))
    return bytes_, f32, f64
