"""Quantile sketch -> histogram bin boundaries (port of the dense and CSR
paths of xgboost_tpu/data/quantile.py, categorical features included: they
get identity cuts, code c in bin c).

Two dense sketches, as in the reference: the exact host grid (numpy) for
data on the CPU, and the accelerator sketch (a device sort of a row
subsample) for data on the card.  Each agrees bitwise with its twin in the
reference; the two differ from each other above about 10^5 rows.  CSR
input takes the host sketch of its stored entries (``sketch_csr``) on
either device.  ``tree_method="approx"`` sketches anew every round with
the rows weighted by their hessians (``WeightedSketch``, the reference's
``sketch_dense(weights=)``): numpy on the host on either device, as the
reference does, so the cuts are its bits.  Out-of-core matrices sketch a
page at a time (``StreamingSketch``): each page's fixed-size grid, merged
by ``merge_quantile_grids``, a pure function of the pages' summaries.
Cut semantics match the reference (hist_util.cc):
 - bin b of feature f covers values v with cuts[b-1] <= v < cuts[b]
   (bin index = count of cuts <= v, i.e. searchsorted side='right');
 - the last cut is strictly greater than the feature max;
 - ``min_vals`` records a value strictly below the feature min.
"""
from __future__ import annotations

import dataclasses
import secrets
from typing import List, Optional

import numpy as np
import torch


def _fresh_cuts_token() -> int:
    """A random 63-bit identity: tokens survive pickling, so a counter
    local to a process could match an unpickled model's trees against
    unrelated cuts."""
    return secrets.randbits(63)


@dataclasses.dataclass
class HistogramCuts:
    """Bin boundaries (reference: src/common/hist_util.h:39-106).

    ``cut_ptrs``  : (F+1,) int32  — CSR offsets into ``cut_values``.
    ``cut_values``: (total_bins,) f32 — ascending per-feature upper bounds.
    ``min_vals``  : (F,) f32 — strictly below each feature's min.
    ``token``     : identity of these cuts; trees grown on them record it,
                    so binned prediction can check that their split bins
                    index these cuts.
    """

    cut_ptrs: np.ndarray
    cut_values: np.ndarray
    min_vals: np.ndarray
    token: int = dataclasses.field(default_factory=_fresh_cuts_token)

    @property
    def n_features(self) -> int:
        return len(self.cut_ptrs) - 1

    @property
    def max_n_bins(self) -> int:
        return int(np.max(np.diff(self.cut_ptrs))) if self.n_features else 0

    def feature_cuts(self, f: int) -> np.ndarray:
        return self.cut_values[self.cut_ptrs[f]: self.cut_ptrs[f + 1]]

    def padded(self, width: Optional[int] = None) -> np.ndarray:
        """Dense (F, B) cut matrix padded with +inf."""
        B = width or self.max_n_bins
        out = np.full((self.n_features, B), np.inf, dtype=np.float32)
        for f in range(self.n_features):
            seg = self.feature_cuts(f)
            out[f, : len(seg)] = seg
        return out

    def n_bins_array(self) -> np.ndarray:
        return np.diff(self.cut_ptrs).astype(np.int32)


def _final_cut(vmax: float) -> float:
    # reference hist_util.cc appends max + small delta so max lands in the
    # last bin
    return float(vmax + (abs(vmax) * 1e-2 if vmax != 0.0 else 1e-5) + 1e-5)


def cuts_from_quantile_grid(grid: np.ndarray, n_valid: np.ndarray,
                            vmax: np.ndarray, vmin: np.ndarray) -> HistogramCuts:
    """Finalize ragged cuts from a dense (F, Q) quantile grid: dedupe per
    feature and append the open upper bound.  Features with n_valid 0 get a
    single catch-all bin."""
    F, _ = grid.shape
    ptrs = [0]
    values: List[np.ndarray] = []
    mins = np.empty(F, dtype=np.float32)
    for f in range(F):
        if n_valid[f] == 0:
            seg = np.array([1e-5], dtype=np.float32)
            mins[f] = -1e-5
        else:
            cand = np.unique(grid[f][np.isfinite(grid[f])])
            last = _final_cut(float(vmax[f]))
            cand = cand[cand < last]
            seg = np.append(cand[cand > vmin[f]], np.float32(last)).astype(np.float32)
            mins[f] = vmin[f] - (abs(vmin[f]) * 1e-2 if vmin[f] != 0 else 1e-5)
        values.append(seg)
        ptrs.append(ptrs[-1] + len(seg))
    return HistogramCuts(
        cut_ptrs=np.asarray(ptrs, dtype=np.int32),
        cut_values=(np.concatenate(values).astype(np.float32) if values
                    else np.zeros(0, np.float32)),
        min_vals=mins,
    )


def _host_grid(X: np.ndarray, max_bin: int,
               w: Optional[np.ndarray] = None):
    """Per-feature inverted-CDF quantile candidate grid (F, max_bin-1) and
    (nvalid, vmax, vmin, mass): the fixed-size summary of one matrix or
    page (reference quantile.py:258).  Unweighted: one whole-matrix sort
    (NaNs sort last) and a rank gather, mass = nvalid.  Weighted by ``w``
    (R,): per column, the first value in stable sort order whose f64
    prefix of weights reaches q * total (the unweighted quantiles where
    the weights sum to <= 0), mass = the column's total weight."""
    R, F = X.shape
    n_cand = max(max_bin - 1, 1)
    grid = np.full((F, n_cand), np.inf, dtype=np.float32)
    nvalid = np.zeros(F, dtype=np.int64)
    vmax = np.zeros(F, dtype=np.float32)
    vmin = np.zeros(F, dtype=np.float32)
    qs = np.arange(1, n_cand + 1, dtype=np.float64) / (n_cand + 1)
    if w is None:
        if R == 0:
            return grid, nvalid, vmax, vmin, nvalid.astype(np.float64)
        sortd = np.sort(X, axis=0)
        nvalid[:] = np.sum(~np.isnan(X), axis=0)
        pos = np.clip(np.ceil(qs[None, :] * nvalid[:, None]).astype(np.int64)
                      - 1, 0, np.maximum(nvalid[:, None] - 1, 0))
        got = np.take_along_axis(sortd.T, pos, axis=1).astype(np.float32)
        has = nvalid > 0
        grid[has] = got[has]
        vmax[has] = np.take_along_axis(
            sortd.T, np.maximum(nvalid[:, None] - 1, 0), axis=1)[has, 0]
        vmin[has] = sortd[0][has]
        return grid, nvalid, vmax, vmin, nvalid.astype(np.float64)
    for f in range(F):
        col = X[:, f]
        mask = ~np.isnan(col)
        vals = col[mask]
        nvalid[f] = len(vals)
        if len(vals) == 0:
            continue
        vmax[f] = vals.max()
        vmin[f] = vals.min()
        order = np.argsort(vals, kind="stable")
        sv, sw = vals[order], w[mask].astype(np.float64)[order]
        cdf = np.cumsum(sw)
        if cdf[-1] <= 0:
            grid[f] = np.quantile(vals, qs, method="inverted_cdf").astype(
                np.float32)
        else:
            idx = np.searchsorted(cdf, qs * cdf[-1], side="left")
            grid[f] = sv[np.clip(idx, 0, len(sv) - 1)].astype(np.float32)
    wq = np.asarray(w, np.float64)
    mass = np.array([wq[~np.isnan(X[:, f])].sum() for f in range(F)])
    return grid, nvalid, vmax, vmin, mass


def _device_grid(X: torch.Tensor, max_bin: int):
    """The reference's accelerator sketch (xgboost_tpu/data/quantile.py:
    200-249) as torch ops on X's device: a sort of a stride subsample of at
    most 2**19 rows, f32 inverted-CDF ranks over the sample's valid count,
    and nvalid/min/max from the full data."""
    R, F = X.shape
    n_cand = max(max_bin - 1, 1)
    Xd = X.to(torch.float32)
    SAMPLE = 1 << 19
    Xs = Xd[::(R + SAMPLE - 1) // SAMPLE] if R > SAMPLE else Xd
    sortd = torch.sort(Xs, dim=0).values  # NaNs sort last
    nvalid = (~torch.isnan(Xs)).sum(dim=0)
    # true division by a tensor: a scalar divisor on a CUDA tensor is
    # applied as a multiply by its reciprocal, which can round differently
    qs = torch.arange(1, n_cand + 1, dtype=torch.float32, device=X.device) \
        / torch.full((), float(n_cand + 1), device=X.device)
    pos = torch.ceil(qs[None, :] * nvalid[:, None].to(torch.float32)).to(
        torch.int32) - 1
    pos = torch.clamp(pos, min=torch.zeros_like(pos),
                      max=torch.clamp(nvalid[:, None] - 1, min=0).to(torch.int32))
    grid = sortd.T.gather(1, pos.long())
    nan = torch.isnan(Xd)
    nvalid_h = (~nan).sum(dim=0).cpu().numpy()
    vmax = torch.where(nan, -torch.inf, Xd).amax(dim=0).cpu().numpy()
    vmin = torch.where(nan, torch.inf, Xd).amin(dim=0).cpu().numpy()
    grid_h = grid.cpu().numpy()
    return (np.where(np.isnan(grid_h), np.inf, grid_h), nvalid_h,
            np.where(nvalid_h > 0, vmax, 0.0), np.where(nvalid_h > 0, vmin, 0.0))


def categorical_cuts(n_cats: int) -> np.ndarray:
    """Identity cuts of a categorical feature, [1 .. n_cats]: code c lands
    in bin c (the count of cuts <= c)."""
    return np.arange(1, max(n_cats, 1) + 1, dtype=np.float32)


def _assemble_cuts(F: int, max_bin: int, cat_n_cats, num_seg) -> HistogramCuts:
    """Per-feature cut segments stitched together: identity cuts for the
    categorical features (``cat_n_cats``: {feature -> n_cats}), ``num_seg(f)
    -> (segment, min)`` for the numeric ones."""
    ptrs, values = [0], []
    mins = np.zeros(F, np.float32)
    for f in range(F):
        if f in cat_n_cats:
            n_cats = cat_n_cats[f]
            if n_cats > max_bin:
                raise ValueError(
                    f"categorical feature {f} has {n_cats} categories; "
                    f"raise max_bin (currently {max_bin})")
            seg = categorical_cuts(n_cats)
            mins[f] = -1e-5
        else:
            seg, mins[f] = num_seg(f)
        values.append(seg)
        ptrs.append(ptrs[-1] + len(seg))
    return HistogramCuts(
        np.asarray(ptrs, np.int32),
        (np.concatenate(values).astype(np.float32) if values
         else np.zeros(0, np.float32)),
        mins)


def _sketch_categorical(X, max_bin: int, use_device: Optional[bool],
                        cat_mask: np.ndarray) -> HistogramCuts:
    """Identity cuts for the categorical columns, n_cats = the largest code
    + 1, and the numeric columns sketched alone, on X's device (reference
    quantile.py:179-195)."""
    F = X.shape[1]
    num_idx = np.nonzero(~cat_mask)[0]
    cat_idx = np.nonzero(cat_mask)[0]
    if isinstance(X, torch.Tensor):
        sel = torch.from_numpy(num_idx).to(X.device)
        Xn = X.index_select(1, sel)
        Xc = X.index_select(1, torch.from_numpy(cat_idx).to(X.device))
        # the largest code per column; -inf where a column is all missing
        top = torch.where(torch.isnan(Xc), -torch.inf, Xc).amax(dim=0) \
            if X.shape[0] else torch.full((len(cat_idx),), -torch.inf)
        top = top.cpu().numpy()
    else:
        X = np.asarray(X, dtype=np.float32)
        Xn, Xc = X[:, num_idx], X[:, cat_idx]
        top = np.where(np.isnan(Xc), -np.inf, Xc).max(axis=0, initial=-np.inf)
    base = (sketch_dense(Xn, max_bin, use_device=use_device)
            if len(num_idx) else None)
    cat_n_cats = {int(f): (int(t) + 1 if np.isfinite(t) else 1)
                  for f, t in zip(cat_idx, top)}
    num_pos = {int(f): i for i, f in enumerate(num_idx)}
    return _assemble_cuts(
        F, max_bin, cat_n_cats,
        lambda f: (base.feature_cuts(num_pos[f]), base.min_vals[num_pos[f]]))


class WeightedSketch:
    """The hessian-weighted host sketch of one matrix (reference
    quantile.py:159-200, :258-315), for tree_method="approx", which
    sketches the same rows under new weights every round: each column's
    non-missing rows in the order of a stable sort of their values are
    found once, so a round takes a gather, the f64 prefix sums of the
    weights and a search per column.  The cuts are the reference's bits:
    per column, the first value in that order whose prefix reaches
    q * total (inverted CDF), or the unweighted inverted-CDF quantiles
    where the weights sum to <= 0; categorical columns take identity
    cuts, n_cats = their largest code + 1."""

    def __init__(self, X: np.ndarray, cat_mask: Optional[np.ndarray] = None):
        X = np.asarray(X, dtype=np.float32)
        self.n_features = X.shape[1]
        self.cat_mask = (None if cat_mask is None or not np.any(cat_mask)
                         else np.asarray(cat_mask, bool))
        num = (np.arange(self.n_features) if self.cat_mask is None
               else np.nonzero(~self.cat_mask)[0])
        self.num_idx = num
        self.rows, self.vals = [], []  # per numeric column, sorted
        for f in num:
            col = X[:, f]
            ok = np.nonzero(~np.isnan(col))[0]
            order = ok[np.argsort(col[ok], kind="stable")]
            self.rows.append(order.astype(np.int64))
            self.vals.append(col[order])
        self.cat_n_cats = {}
        if self.cat_mask is not None:
            for f in np.nonzero(self.cat_mask)[0]:
                col = X[:, f]
                col = col[~np.isnan(col)]
                self.cat_n_cats[int(f)] = int(col.max()) + 1 if len(col) \
                    else 1

    def _grid(self, max_bin: int, w: np.ndarray):
        F = len(self.num_idx)
        n_cand = max(max_bin - 1, 1)
        grid = np.full((F, n_cand), np.inf, dtype=np.float32)
        nvalid = np.zeros(F, dtype=np.int64)
        vmax = np.zeros(F, dtype=np.float32)
        vmin = np.zeros(F, dtype=np.float32)
        qs = np.arange(1, n_cand + 1, dtype=np.float64) / (n_cand + 1)
        for i, (rows, sv) in enumerate(zip(self.rows, self.vals)):
            nvalid[i] = len(sv)
            if len(sv) == 0:
                continue
            vmax[i], vmin[i] = sv[-1], sv[0]
            cdf = np.cumsum(w[rows].astype(np.float64))
            tot = cdf[-1]
            if tot <= 0:
                grid[i] = np.quantile(sv, qs, method="inverted_cdf").astype(
                    np.float32)
            else:
                idx = np.searchsorted(cdf, qs * tot, side="left")
                grid[i] = sv[np.clip(idx, 0, len(sv) - 1)].astype(np.float32)
        return grid, nvalid, vmax, vmin

    def cuts(self, max_bin: int, weights: np.ndarray) -> HistogramCuts:
        """The cuts under (R,) row weights."""
        base = (cuts_from_quantile_grid(*self._grid(max_bin,
                                                    np.asarray(weights)))
                if len(self.num_idx) else None)
        if self.cat_mask is None:
            return base
        num_pos = {int(f): i for i, f in enumerate(self.num_idx)}
        return _assemble_cuts(
            self.n_features, max_bin, self.cat_n_cats,
            lambda f: (base.feature_cuts(num_pos[f]),
                       base.min_vals[num_pos[f]]))


def sketch_dense(X, max_bin: int, use_device: Optional[bool] = None,
                 cat_mask: Optional[np.ndarray] = None) -> HistogramCuts:
    """HistogramCuts from a dense (R, F) float matrix with NaN = missing.

    ``use_device``: None takes the reference's rule per backend, the device
    sketch for a CUDA tensor and the exact host grid otherwise; True runs
    the device sketch on X's device whatever it is (the tests run it on
    CPU tensors); False runs the host grid.  ``cat_mask``: (F,) bool of the
    categorical features, which get identity cuts.
    """
    if cat_mask is not None and np.any(cat_mask):
        return _sketch_categorical(X, max_bin, use_device,
                                   np.asarray(cat_mask, bool))
    if use_device is None:
        use_device = isinstance(X, torch.Tensor) and X.is_cuda
    if use_device and X.shape[0] * X.shape[1] > 0:
        return cuts_from_quantile_grid(*_device_grid(torch.as_tensor(X),
                                                     max_bin))
    if isinstance(X, torch.Tensor):
        X = X.cpu().numpy()
    return cuts_from_quantile_grid(
        *_host_grid(np.asarray(X, dtype=np.float32), max_bin)[:4])


def _csr_grid(indptr, indices, values, n_features: int, max_bin: int,
              cat_mask: Optional[np.ndarray],
              weights: Optional[np.ndarray] = None):
    """Per-feature quantile grid and stats of the stored entries of a CSR
    matrix, the CSR twin of ``_host_grid`` (reference quantile.py:524):
    (grid, nvalid, vmax, vmin, mass, cat_max).  Categorical columns stay
    out of the numeric grid (nvalid 0) and report their largest code (-1
    where they store none).  ``weights`` (R,): a weight a row."""
    R = len(indptr) - 1
    n_cand = max(max_bin - 1, 1)
    grid = np.full((n_features, n_cand), np.inf, dtype=np.float32)
    nvalid = np.zeros(n_features, dtype=np.int64)
    vmax = np.zeros(n_features, dtype=np.float32)
    vmin = np.zeros(n_features, dtype=np.float32)
    mass = np.zeros(n_features, dtype=np.float64)
    cat_max = np.full(n_features, -1.0, np.float32)
    qs = np.arange(1, n_cand + 1, dtype=np.float64) / (n_cand + 1)
    # the entries bucketed by column
    order = np.argsort(indices, kind="stable")
    val_sorted = values[order]
    starts = np.searchsorted(indices[order], np.arange(n_features + 1))
    if weights is not None:
        row_of = np.repeat(np.arange(R), np.diff(indptr))[order]
    is_cat = (np.zeros(n_features, bool) if cat_mask is None
              else np.asarray(cat_mask, bool))
    for f in range(n_features):
        seg = val_sorted[starts[f]: starts[f + 1]].astype(np.float32)
        keep = ~np.isnan(seg)
        vals = seg[keep]
        if is_cat[f]:
            # implicit zeros are missing: category 0 must be stored
            if len(vals):
                cat_max[f] = vals.max()
            continue
        nvalid[f] = len(vals)
        if not len(vals):
            continue
        vmax[f], vmin[f] = vals.max(), vals.min()
        if weights is None:
            mass[f] = len(vals)
            grid[f] = np.quantile(vals, qs, method="inverted_cdf").astype(
                np.float32)
        else:
            wf = weights[row_of[starts[f]: starts[f + 1]]][keep].astype(
                np.float64)
            o = np.argsort(vals, kind="stable")
            sv, sw = vals[o], wf[o]
            cdf = np.cumsum(sw)
            mass[f] = cdf[-1]
            idx = np.searchsorted(cdf, qs * cdf[-1], side="left")
            grid[f] = sv[np.clip(idx, 0, len(sv) - 1)].astype(np.float32)
    return grid, nvalid, vmax, vmin, mass, cat_max


def sketch_csr(indptr, indices, values, n_features: int, max_bin: int,
               cat_mask: Optional[np.ndarray] = None,
               distributed: bool = False) -> HistogramCuts:
    """HistogramCuts of a CSR matrix from its stored entries alone: an
    implicit zero is missing, as in the reference's sparse DMatrix
    (reference quantile.py:573 sketch_csr; src/common/hist_util.cc
    SketchOnDMatrix walks the stored entries).  ``distributed``: this
    rank holds a row shard; one StreamingSketch page a rank, merged over
    the ranks without making the shard dense."""
    if distributed:
        sk = StreamingSketch(n_features, max_bin, cat_mask=cat_mask)
        sk.push_csr(indptr, indices, values)
        return sk.finalize(distributed=True)
    grid, nvalid, vmax, vmin, _, cat_max = _csr_grid(
        indptr, indices, values, n_features, max_bin, cat_mask)
    base = cuts_from_quantile_grid(grid, nvalid, vmax, vmin)
    if cat_mask is None or not np.any(cat_mask):
        return base
    cat_n_cats = {int(f): (int(cat_max[f]) + 1 if cat_max[f] >= 0 else 1)
                  for f in np.nonzero(cat_mask)[0]}
    return _assemble_cuts(
        n_features, max_bin, cat_n_cats,
        lambda f: (base.feature_cuts(f), base.min_vals[f]))


def merge_quantile_grids(grids: np.ndarray, nvalids: np.ndarray,
                         vmaxs: np.ndarray, vmins: np.ndarray, max_bin: int,
                         masses: Optional[np.ndarray] = None
                         ) -> HistogramCuts:
    """Merge W summaries' quantile grids into shared cuts (reference
    quantile.py:317, the role of src/common/quantile.cc:397-442
    SketchContainer::AllReduce): summary k's finite candidates of feature
    f each carry an equal share of its mass ``masses[k, f]`` (nvalid when
    None); the cuts are the inverted-CDF quantiles of the weighted union,
    candidates sorted by value, so the result depends on the multiset of
    summaries alone.  grids (W, F, Q); nvalids, masses, vmaxs, vmins
    (W, F)."""
    W, F, Q = grids.shape
    if masses is None:
        masses = nvalids.astype(np.float64)
    n_cand = max(max_bin - 1, 1)
    qs = np.arange(1, n_cand + 1, dtype=np.float64) / (n_cand + 1)
    grid = np.full((F, n_cand), np.inf, dtype=np.float32)
    nvalid = nvalids.sum(axis=0).astype(np.int64)
    vmax = np.zeros(F, dtype=np.float32)
    vmin = np.zeros(F, dtype=np.float32)
    for f in range(F):
        has = nvalids[:, f] > 0
        if not has.any():
            continue
        vmax[f] = vmaxs[has, f].max()
        vmin[f] = vmins[has, f].min()
        cand_list, w_list = [], []
        for k in np.nonzero(has)[0]:
            c = grids[k, f]
            c = c[np.isfinite(c)]
            if len(c) == 0:
                continue
            cand_list.append(c.astype(np.float64))
            w_list.append(np.full(len(c), masses[k, f] / len(c), np.float64))
        cand = np.concatenate(cand_list)
        wts = np.concatenate(w_list)
        order = np.argsort(cand, kind="stable")
        sv, sw = cand[order], wts[order]
        cdf = np.cumsum(sw)
        idx = np.searchsorted(cdf, qs * cdf[-1], side="left")
        grid[f] = sv[np.clip(idx, 0, len(sv) - 1)].astype(np.float32)
    return cuts_from_quantile_grid(grid, nvalid, vmax, vmin)


def _pack_contrib(grid: np.ndarray, nvalid: np.ndarray, vmax: np.ndarray,
                  vmin: np.ndarray, mass: np.ndarray) -> np.ndarray:
    """One page's summary as a single (F, Q+4) f64 block (grid, nvalid,
    vmax, vmin, mass): f32 values and int64 counts round-trip exactly
    through f64."""
    F, Q = grid.shape
    out = np.empty((F, Q + 4), np.float64)
    out[:, :Q] = grid
    out[:, Q] = nvalid
    out[:, Q + 1] = vmax
    out[:, Q + 2] = vmin
    out[:, Q + 3] = mass
    return out


class StreamingSketch:
    """Page-at-a-time quantile sketch (reference quantile.py:382): every
    pushed page contributes one fixed-size summary, exactly what
    ``_host_grid`` (or ``_csr_grid``) gives for that page, and
    ``finalize`` merges them through ``merge_quantile_grids``, so the cuts
    never need the whole matrix in memory.  The merge is a pure function of
    the multiset of page summaries: the cuts are the same bits in any push
    order.  Categorical columns stay out of the numeric grids; their
    identity cuts come from the largest code over all pages."""

    def __init__(self, n_features: int, max_bin: int,
                 cat_mask: Optional[np.ndarray] = None) -> None:
        self.n_features = int(n_features)
        self.max_bin = int(max_bin)
        cm = None
        if cat_mask is not None and np.any(cat_mask):
            cm = np.asarray(cat_mask, bool)
            if len(cm) != self.n_features:
                raise ValueError("cat_mask length != n_features")
        self.cat_mask = cm
        self._contribs: List[np.ndarray] = []
        self._cat_max = np.full(self.n_features, -1.0, np.float32)

    @property
    def n_cand(self) -> int:
        return max(self.max_bin - 1, 1)

    @property
    def n_pages(self) -> int:
        return len(self._contribs)

    def push(self, X, weights: Optional[np.ndarray] = None,
             executor=None) -> None:
        """Fold one dense (R, F) page (NaN = missing) into the sketch.
        ``executor`` (a concurrent.futures executor): the page's numeric
        summary is computed there, on a copy of its numeric columns, and
        collected in push order by ``finalize``."""
        Xh = np.asarray(X, dtype=np.float32)
        if Xh.shape[1] != self.n_features:
            raise ValueError(
                f"page has {Xh.shape[1]} features, sketch expects "
                f"{self.n_features}")
        w = None if weights is None else np.array(weights)
        cat = self.cat_mask
        if cat is None:
            num_idx = np.arange(self.n_features)
            Xn = Xh.copy() if executor is not None else Xh
        else:
            for f in np.nonzero(cat)[0]:
                col = Xh[:, f]
                col = col[~np.isnan(col)]
                if len(col):
                    self._cat_max[f] = max(self._cat_max[f], col.max())
            num_idx = np.nonzero(~cat)[0]
            Xn = Xh[:, num_idx]  # a copy
        if executor is None:
            self._contribs.append(self._summary(Xn, num_idx, w))
        else:
            self._contribs.append(executor.submit(self._summary, Xn,
                                                  num_idx, w))

    def _summary(self, Xn, num_idx, w) -> np.ndarray:
        """The packed summary of a page's numeric columns ``num_idx``;
        the other rows are the empty-feature sentinel the merge skips."""
        if len(num_idx) == self.n_features:
            return _pack_contrib(*_host_grid(Xn, self.max_bin, w))
        F, Q = self.n_features, self.n_cand
        grid = np.full((F, Q), np.inf, np.float32)
        nvalid = np.zeros(F, np.int64)
        vmax = np.zeros(F, np.float32)
        vmin = np.zeros(F, np.float32)
        mass = np.zeros(F, np.float64)
        if len(num_idx):
            g, nv, vx, vn, ms = _host_grid(Xn, self.max_bin, w)
            grid[num_idx] = g
            nvalid[num_idx] = nv
            vmax[num_idx] = vx
            vmin[num_idx] = vn
            mass[num_idx] = ms
        return _pack_contrib(grid, nvalid, vmax, vmin, mass)

    def wait(self, limit: int) -> None:
        """Block until at most ``limit`` summaries are still computing."""
        busy = [c for c in self._contribs
                if not isinstance(c, np.ndarray) and not c.done()]
        for c in busy[: max(len(busy) - limit, 0)]:
            c.result()

    def push_csr(self, indptr, indices, values,
                 weights: Optional[np.ndarray] = None) -> None:
        """Fold one CSR page (implicit zeros missing, as ``sketch_csr``)
        without making it dense."""
        grid, nvalid, vmax, vmin, mass, cat_max = _csr_grid(
            np.asarray(indptr), np.asarray(indices), np.asarray(values),
            self.n_features, self.max_bin, self.cat_mask,
            None if weights is None else np.asarray(weights))
        np.maximum(self._cat_max, cat_max, out=self._cat_max)
        self._contribs.append(_pack_contrib(grid, nvalid, vmax, vmin, mass))

    def finalize(self, distributed: bool = False) -> HistogramCuts:
        """Merge every page's summary into shared cuts.  ``distributed``:
        the summaries of every rank, in one ragged gather (reference
        quantile.py:474-495), and the categorical maxima by MAX, so every
        rank computes the same cuts; a rank may hold no page, as long as
        every rank calls ``finalize`` and one page exists overall."""
        F, Q = self.n_features, self.n_cand
        local = (np.stack([c if isinstance(c, np.ndarray) else c.result()
                           for c in self._contribs]) if self._contribs
                 else np.zeros((0, F, Q + 4), np.float64))
        cat_max = self._cat_max
        if distributed:
            from .. import collective

            flat = local.reshape(local.shape[0], F * (Q + 4))
            local = collective.allgather_ragged(flat).reshape(-1, F, Q + 4)
            if self.cat_mask is not None:
                cat_max = collective.allreduce(cat_max, collective.Op.MAX)
        if local.shape[0] == 0:
            raise ValueError("StreamingSketch.finalize: no pages pushed")
        base = merge_quantile_grids(
            local[:, :, :Q].astype(np.float32),
            local[:, :, Q].astype(np.int64),
            local[:, :, Q + 1].astype(np.float32),
            local[:, :, Q + 2].astype(np.float32),
            self.max_bin, masses=local[:, :, Q + 3])
        if self.cat_mask is None:
            return base
        cat_n_cats = {int(f): (int(cat_max[f]) + 1 if cat_max[f] >= 0
                               else 1)
                      for f in np.nonzero(self.cat_mask)[0]}
        return _assemble_cuts(
            self.n_features, self.max_bin, cat_n_cats,
            lambda f: (base.feature_cuts(f), base.min_vals[f]))


def sketch_distributed(X, max_bin: int, weights: Optional[np.ndarray] = None,
                       cat_mask: Optional[np.ndarray] = None) -> HistogramCuts:
    """Cuts shared by the ranks, each holding a row shard of X (reference
    quantile.py:511): one StreamingSketch page a rank, one ragged gather,
    the deterministic merge; categorical features take identity cuts sized
    by the largest code over the ranks."""
    Xh = np.asarray(X, dtype=np.float32)
    sk = StreamingSketch(Xh.shape[1], max_bin, cat_mask=cat_mask)
    sk.push(Xh, weights=weights)
    return sk.finalize(distributed=True)
