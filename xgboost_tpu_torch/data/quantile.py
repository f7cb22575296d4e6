"""Quantile sketch -> histogram bin boundaries (port of the dense,
unweighted paths of xgboost_tpu/data/quantile.py).

Two sketches, as in the reference: the exact host grid (numpy) for data on
the CPU, and the accelerator sketch (a device sort of a row subsample) for
data on the card.  Each agrees bitwise with its twin in the reference; the
two differ from each other above about 10^5 rows.  Cut semantics match the reference
(hist_util.cc):
 - bin b of feature f covers values v with cuts[b-1] <= v < cuts[b]
   (bin index = count of cuts <= v, i.e. searchsorted side='right');
 - the last cut is strictly greater than the feature max;
 - ``min_vals`` records a value strictly below the feature min.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class HistogramCuts:
    """Bin boundaries (reference: src/common/hist_util.h:39-106).

    ``cut_ptrs``  : (F+1,) int32  — CSR offsets into ``cut_values``.
    ``cut_values``: (total_bins,) f32 — ascending per-feature upper bounds.
    ``min_vals``  : (F,) f32 — strictly below each feature's min.
    """

    cut_ptrs: np.ndarray
    cut_values: np.ndarray
    min_vals: np.ndarray

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


def _host_grid(X: np.ndarray, max_bin: int):
    """Per-feature inverted-CDF quantile candidate grid (F, max_bin-1) and
    (nvalid, vmax, vmin): one whole-matrix sort (NaNs sort last) and a rank
    gather."""
    R, F = X.shape
    n_cand = max(max_bin - 1, 1)
    grid = np.full((F, n_cand), np.inf, dtype=np.float32)
    nvalid = np.zeros(F, dtype=np.int64)
    vmax = np.zeros(F, dtype=np.float32)
    vmin = np.zeros(F, dtype=np.float32)
    if R == 0:
        return grid, nvalid, vmax, vmin
    qs = np.arange(1, n_cand + 1, dtype=np.float64) / (n_cand + 1)
    sortd = np.sort(X, axis=0)
    nvalid[:] = np.sum(~np.isnan(X), axis=0)
    pos = np.clip(np.ceil(qs[None, :] * nvalid[:, None]).astype(np.int64) - 1,
                  0, np.maximum(nvalid[:, None] - 1, 0))
    got = np.take_along_axis(sortd.T, pos, axis=1).astype(np.float32)
    has = nvalid > 0
    grid[has] = got[has]
    vmax[has] = np.take_along_axis(
        sortd.T, np.maximum(nvalid[:, None] - 1, 0), axis=1)[has, 0]
    vmin[has] = sortd[0][has]
    return grid, nvalid, vmax, vmin


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


def sketch_dense(X, max_bin: int,
                 use_device: Optional[bool] = None) -> HistogramCuts:
    """HistogramCuts from a dense (R, F) float matrix with NaN = missing.

    ``use_device``: None takes the reference's rule per backend, the device
    sketch for a CUDA tensor and the exact host grid otherwise; True runs
    the device sketch on X's device whatever it is (the tests run it on
    CPU tensors); False runs the host grid.
    """
    if use_device is None:
        use_device = isinstance(X, torch.Tensor) and X.is_cuda
    if use_device and X.shape[0] * X.shape[1] > 0:
        return cuts_from_quantile_grid(*_device_grid(torch.as_tensor(X),
                                                     max_bin))
    if isinstance(X, torch.Tensor):
        X = X.cpu().numpy()
    return cuts_from_quantile_grid(
        *_host_grid(np.asarray(X, dtype=np.float32), max_bin))
