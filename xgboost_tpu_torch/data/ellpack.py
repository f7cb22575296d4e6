"""EllpackPage: the device-resident binned feature matrix (port of
xgboost_tpu/data/ellpack.py, dense and CSR paths).

A dense (R_pad, F) matrix of feature-local bin ids in the smallest integer
type that holds B + 1 symbols (B = widest feature's bin count, the extra
symbol is the missing sentinel ``B``).  Rows are padded to a multiple of
``row_align`` with sentinel bins; pad rows carry zero gradients and never
match a node.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .quantile import HistogramCuts


def _bin_dtype(n_symbols: int) -> torch.dtype:
    # 257 symbols at max_bin=256: uint8 cannot hold the sentinel
    if n_symbols <= 255:
        return torch.uint8
    if n_symbols <= 32766:
        return torch.int16
    return torch.int32


@dataclasses.dataclass
class EllpackPage:
    """Binned matrix + cut metadata, on one device.

    bins     : (R_pad, F) local bin index in [0, n_bins(f)), sentinel = B.
    cuts_pad : (F, B) f32 padded cut upper bounds (+inf pads).
    n_bins   : (F,) int32 valid bin count per feature.
    n_rows   : logical row count (R_pad >= n_rows).
    """

    bins: torch.Tensor
    cuts_pad: torch.Tensor
    n_bins: torch.Tensor
    n_rows: int
    cuts: HistogramCuts

    @property
    def n_padded(self) -> int:
        return int(self.bins.shape[0])


def build_ellpack(X: torch.Tensor, cuts: HistogramCuts,
                  row_align: int = 1024) -> EllpackPage:
    """Bin a dense (R, F) f32 tensor against ``cuts`` on X's device.

    bin = searchsorted(cuts_f, v, right=True) == count of cuts <= v (the
    reference's upper_bound search, src/common/hist_util.h SearchBin);
    values past the last cut clamp into the top bin, NaN -> sentinel B.
    """
    R, F = X.shape
    if F != cuts.n_features:
        raise ValueError(f"X has {F} features, cuts have {cuts.n_features}")
    dev = X.device
    B = cuts.max_n_bins
    R_pad = -(-R // row_align) * row_align
    cuts_pad = torch.from_numpy(cuts.padded(B)).to(dev)
    n_bins = torch.from_numpy(cuts.n_bins_array()).to(dev)
    Xf = X.to(torch.float32)
    # (F, R) rows of queries against (F, B) sorted rows of cuts
    b = torch.searchsorted(cuts_pad, Xf.T.contiguous(), right=True).T
    b = torch.minimum(b, (n_bins.long() - 1)[None, :])
    b = torch.where(torch.isnan(Xf), B, b)
    bins = torch.full((R_pad, F), B, dtype=_bin_dtype(B + 1), device=dev)
    bins[:R] = b.to(bins.dtype)
    return EllpackPage(bins=bins, cuts_pad=cuts_pad, n_bins=n_bins, n_rows=R,
                       cuts=cuts)


def build_ellpack_csr(indptr, indices, values, n_features: int,
                      cuts: HistogramCuts, row_align: int = 1024,
                      device=None) -> EllpackPage:
    """Bin a CSR matrix into the dense layout on ``device``: each stored
    value's bin is the count of its feature's cuts <= it (a binary search
    over the feature's padded cut row), clamped into the top bin; absent
    entries and stored NaN hold the sentinel B, so the histogram kernels
    take the page unchanged (reference ellpack.py:134 build_ellpack_csr)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    R = len(indptr) - 1
    B = cuts.max_n_bins
    R_pad = -(-R // row_align) * row_align
    cuts_pad = torch.from_numpy(cuts.padded(B)).to(dev)
    n_bins = torch.from_numpy(cuts.n_bins_array()).to(dev)
    counts = torch.from_numpy(np.diff(np.asarray(indptr)).astype(
        np.int64)).to(dev)
    row = torch.repeat_interleave(torch.arange(R, device=dev), counts)
    feat = torch.from_numpy(np.asarray(indices, np.int64)).to(dev)
    v = torch.from_numpy(np.asarray(values, np.float32)).to(dev)
    ok = ~torch.isnan(v)
    row, feat, v = row[ok], feat[ok], v[ok]
    lo = torch.zeros_like(feat)
    hi = torch.full_like(feat, B)
    for _ in range(B.bit_length()):
        mid = torch.clamp((lo + hi) // 2, max=B - 1)
        go = cuts_pad[feat, mid] <= v
        active = lo < hi
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    b = torch.minimum(lo, n_bins.long()[feat] - 1)
    bins = torch.full((R_pad, n_features), B, dtype=_bin_dtype(B + 1),
                      device=dev)
    bins[row, feat] = b.to(bins.dtype)
    return EllpackPage(bins=bins, cuts_pad=cuts_pad, n_bins=n_bins, n_rows=R,
                       cuts=cuts)
