"""The split scan on the card: the wrapper of K3 (csrc/split_scan.cu).

K3 computes what ``ops/split.py: split_scan_plain`` computes, bit for bit:
the best split of each node of a level's histogram, in the reference's
summation order.  ``split.evaluate_splits`` sends a CUDA tensor here and a
CPU tensor to the plain version.  The library is built and loaded by
ops/hist_cuda.py's loader, and each launch is counted in
``hist_cuda.launches["split_scan"]``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .hist_cuda import launched, load_library, on_device

__all__ = ["split_scan_cuda"]


def split_scan_cuda(hist, totals, n_bins, params, feature_mask=None,
                    node_bounds=None, mono=None, cat_mask=None,
                    dq=None) -> Tuple[torch.Tensor, ...]:
    """Launch K3 on the inputs' card: the best split of each node of
    ``hist`` (N, F, B, 2) f32, with ``totals`` (N, 2) f32 and ``n_bins``
    (F,).  ``params`` is a ``split.SplitParams`` (its lambda_, alpha,
    min_child_weight and max_delta_step are read); ``feature_mask`` (F,),
    (1, F) or (N, F) bool.  ``mono`` is the (F,) int32 constraint vector on
    the card for the monotone scan, None for the unconstrained one, whose
    ``node_bounds`` (N, 2) f32 are then ignored.  ``cat_mask`` (F,) bool on
    the card selects the categorical scan (``params.max_cat_to_onehot`` is
    read); ``dq`` = (comb (N, F, B, 2) f32, scale (2,) f32) with hist =
    comb * scale (deterministic_histogram) makes its one-hot sums
    fma(-comb, scale, total), as the reference's compiled program does.
    Returns (gain, feature, bin, default_left, GL, HL), each (N,), in
    ``split.ScanResult``'s order, and with a ``cat_mask`` also the (N, B)
    bool ``cat_set``.  A launch the card refuses raises."""
    if not (hist.is_cuda and totals.is_cuda):
        raise ValueError("the split scan kernel needs CUDA tensors")
    if hist.dtype != torch.float32 or totals.dtype != torch.float32:
        raise TypeError("hist and totals must be float32")
    if hist.dim() != 4 or hist.shape[-1] != 2:
        raise ValueError(f"hist must be (N, F, B, 2), got {tuple(hist.shape)}")
    N, F, B, _ = hist.shape
    dev = hist.device
    if tuple(totals.shape) != (N, 2) or tuple(n_bins.shape) != (F,):
        raise ValueError(f"totals {tuple(totals.shape)} and n_bins "
                         f"{tuple(n_bins.shape)} do not match hist "
                         f"{tuple(hist.shape)}")
    hist, totals = hist.contiguous(), totals.contiguous()
    # the callers hand n_bins, masks and the constraint vector over on the
    # card in the kernel's types; anything else is converted here
    nb = n_bins
    if nb.dtype != torch.int32 or nb.device != dev \
            or not nb.is_contiguous():
        nb = nb.to(dev, torch.int32).contiguous()
    fm, fm_rows = None, 0
    if feature_mask is not None:
        fm = feature_mask if feature_mask.dim() == 2 else feature_mask[None]
        if fm.shape[1] != F or fm.shape[0] not in (1, N):
            raise ValueError(f"feature_mask {tuple(feature_mask.shape)} does "
                             f"not match {N} nodes x {F} features")
        if fm.dtype != torch.bool or fm.device != dev \
                or not fm.is_contiguous():
            fm = fm.to(dev, torch.bool).contiguous()
        fm_rows = fm.shape[0]
    if cat_mask is not None:
        if tuple(cat_mask.shape) != (F,) or cat_mask.device != dev \
                or cat_mask.dtype != torch.bool:
            raise ValueError(f"cat_mask must be ({F},) bool on {dev}")
        cat_mask = cat_mask.contiguous()  # read as uint8 by the kernel
    comb = scale = None
    if dq is not None:
        if cat_mask is None:
            raise ValueError("dq is read by the categorical scan only")
        comb, scale = dq
        if tuple(comb.shape) != tuple(hist.shape) \
                or comb.dtype != torch.float32 or comb.device != dev \
                or tuple(scale.shape) != (2,) \
                or scale.dtype != torch.float32 or scale.device != dev:
            raise ValueError("dq must be (comb like hist, scale (2,)) f32 "
                             f"on {dev}")
        comb, scale = comb.contiguous(), scale.contiguous()
    bounds = None
    if mono is not None:
        if tuple(mono.shape) != (F,) or mono.dtype != torch.int32 \
                or mono.device != dev:
            raise ValueError(f"mono must be ({F},) int32 on {dev}")
        if node_bounds is not None:
            bounds = node_bounds.to(dev, torch.float32).contiguous()
    mode = 2 if cat_mask is not None else 0 if mono is None else 1

    # six allocations: one shared allocation handed out as views took
    # longer on the host (each view is a PyTorch call of its own)
    out = tuple(torch.empty(N, dtype=t, device=dev)
                for t in (torch.float32, torch.int64, torch.int64,
                          torch.bool, torch.float32, torch.float32))
    cat_set = (torch.empty((N, B), dtype=torch.bool, device=dev)
               if mode == 2 else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = load_library("split_scan")
    rc = on_device(
        dev, lib.xtb_split_scan, hist.data_ptr(), totals.data_ptr(),
        nb.data_ptr(), ptr(fm), fm_rows, ptr(bounds), ptr(mono),
        ptr(cat_mask), int(params.max_cat_to_onehot), ptr(comb), ptr(scale),
        N, F, B, float(params.lambda_), float(params.alpha),
        float(params.min_child_weight), float(params.max_delta_step), mode,
        *(t.data_ptr() for t in out), ptr(cat_set))
    launched("split_scan", lib, rc)
    return out if cat_set is None else out + (cat_set,)
