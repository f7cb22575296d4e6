"""Gradient histogram helpers of the hist grower (port of
xgboost_tpu/ops/histogram.py).

``build_histogram`` here is the plain PyTorch version of the per-level
histogram: a scatter-add of each (row, feature) gradient pair into its
(node, feature, bin) cell.  It serves CPU tensors and is the version the
CUDA kernel (ops/hist_cuda.py, csrc/hist.cu) is held against; the grower
calls the dispatcher in ops/hist_cuda.py, never this function directly on
a CUDA tensor.
"""
from __future__ import annotations

import torch


def build_histogram(bins, gpair, pos, *, node0: int, n_nodes: int,
                    n_bin: int, stride: int = 1):
    """hist (n_nodes, F, B, C) f32 for nodes node0 + stride*[0, n_nodes).

    bins  : (R, F) uint8/int16/int32 local bin ids, sentinel == n_bin missing
    gpair : (R, C) f32 (C = 2: grad, hess)
    pos   : (R,) int32 node id per row (-1 for pad rows)
    stride: 2 selects the left children of a level (subtraction trick).
    """
    R, F = bins.shape
    C = gpair.shape[1]
    local = pos.long() - node0
    ok = (local >= 0) & (local % stride == 0) & (local // stride < n_nodes)
    node = torch.where(ok, local // stride, 0)
    b = bins.long()
    take = ok[:, None] & (b < n_bin)  # (R, F): row in level, value present
    feat = torch.arange(F, device=bins.device)
    idx = (node[:, None] * F + feat[None, :]) * n_bin + b
    vals = gpair.float()[:, None, :].expand(R, F, C)
    flat = torch.zeros(n_nodes * F * n_bin, C, dtype=torch.float32,
                       device=bins.device)
    flat.index_add_(0, idx[take], vals[take])
    return flat.reshape(n_nodes, F, n_bin, C)


def combine_sibling_hists(left, hist_prev, alive_lvl):
    """Right sibling = parent - left, interleaved to the (N, ...) level
    layout; slots whose parent did not split are zeroed (reference
    updater_gpu_hist.cu:309 SubtractHist)."""
    right = hist_prev - left
    N = 2 * left.shape[0]
    hist = torch.stack([left, right], dim=1).reshape(N, *left.shape[1:])
    return hist * alive_lvl.reshape((N,) + (1,) * (hist.ndim - 1))


def node_sums(gpair, pos, *, node0: int, n_nodes: int):
    """Per-node gradient totals (N, C): masked sums over rows."""
    rows = [torch.where((pos == node0 + n)[:, None], gpair, 0.0).sum(0)
            for n in range(n_nodes)]
    return torch.stack(rows).float()
