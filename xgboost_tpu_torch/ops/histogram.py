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


def build_histogram_multi_plain(bins, gpair, pos, *, node0: int,
                                n_nodes: int, n_bin: int, stride: int = 1):
    """K class histograms (K, n_nodes, F, B, 2) over the same bins, class k
    from gpair[:, k] (R, K, 2) and its own pos[k] (K, R): K calls of
    ``build_histogram`` (reference ops/histogram.py:257-288,
    build_histogram_multi, for the lockstep grower)."""
    return torch.stack([
        build_histogram(bins, gpair[:, k], pos[k], node0=node0,
                        n_nodes=n_nodes, n_bin=n_bin, stride=stride)
        for k in range(gpair.shape[1])])


def build_level_hist_multi_plain(bins, gpair, pos, *, node0: int,
                                 n_nodes: int, n_bin: int, stride: int = 1):
    """A vector-leaf tree's level histogram (n_nodes, F, B, K, 2) from
    gpair (R, K, 2) and one pos (R,): ``build_histogram`` with 2K channels
    (reference tree/grow_multi.py:164-175, build_level_hist_multi)."""
    R, K = gpair.shape[0], gpair.shape[1]
    h = build_histogram(bins, gpair.reshape(R, 2 * K), pos, node0=node0,
                        n_nodes=n_nodes, n_bin=n_bin, stride=stride)
    return h.reshape(n_nodes, bins.shape[1], n_bin, K, 2)


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
