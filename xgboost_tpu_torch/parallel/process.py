"""The multi-rank depthwise tree grower (port of
xgboost_tpu/parallel/process.py; reference updater_gpu_hist.cu:581, :598
under rabit, as dask and spark run it: one worker per card, each on its
own row shard).

Each rank runs the level loop of the in-core grower on its own rows (the
histogram on K1, or K2 under deterministic_histogram, the split scan on
K3) and reduces exactly three things across ranks: the root gradient sum
once a tree, the histogram once a level, and the evaluation metrics
(core.py eval_set).  A level goes build, allreduce, sibling subtraction,
decide, as the reference's does, reusing tree/grow.py's ``decide_level``
and ``_update_positions``.

The level histogram crosses ranks on the host (``HostExchange``): copied
once to a pinned host buffer, gathered from every rank, summed in rank
order, copied back to the card once.  Every rank sums the same stack in
the same order, so every rank gets the same bits and grows the same tree;
under deterministic_histogram the int32 limb sums add as int64, exact, so
the trees do not depend on the number of ranks either.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import collective
from ..ops.hist_cuda import build_histogram, build_histogram_q
from ..ops.histogram import combine_sibling_hists
from ..ops.quantise import allreduce_limbs, prepare_quantised
from ..ops.split import SplitParams
from ..tree.grow import (FeatureMasks, HistTreeGrower, TreeState,
                         _update_positions, decide_level, init_tree_state,
                         sync_root_totals)

_NP = {torch.float32: np.float32, torch.int32: np.int32,
       torch.int64: np.int64}


class HostExchange:
    """A device tensor's allreduce across ranks through the host: one copy
    to a pinned host buffer (kept for the next call of the same shape),
    the collective's gather, the sum of the gathered stack in rank order,
    one copy back.  ``stats`` accumulates the seconds of each part (the
    stream is synchronised before and after each copy, so they are the
    copies' own time; the gather's include the wait for the slowest
    rank), the calls and the bytes sent; ``reset`` clears them.  A CPU
    tensor skips the copies."""

    def __init__(self) -> None:
        self._bufs: Dict[Tuple, torch.Tensor] = {}
        self.reset()

    def reset(self) -> None:
        self.stats = {"calls": 0, "bytes": 0, "d2h_s": 0.0, "gather_s": 0.0,
                      "sum_s": 0.0, "h2d_s": 0.0}

    def _pinned(self, tag: str, shape, dtype) -> torch.Tensor:
        key = (tag, tuple(shape), dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(shape, dtype=dtype,
                                                pin_memory=True)
        return buf

    def allreduce(self, t: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The SUM over ranks of ``t`` (same shape on every rank), as
        ``out_dtype`` (default ``t``'s; int32 limbs are summed as int64,
        exactly), on ``t``'s device."""
        out_dtype = out_dtype or t.dtype
        t = t.contiguous()
        if t.is_cuda:
            # the tensor's kernels end first, so that the copy's seconds
            # are the copy's own
            torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        if t.is_cuda:
            src = self._pinned("d2h", t.shape, t.dtype)
            src.copy_(t, non_blocking=True)
            torch.cuda.current_stream(t.device).synchronize()
            host = src.numpy()
        else:
            host = t.numpy()
        t1 = time.perf_counter()
        stacked = collective.allgather(host)
        t2 = time.perf_counter()
        # numpy sums int32 in int64: the limbs' sums are exact
        red = collective.reduce_stacked(stacked, collective.Op.SUM,
                                        _NP[out_dtype])
        t3 = time.perf_counter()
        if t.is_cuda:
            dst = self._pinned("h2d", red.shape, out_dtype)
            dst.numpy()[...] = red
            out = dst.to(t.device, non_blocking=True)
            torch.cuda.current_stream(t.device).synchronize()
        else:
            out = torch.from_numpy(red)
        t4 = time.perf_counter()
        s = self.stats
        s["calls"] += 1
        s["bytes"] += host.nbytes
        s["d2h_s"] += t1 - t0
        s["gather_s"] += t2 - t1
        s["sum_s"] += t3 - t2
        s["h2d_s"] += t4 - t3
        return out


class ProcessHistTreeGrower(HistTreeGrower):
    """The depthwise grower when the rows are sharded over ranks
    (reference parallel/process.py:40-156).  ``mesh`` (ranks that each
    shard their rows over several cards) is not ported."""

    def __init__(self, max_depth: int, params: SplitParams, *,
                 interaction_sets=None, max_leaves: int = 0, mesh=None,
                 quantised: bool = False) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "process parallelism combined with n_devices > 1 within a "
                "process is not ported to xgboost_tpu_torch (ROADMAP Queue 1 "
                "item 9): give each rank one device")
        super().__init__(max_depth, params, interaction_sets=interaction_sets,
                         max_leaves=max_leaves, quantised=quantised)
        self.exchange = HostExchange()

    def grow(self, bins, gpair, valid, cuts_pad, n_bins,
             feature_masks: Optional[FeatureMasks] = None,
             cat_mask=None) -> TreeState:
        """This rank's bins (R_pad, F), gpair (R_pad, 2) f32 and valid
        (R_pad,) bool; the cuts are the ranks' shared cuts."""
        device = bins.device
        B = cuts_pad.shape[1]
        setmat = self._set_matrix(bins.shape[1], device)
        cm = self._cat_mask(cat_mask, device)
        state = init_tree_state(
            gpair, valid, max_nodes=self.max_nodes,
            n_sets=1 if setmat is None else setmat.shape[0],
            max_splits=self.max_leaves - 1 if self.max_leaves > 0 else 0,
            n_cat_bin=B if cm is not None else 0)
        rho = None
        if self.quantised:
            gpair, rho, state = prepare_quantised(gpair, valid, state,
                                                  distributed=True)
        else:
            sync_root_totals(state)  # GlobalSum, updater_gpu_hist.cu:581
        build = build_histogram_q if self.quantised else build_histogram
        prev = None  # (best, can_split, depth) of the previous level
        hist_prev = None
        for d in range(self.max_depth + 1):
            last = d == self.max_depth
            subtract = not last and hist_prev is not None
            node0, N = (1 << d) - 1, 1 << d
            if prev is not None:
                pb, pc, pd = prev
                state.pos = _update_positions(bins, state.pos, pb, pc,
                                              (1 << pd) - 1, 1 << pd, B,
                                              cm is not None)
            hist = None
            if not last:
                h = build(bins, gpair, state.pos, node0=node0,
                          n_nodes=N // 2 if subtract else N, n_bin=B,
                          stride=2 if subtract else 1)
                # the level's one exchange (AllReduceHist); the limbs
                # reduce exactly, as int64
                hist = (allreduce_limbs(h, self.exchange) if self.quantised
                        else self.exchange.allreduce(h))
                if subtract:
                    hist = combine_sibling_hists(
                        hist, hist_prev, state.alive[node0: node0 + N])
            fm = None if feature_masks is None else feature_masks(d, N)
            best, can = decide_level(
                state, hist, cuts_pad, n_bins, None if last else fm, setmat,
                rho, cm, depth=d, params=self.params, last_level=last,
                budget=self.max_leaves > 0,
                fused_dequantise=False)
            hist_prev = hist
            prev = None if best is None else (best, can, d)
        return state
