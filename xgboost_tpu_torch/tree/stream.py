"""The streaming (external-memory) tree grower (port of
xgboost_tpu/tree/stream.py; reference updater_gpu_hist.cu:597, GetBatches
inside the driver loop).

Each level makes one pass over the matrix's pages: a page's rows are first
routed with the previous level's splits (``_update_positions`` on the page's
slice of ``pos``), then accumulated into the level's histogram, so a page
travels to the device once a level.  The histogram of a page is K1 (f32,
csrc/hist.cu) or, under deterministic_histogram, K2 (int32 limb sums,
csrc/hist_q.cu) on contiguous row slices of ``pos`` and the gradients;
across pages the f32 histograms add in page order (the reference's) and the
limb sums add as integers.  Then ``decide_level`` (tree/grow.py) takes the
level as the in-core grower does: the sibling subtraction, the one
dequantisation, the split scan (K3), the records and the leaves.  The pages
come through a ``PageScheduler`` (data/extmem.py), so on the card the copy
of the next pages overlaps the kernels of this one.

Under gradient-based sampling a page whose rows all sampled out (zero
gradient pairs) is left out of the level passes and routed once at the end
by replaying the recorded decisions (``_route_skipped``).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.hist_cuda import build_histogram, build_histogram_q
from ..ops.histogram import combine_sibling_hists
from ..ops.quantise import prepare_quantised
from ..ops.split import SplitParams
from .grow import (FeatureMasks, HistTreeGrower, TreeState, _update_positions,
                   decide_level, init_tree_state, max_nodes_for_depth)


class StreamingHistTreeGrower(HistTreeGrower):
    """Grow one tree over an ExtMemQuantileDMatrix's pages (reference
    tree/stream.py:125).  ``lossguide`` spends the ``max_leaves`` budget
    in order of gain within a level, as the reference's streaming grower
    does.  ``prefetch``: pages in flight beyond the one consumed (None:
    ``XTB_EXTMEM_PREFETCH_PAGES`` or 2; 0 puts copy and compute in series).
    ``page_skip``: gradient-based page residency."""

    def __init__(self, max_depth: int, params: SplitParams, *,
                 interaction_sets=None, max_leaves: int = 0,
                 lossguide: bool = False, quantised: bool = False,
                 prefetch: Optional[int] = None,
                 page_skip: bool = False) -> None:
        super().__init__(max_depth, params,
                         interaction_sets=interaction_sets,
                         max_leaves=max_leaves, quantised=quantised)
        self.lossguide = lossguide
        self.prefetch = prefetch
        self.page_skip = page_skip
        self.max_nodes = max_nodes_for_depth(max_depth)

    def _scheduler(self, dmat, idx: List[int], device):
        from ..data.extmem import prefetch_lookahead

        look = (prefetch_lookahead() if self.prefetch is None
                else self.prefetch)
        return dmat.scheduler([dmat._pages[i] for i in idx], device, look)

    def grow(self, dmat, gpair, valid, cuts_pad, n_bins,
             feature_masks: Optional[FeatureMasks] = None,
             cat_mask=None) -> TreeState:
        """``dmat`` an ExtMemQuantileDMatrix; gpair (R_pad, 2) f32 and
        valid (R_pad,) bool on the device over its page-padded rows;
        ``cat_mask`` (F,) numpy bool or None."""
        device = gpair.device
        F = dmat.num_col()
        B = cuts_pad.shape[1]
        offs = dmat.page_offsets()
        setmat = self._set_matrix(F, device)
        cm = self._cat_mask(cat_mask, device)
        has_cat = cm is not None
        state = init_tree_state(
            gpair, valid, max_nodes=self.max_nodes,
            n_sets=1 if setmat is None else setmat.shape[0],
            max_splits=self.max_leaves - 1 if self.max_leaves > 0 else 0,
            n_cat_bin=B if has_cat else 0)
        n_pages = len(dmat._pages)
        stream_idx = list(range(n_pages))
        skipped: List[int] = []
        if self.page_skip and n_pages > 1:
            # page residency, decided on the raw gradient pairs: a page
            # whose every row sampled out leaves the level passes (at
            # least one page stays)
            mass = gpair.abs().sum(dim=1)
            active = torch.stack([mass[offs[i]: offs[i + 1]].sum()
                                  for i in range(n_pages)]).cpu() > 0
            if not bool(active.any()):
                active[0] = True
            stream_idx = [i for i in range(n_pages) if active[i]]
            skipped = [i for i in range(n_pages) if not active[i]]
        rho = None
        if self.quantised:
            gpair, rho, state = prepare_quantised(gpair, valid, state)
        build_fn = build_histogram_q if self.quantised else build_histogram
        prev = None  # (best, can_split, depth) of the previous level
        decisions = []
        hist_prev = None
        pos = state.pos
        for d in range(self.max_depth + 1):
            last = d == self.max_depth
            subtract = not last and hist_prev is not None
            node0, N = (1 << d) - 1, 1 << d
            n_build = N // 2 if subtract else N
            hist = None
            sched = self._scheduler(dmat, stream_idx, device)
            try:
                for j, i in enumerate(stream_idx):
                    bins = sched.get(j)
                    lo, hi = offs[i], offs[i + 1]
                    if prev is not None:
                        pb, pc, pd = prev
                        pos[lo:hi] = _update_positions(
                            bins, pos[lo:hi], pb, pc, (1 << pd) - 1,
                            1 << pd, B, has_cat)
                    if not last:
                        h = build_fn(bins, gpair[lo:hi], pos[lo:hi],
                                     node0=node0, n_nodes=n_build, n_bin=B,
                                     stride=2 if subtract else 1)
                        hist = h if hist is None else hist.add_(h)
                    sched.release(j)
            finally:
                sched.close()
            if subtract:
                hist = combine_sibling_hists(hist, hist_prev,
                                             state.alive[node0: node0 + N])
            fm = None if feature_masks is None else feature_masks(d, N)
            best, can = decide_level(
                state, hist, cuts_pad, n_bins, None if last else fm, setmat,
                rho, cm, depth=d, params=self.params, last_level=last,
                budget=self.max_leaves > 0, lossguide=self.lossguide,
                fused_dequantise=False)
            hist_prev = hist
            if best is not None:
                decisions.append((best, can, d))
            prev = None if best is None else (best, can, d)
        if skipped:
            self._route_skipped(dmat, pos, offs, skipped, decisions, B,
                                has_cat, device)
        return state

    def _route_skipped(self, dmat, pos, offs, skipped, decisions, B,
                       has_cat, device) -> None:
        """One pass over the sampled-out pages, replaying every level's
        decisions, so that their rows sit on the leaves a full pass would
        have routed them to."""
        sched = self._scheduler(dmat, skipped, device)
        try:
            for j, i in enumerate(skipped):
                bins = sched.get(j)
                lo, hi = offs[i], offs[i + 1]
                for best, can, d in decisions:
                    pos[lo:hi] = _update_positions(
                        bins, pos[lo:hi], best, can, (1 << d) - 1, 1 << d, B,
                        has_cat)
                sched.release(j)
        finally:
            sched.close()
