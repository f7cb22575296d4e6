"""Exact greedy tree growth over raw feature values, tree_method="exact"
(port of xgboost_tpu/tree/exact.py; reference src/tree/updater_colmaker.cc:608
ColMaker): every distinct feature value is a split candidate instead of a
histogram bin.  XGBoost keeps this updater on the CPU (src/gbm/gbtree.cc:62
"exact is CPU-only") and chains ``prune`` after it; the port keeps both
decisions: host numpy, vectorized per-feature prefix scans in place of the
per-thread ColMaker enumerators, the same on either device, with
models/updaters.py:prune_tree applied by the Booster afterwards.

Split semantics (updater_colmaker.cc EnumerateSplit):
- forward pass: left = non-missing prefix, right = complement (missing
  rows ride right) -> default_left=False;
- backward pass: right = non-missing suffix, left = complement (missing
  rides left) -> default_left=True;
- candidates only between adjacent *distinct* values, threshold at the
  midpoint, both children must pass min_child_weight;
- gain = score(L) + score(R) - score(parent) with L1 thresholding
  (param.h CalcGain); any positive-gain split is accepted, gamma is the
  pruner's job.

Categorical features are not supported, as in the reference updater.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from ..models.tree import RegTree


def _thr_l1(g: np.ndarray, alpha: float) -> np.ndarray:
    if alpha == 0.0:
        return g
    return np.sign(g) * np.maximum(np.abs(g) - alpha, 0.0)


def _weight(G, H, lambda_: float, alpha: float, max_delta_step: float):
    w = -_thr_l1(G, alpha) / (H + lambda_)
    if max_delta_step > 0.0:
        w = np.clip(w, -max_delta_step, max_delta_step)
    return w


def _score(G, H, lambda_: float, alpha: float, max_delta_step: float = 0.0):
    """param.h CalcGain: closed form when the weight is unclipped, else
    CalcGainGivenWeight (param.h:245 — RAW grad, alpha enters as -2a|w|)
    at the clipped optimum; the two agree when the clip is inactive."""
    t = _thr_l1(G, alpha)
    if max_delta_step == 0.0:
        return t * t / (H + lambda_)
    w = _weight(G, H, lambda_, alpha, max_delta_step)
    return -(2.0 * G * w + (H + lambda_) * w * w
             + 2.0 * alpha * np.abs(w))


def grow_exact(
    X: np.ndarray,
    grad: np.ndarray,
    hess: np.ndarray,
    *,
    max_depth: int = 6,
    max_leaves: int = 0,
    lambda_: float = 1.0,
    alpha: float = 0.0,
    min_child_weight: float = 1.0,
    max_delta_step: float = 0.0,
    eta: float = 0.3,
    feature_masks: Optional[Callable] = None,
    min_split_loss_eps: float = 1e-6,  # colmaker kRtEps acceptance gate
    col_order: Optional[np.ndarray] = None,
) -> Tuple[RegTree, np.ndarray]:
    """Grow one tree depth-wise with exact split enumeration.

    X: (R, F) f32 raw features, NaN = missing.  grad/hess: (R,) f32; rows
    excluded from training (subsample / validity) must carry zero hess.
    max_depth=0 means unbounded (then max_leaves must bound the tree, as
    TrainParam validation requires one of the two to be positive).
    ``col_order`` lets the caller cache the per-column argsort across
    boosting rounds (it only depends on X).
    Returns (RegTree, pos) where pos (R,) int32 is each row's final leaf
    node id (for margin updates and adaptive leaf refitting).
    """
    R, F = X.shape
    g64 = grad.astype(np.float64)
    h64 = hess.astype(np.float64)

    # presort every column once (colmaker's column-major SortedCSC role);
    # NaNs sort to the tail and are cut off per column
    if col_order is None:
        col_order = np.argsort(X, axis=0, kind="stable")
    n_valid = R - np.isnan(X).sum(axis=0)

    # growing arrays, creation order (root = 0)
    left: List[int] = [-1]
    right: List[int] = [-1]
    parents: List[int] = [-1]
    split_indices: List[int] = [0]
    split_conditions: List[float] = [0.0]
    default_left: List[bool] = [False]
    base_weights: List[float] = [0.0]
    loss_changes: List[float] = [0.0]
    sum_hessian: List[float] = [0.0]

    pos = np.zeros(R, np.int32)  # row -> node id
    G0, H0 = g64.sum(), h64.sum()
    node_G = {0: G0}
    node_H = {0: H0}
    base_weights[0] = float(_weight(G0, H0, lambda_, alpha, max_delta_step))
    sum_hessian[0] = float(H0)

    n_leaves = 1  # each expansion nets +1
    frontier = [0]
    for depth in range(max_depth if max_depth > 0 else 2**31 - 1):
        if not frontier:
            break
        if max_leaves > 0 and n_leaves >= max_leaves:
            break
        fm = (feature_masks(depth, len(frontier))
              if feature_masks is not None else None)
        if fm is not None:
            fm = np.asarray(fm, bool)

        # ---- level-synchronous split search: ONE pass per column covering
        # every frontier node (ColMaker enumerates all nodes per column in a
        # single sweep too — per-node rescans would cost O(R*F*width)) ----
        act = [nid for nid in frontier if node_H[nid] >= 2 * min_child_weight]
        if not act:
            frontier = []
            break
        n_act = len(act)
        slot_in_frontier = {nid: s for s, nid in enumerate(frontier)}
        slot_of = np.full(len(left), -1, np.int64)
        slot_of[act] = np.arange(n_act)
        sl_rows = slot_of[pos]  # (R,) slot or -1
        member_count = np.bincount(sl_rows[sl_rows >= 0], minlength=n_act)
        Gp_a = np.array([node_G[n] for n in act])
        Hp_a = np.array([node_H[n] for n in act])
        parent_sc = _score(Gp_a, Hp_a, lambda_, alpha, max_delta_step)
        best_gain = np.full(n_act, min_split_loss_eps)
        best_feat = np.full(n_act, -1, np.int64)
        best_thr = np.zeros(n_act)
        best_dleft = np.zeros(n_act, bool)

        def _update_best(gains, slots, thrs, f, dleft):
            """Per-slot strict improvement, first-candidate tie-break
            (matches the scalar enumerator's `gains[j] > best` with
            np.argmax's first-max rule)."""
            finite = gains > -np.inf
            if not finite.any():
                return
            gs, ss, th = gains[finite], slots[finite], thrs[finite]
            # group by slot, best gain first, ties by candidate order
            order2 = np.lexsort((np.arange(gs.size), -gs, ss))
            ss_o = ss[order2]
            win = order2[np.r_[True, ss_o[1:] != ss_o[:-1]]]
            s_w = ss[win]
            upd = gs[win] > best_gain[s_w]
            s_u, w_u = s_w[upd], win[upd]
            best_gain[s_u] = gs[w_u]
            best_feat[s_u] = f
            best_thr[s_u] = th[w_u]
            best_dleft[s_u] = dleft

        act_fslot = np.minimum(
            np.array([slot_in_frontier[n] for n in act]),
            (fm.shape[0] - 1) if fm is not None else 0)
        for f in range(F):
            if n_valid[f] == 0:
                continue
            idx = col_order[: n_valid[f], f]
            sl = sl_rows[idx]
            keep = sl >= 0
            if fm is not None:
                # feature disabled for some nodes: mask their rows out
                fmrow = fm[act_fslot, f]  # (n_act,) allowed per act slot
                if not fmrow.any():
                    continue
                keep &= np.where(sl >= 0, fmrow[np.maximum(sl, 0)], False)
            idx2 = idx[keep]
            if idx2.size == 0:
                continue
            sl2 = sl[keep]
            # stable group-by-slot preserving the value order inside groups
            ordg = np.argsort(sl2, kind="stable")
            sl3 = sl2[ordg]
            idx3 = idx2[ordg]
            v = X[idx3, f]
            cg = np.concatenate(([0.0], np.cumsum(g64[idx3])))
            ch = np.concatenate(([0.0], np.cumsum(h64[idx3])))
            n = sl3.size
            seg_start = np.nonzero(np.r_[True, sl3[1:] != sl3[:-1]])[0]
            seg_end = np.r_[seg_start[1:], n]
            seg_slot = sl3[seg_start]
            seg_of = np.repeat(np.arange(seg_start.size),
                               seg_end - seg_start)
            Gnn_s = cg[seg_end] - cg[seg_start]
            Hnn_s = ch[seg_end] - ch[seg_start]
            has_missing_s = member_count[seg_slot] != (seg_end - seg_start)

            # interior candidates: adjacent distinct values within a segment
            interior = np.nonzero(
                (np.r_[sl3[1:] == sl3[:-1], False])
                & (np.r_[v[1:] != v[:-1], False]))[0]
            Gl = cg[interior + 1] - cg[seg_start[seg_of[interior]]]
            Hl = ch[interior + 1] - ch[seg_start[seg_of[interior]]]
            thr = (v[interior] + v[np.minimum(interior + 1, n - 1)]) * 0.5
            slots_c = sl3[interior]
            segs_c = seg_of[interior]
            # end-of-enumeration candidates where the node has missing rows
            # (colmaker proposes last_fvalue+eps / first_fvalue-eps): route
            # ALL non-missing one way, missing the other
            me = np.nonzero(has_missing_s)[0]
            if me.size:
                v_lo = v[seg_start[me]]
                v_hi = v[seg_end[me] - 1]
                lo_thr = v_lo - 1e-6 * (np.abs(v_lo) + 1.0)
                hi_thr = v_hi + 1e-6 * (np.abs(v_hi) + 1.0)
                Gl = np.concatenate((np.zeros(me.size), Gl, Gnn_s[me]))
                Hl = np.concatenate((np.zeros(me.size), Hl, Hnn_s[me]))
                thr = np.concatenate((lo_thr, thr, hi_thr))
                slots_c = np.concatenate((seg_slot[me], slots_c,
                                          seg_slot[me]))
                segs_c = np.concatenate((me, segs_c, me))
            if Gl.size == 0:
                continue
            Gp_c, Hp_c = Gp_a[slots_c], Hp_a[slots_c]
            psc_c = parent_sc[slots_c]
            # forward: missing rides right
            Gr_f, Hr_f = Gp_c - Gl, Hp_c - Hl
            ok_f = (Hl >= min_child_weight) & (Hr_f >= min_child_weight)
            gain_f = np.where(
                ok_f,
                _score(Gl, Hl, lambda_, alpha, max_delta_step)
                + _score(Gr_f, Hr_f, lambda_, alpha, max_delta_step)
                - psc_c,
                -np.inf)
            # backward: missing rides left
            Gr_b = Gnn_s[segs_c] - Gl
            Hr_b = Hnn_s[segs_c] - Hl
            Gl_b, Hl_b = Gp_c - Gr_b, Hp_c - Hr_b
            ok_b = (Hl_b >= min_child_weight) & (Hr_b >= min_child_weight)
            gain_b = np.where(
                ok_b,
                _score(Gl_b, Hl_b, lambda_, alpha, max_delta_step)
                + _score(Gr_b, Hr_b, lambda_, alpha, max_delta_step)
                - psc_c,
                -np.inf)
            _update_best(gain_f, slots_c, thr, f, False)
            _update_best(gain_b, slots_c, thr, f, True)

        # ---- expand winners (frontier order, leaf budget applies) ----
        next_frontier: List[int] = []
        for nid in frontier:
            if max_leaves > 0 and n_leaves >= max_leaves:
                break
            s = slot_of[nid]
            if s < 0 or best_feat[s] < 0:
                continue
            f = int(best_feat[s])
            # route AND store in f32: the reference computes the midpoint in
            # f32 ((fvalue+last)*0.5f); routing with the f64 midpoint while
            # storing f32 could send boundary rows left at train time but
            # right at predict time
            thr_v = float(np.float32(best_thr[s]))
            dleft = bool(best_dleft[s])
            l_id, r_id = len(left), len(left) + 1
            for arrs, vals in ((left, (-1, -1)), (right, (-1, -1)),
                               (parents, (nid, nid)),
                               (split_indices, (0, 0)),
                               (split_conditions, (0.0, 0.0)),
                               (default_left, (False, False)),
                               (loss_changes, (0.0, 0.0))):
                arrs.extend(vals)
            left[nid], right[nid] = l_id, r_id
            split_indices[nid] = f
            split_conditions[nid] = thr_v
            default_left[nid] = dleft
            loss_changes[nid] = float(best_gain[s])

            members = pos == nid
            x = X[members, f]
            goleft = np.where(np.isnan(x), dleft, x < thr_v)
            midx = np.nonzero(members)[0]
            pos[midx[goleft]] = l_id
            pos[midx[~goleft]] = r_id
            n_leaves += 1
            for cid in (l_id, r_id):
                cm = pos == cid
                Gc = g64[cm].sum()
                Hc = h64[cm].sum()
                node_G[cid], node_H[cid] = Gc, Hc
                base_weights.append(float(
                    _weight(Gc, Hc, lambda_, alpha, max_delta_step)))
                sum_hessian.append(float(Hc))
                next_frontier.append(cid)
        frontier = next_frontier

    # leaves: split_conditions hold eta * weight (RegTree leaf convention)
    larr = np.asarray(left, np.int32)
    sc = np.asarray(split_conditions, np.float32)
    bw = np.asarray(base_weights, np.float32)
    leaf_mask = larr == -1
    sc[leaf_mask] = (eta * bw[leaf_mask]).astype(np.float32)

    tree = RegTree(
        left_children=larr,
        right_children=np.asarray(right, np.int32),
        parents=np.asarray(parents, np.int32),
        split_indices=np.asarray(split_indices, np.int32),
        split_conditions=sc,
        default_left=np.asarray(default_left, bool),
        base_weights=bw,
        loss_changes=np.asarray(loss_changes, np.float32),
        sum_hessian=np.asarray(sum_hessian, np.float32),
        split_type=np.zeros(len(larr), np.int32),
        categories={},
    )
    return tree, pos
