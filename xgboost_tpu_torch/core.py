"""Booster: the trained model + training-step engine (port of the gbtree /
hist subset of xgboost_tpu/core.py).

Call stack for one boosting iteration:
  train() -> Booster.update(dtrain, i[, fobj])
    -> objective.get_gradient on the cached margin (or the
       caller's objective on the host, or boost()'s arrays)  [device]
    -> for each parallel tree p, for each output group k:
    -> _subsample_mask: the reference's row sample (threefry,
       one draw per p, shared by the K class trees)          [device]
    -> HistTreeGrower.grow: per level histogram (CUDA kernel
       K1 on the card, K2 under deterministic_histogram=1),
       split scan (K3) under the column sample and
       constraints, row routing                               [device]
       or, under grow_policy=lossguide with max_leaves > 1,
       BestFirstGrower.grow: one expansion at a time, a K1
       histogram of both children and their K3 scan per
       expansion                                       [device + host]
    -> for reg:absoluteerror and reg:quantileerror, the adaptive
       refit: each leaf the alpha-quantile of its rows' residuals
       (ops/adaptive.py)                                      [device]
    -> leaf_margin_delta updates the margin cache            [device]
    -> RegTree.from_grown (or to_regtree) appends the host model
A round grows ``num_parallel_tree`` x K trees (K = ``num_class`` for the
softmax objectives, ``num_target`` for the elementwise ones) in the
reference's order, and the round is the unit of ``num_boosted_rounds`` and
``iteration_range``.  With ``_lockstep=1`` the K class trees of a round
grow together in one level loop (LockstepHistGrower) where the reference's
gate allows it; with ``multi_strategy="multi_output_tree"`` a round is one
vector-leaf tree per parallel tree (MultiTargetTreeGrower), whose leaves
hold all K outputs.  The model dict
(``save_raw_dict``) follows the reference's JSON schema, so models
cross-load between the two packages.  Categorical features (the
DMatrix's ``'c'`` feature types) take the categorical split scan in both
growers; a frame's category values ride in the model as the
``cat_categories`` attribute, and a frame coded another way is recoded onto
them at prediction, as the reference does.
"""
from __future__ import annotations

import inspect
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .data.dmatrix import DMatrix, categories_by_name, recode_dense
from .metric import create_metric
from .models.tree import RegTree
from .objective import ObjFunction, create_objective
from .ops.adaptive import segment_quantile_leaf
from .ops.predict import (predict_leaf_ids, predict_margin_delta,
                          predict_margin_delta_multi)
from .ops.split import SplitParams
from .params import (KNOWN_LEARNER_KEYS, TrainParam, canonicalize,
                     reject_unsupported, split_unknown, tree_keys)
from .tree.bestfirst import BestFirstGrower
from .tree.grow import HistTreeGrower, leaf_margin_delta
from .tree.grow_lockstep import LockstepHistGrower, leaf_margin_delta_k
from .tree.grow_multi import MultiTargetTreeGrower, leaf_margin_delta_multi
from .utils.device import resolve_device
from .utils.fp import sqrt_f32, sum_f32
from .utils.random import bernoulli, prng_key, uniform

__all__ = ["Booster"]


class _Cache:
    """Per-DMatrix state on the booster's device: the margin cache, and for
    a training matrix the binned page with padded labels/weights/valid."""

    def __init__(self, dmat: DMatrix, device: torch.device):
        self.dmat = dmat
        self.device = device
        self.ellpack = None
        self.margin: Optional[torch.Tensor] = None  # (rows, K) f32
        self.n_trees_applied = 0

    def ensure_train(self, max_bin: int) -> None:
        if self.ellpack is not None:
            return
        ell = self.dmat.ensure_ellpack(max_bin=max_bin)
        dev = self.device
        self.ellpack = ell
        self.bins = ell.bins.to(dev)
        self.cuts_pad = ell.cuts_pad.to(dev)
        self.cuts_host = ell.cuts_pad.cpu().numpy()
        self.n_bins = ell.n_bins.to(dev)
        R_pad, R = ell.n_padded, ell.n_rows
        self.valid = torch.arange(R_pad, device=dev) < R

        def padded(a):  # (R,) or the (R, K) labels of K targets
            out = torch.zeros((R_pad, *a.shape[1:]), dtype=torch.float32,
                              device=dev)
            out[:R] = torch.from_numpy(a).to(dev)
            return out

        self.labels = padded(self.dmat.get_label())
        w = self.dmat.get_weight()
        # a weight a query group is the metrics' alone
        self.weights = None if w is None or len(w) != R else padded(w)
        if self.margin is not None and self.margin.shape[0] != R_pad:
            extra = torch.zeros((R_pad - self.margin.shape[0],
                                 self.margin.shape[1]), device=dev)
            self.margin = torch.cat([self.margin, extra])

    def bounds(self):
        """The survival bounds on the device, padded with ones as the
        labels' rows are (an absent upper bound is +inf on the rows);
        None without a lower bound.  Made once per pair of arrays."""
        lo, hi = self.dmat.label_lower_bound, self.dmat.label_upper_bound
        if lo is None:
            return None
        key = (id(lo), id(hi))
        if getattr(self, "_bounds_key", None) != key:
            if hi is None:
                hi = np.full_like(lo, np.inf)

            def padded(a):
                out = torch.ones(self.ellpack.n_padded, dtype=torch.float32,
                                 device=self.device)
                out[: a.shape[0]] = torch.from_numpy(
                    np.asarray(a, np.float32)).to(self.device)
                return out

            self._bounds = (padded(lo), padded(hi))
            self._bounds_key = key
        return self._bounds

    def n_rows(self) -> int:
        return self.ellpack.n_padded if self.ellpack is not None \
            else self.dmat.num_row()

    def base_margin_init(self, base_score: np.ndarray, K: int) -> torch.Tensor:
        R_pad = self.n_rows()
        out = torch.empty((R_pad, K), dtype=torch.float32, device=self.device)
        out[:] = torch.tensor(np.asarray(base_score, np.float32))
        user = self.dmat.base_margin
        if user is not None:
            m = np.asarray(user, np.float32).reshape(len(user), -1)
            out[: len(user)] = torch.tensor(m)  # (R, 1) broadcasts over K
        return out


class Booster:
    """Gradient-boosted tree model (reference: core.py:1749,
    learner.cc:1030).  ``device``: where training and prediction run;
    ``None`` means the ``device`` parameter if given, else ``cuda``.  An
    explicit ``device`` wins over the ``device`` parameter, from
    ``params``, ``set_param`` or a loaded configuration alike."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 cache: Sequence[DMatrix] = (),
                 model_file: Optional[Union[str, os.PathLike]] = None,
                 device=None) -> None:
        self.params: Dict[str, Any] = canonicalize(dict(params or {}))
        self._explicit_device = device is not None
        self.device = resolve_device(
            device if device is not None else self.params.get("device"))
        self.trees: List[RegTree] = []
        self.tree_info: List[int] = []
        self.attributes: Dict[str, str] = {}
        self.feature_names: Optional[List[str]] = None
        self.feature_types: Optional[List[str]] = None
        self.best_iteration: Optional[int] = None
        self.best_score: Optional[float] = None
        self._base_margin_value: Optional[np.ndarray] = None
        # the training frame's {feature -> category values}, for recoding
        # frames at prediction (reference: src/encoder/ordinal.h Recode)
        self._cat_categories: Optional[Dict[int, list]] = None
        self._num_feature: Optional[int] = None
        self._caches: Dict[int, _Cache] = {}
        self._configured = False
        if model_file is not None:
            self.load_model(model_file)
        for d in cache:
            self._get_cache(d)

    # ------------------------------------------------------------------ config
    def _configure(self) -> None:
        if self._configured:
            return
        p = self.params
        unknown = split_unknown(p)
        if unknown and str(p.get("validate_parameters", "")).lower() in (
                "1", "true"):
            raise ValueError(f"Unknown parameters: {unknown}")
        reject_unsupported(p)
        self.tparam = TrainParam.from_dict(p)
        self.objective: ObjFunction = create_objective(
            str(p.get("objective", "reg:squarederror")), p)
        self.num_class = int(p.get("num_class", 0))
        self.n_groups = max(1, self.objective.n_groups())
        self.num_parallel_tree = max(int(p.get("num_parallel_tree", 1)), 1)
        self._base_score_param = p.get("base_score", None)
        # exact limb histograms (ops/quantise.py): trees that do not depend
        # on the order of any sum (reference quantiser.cuh)
        self.deterministic_histogram = str(
            p.get("deterministic_histogram", "0")).lower() in ("1", "true")
        # vector-leaf trees: one tree carries all K outputs
        self.multi_strategy = str(p.get("multi_strategy",
                                        "one_output_per_tree"))
        if self.multi_strategy not in ("one_output_per_tree",
                                       "multi_output_tree"):
            raise ValueError(
                f"unknown multi_strategy {self.multi_strategy!r}")
        self._split_params = SplitParams(
            eta=float(self.tparam.eta), gamma=float(self.tparam.gamma),
            min_child_weight=float(self.tparam.min_child_weight),
            lambda_=float(self.tparam.lambda_), alpha=float(self.tparam.alpha),
            max_delta_step=float(self.tparam.max_delta_step),
            monotone=self.tparam.monotone_constraints,
            max_cat_to_onehot=int(self.tparam.max_cat_to_onehot))
        tp = self.tparam
        # (reference: xgboost_tpu/core.py:1349-1432, one device)
        lossguide = tp.grow_policy == "lossguide"
        self._best_first = lossguide and tp.max_leaves > 1
        if self._best_first:
            if self.deterministic_histogram:
                raise NotImplementedError(
                    "deterministic_histogram is not supported with the "
                    "best-first (lossguide + max_leaves) grower yet")
            # depth bounded by the leaf budget alone when max_depth <= 0
            self._grower = BestFirstGrower(
                max(tp.max_depth, 0), self._split_params,
                max_leaves=tp.max_leaves,
                interaction_sets=tp.interaction_constraints)
        else:
            self._grower = HistTreeGrower(
                self._resolve_max_depth(lossguide), self._split_params,
                interaction_sets=tp.interaction_constraints,
                max_leaves=tp.max_leaves,
                quantised=self.deterministic_histogram)
        # the adaptive leaf refit after each tree (reg:absoluteerror,
        # reg:quantileerror; reference core.py:1565-1605)
        self._adaptive = self.objective.adaptive_leaf()
        # the reference's opt-in class-batched grower (core.py:1510-1516):
        # the K class trees of a round in one level loop, numeric f32
        # histograms only; _boost_trees checks the rest of its gate
        self._lockstep = (
            not self._best_first and not self.deterministic_histogram
            # the refit is per tree: adaptive objectives grow sequentially
            and not self._adaptive
            and str(p.get("_hist_impl", "xla")) == "xla"
            and str(p.get("_lockstep", "0")).lower() in ("1", "true"))
        self._lockstep_grower = LockstepHistGrower(
            self._resolve_max_depth(lossguide), self._split_params,
            interaction_sets=tp.interaction_constraints,
            max_leaves=tp.max_leaves) if self._lockstep else None
        # level-synchronous under lossguide too, as the reference grows
        # vector-leaf trees (core.py:1147-1150)
        self._multi_grower = MultiTargetTreeGrower(
            self._resolve_max_depth(lossguide), self._split_params,
            self.n_groups, max_leaves=tp.max_leaves, lossguide=lossguide,
        ) if self.multi_strategy == "multi_output_tree" else None
        self._configured = True

    # parameters whose change invalidates the binned data, the margins or
    # the objective (reference core.py:272)
    _STRUCTURAL_KEYS = {"max_bin", "objective", "num_class", "device",
                        "booster", "tree_method", "base_score", "num_target",
                        "multi_strategy"}

    def set_param(self, params, value=None) -> None:
        """Update parameters (reference core.py:285): a structural change
        drops the caches, and the base margin of an untrained model."""
        if isinstance(params, str):
            params = {params: value}
        params = canonicalize(dict(params))
        structural = any(k in self._STRUCTURAL_KEYS
                         and self.params.get(k) != v
                         for k, v in params.items())
        if params.get("device") is not None and not self._explicit_device:
            self.device = resolve_device(params["device"])
        self.params.update(params)
        self._configured = False
        if structural:
            self._caches.clear()
            # a trained model's base score is model state: continuation
            # never estimates it again
            if not self.trees:
                self._base_margin_value = None

    def _resolve_max_depth(self, lossguide: bool) -> int:
        """The level grower's depth where max_depth <= 0: 10 levels under
        lossguide, 6 depthwise (reference core.py:670)."""
        md = self.tparam.max_depth
        return md if md > 0 else (10 if lossguide else 6)

    def _get_cache(self, dmat: DMatrix) -> _Cache:
        self._configure()
        key = id(dmat)
        if key not in self._caches:
            self._caches[key] = _Cache(dmat, self.device)
            if self._num_feature is None:
                self._num_feature = dmat.num_col()
        return self._caches[key]

    @property
    def base_score(self) -> np.ndarray:
        """Base margin per output group."""
        self._configure()
        if self._base_margin_value is None:
            return np.full(self.n_groups, 0.5, np.float32)
        return self._base_margin_value

    def _ensure_base_margin(self, cache: _Cache) -> None:
        if self._base_margin_value is None:
            # InitEstimation / FitStump (src/tree/fit_stump.cc:34)
            if self._base_score_param is not None:
                prob = torch.tensor(float(self._base_score_param))
                bm = self.objective.prob_to_margin(prob)
            elif not self.trees and cache.ellpack is not None:
                v = cache.valid
                bm = self.objective.init_estimation(
                    cache.labels[v],
                    None if cache.weights is None else cache.weights[v])
            else:
                bm = torch.zeros(self.n_groups)
            self._base_margin_value = np.broadcast_to(
                np.asarray(bm.cpu(), np.float32).reshape(-1),
                (self.n_groups,)).copy()
        if cache.margin is None:
            cache.margin = cache.base_margin_init(self._base_margin_value,
                                                  self.n_groups)
            cache.n_trees_applied = 0

    def _sync_margin(self, cache: _Cache) -> None:
        """Catch the cached margin up with all committed trees."""
        self._ensure_base_margin(cache)
        if cache.n_trees_applied < len(self.trees):
            new = slice(cache.n_trees_applied, len(self.trees))
            X = self._device_X(cache.dmat)
            R = X.shape[0]
            m = self._margin_delta_for(X, new, init=cache.margin[:R])
            cache.margin = torch.cat([m, cache.margin[R:]])
            cache.n_trees_applied = len(self.trees)

    # ------------------------------------------------------------------ train
    def _train_cache(self, dtrain: DMatrix) -> _Cache:
        self._configure()
        cache = self._get_cache(dtrain)
        cache.ensure_train(self.tparam.max_bin)
        if dtrain.cat_categories:
            cats = {int(k): list(v) for k, v in dtrain.cat_categories.items()}
            if self._cat_categories is None:
                self._cat_categories = cats
            elif cats != self._cat_categories:
                # the bins hold the frame's raw codes: training on them
                # against another frame's coding would mix two code spaces
                raise ValueError(
                    "continued training requires the training frame's "
                    "category ordering; re-declare the categorical columns "
                    "with the original categories")
        if self.feature_names is None and dtrain.feature_names:
            self.feature_names = list(dtrain.feature_names)
        if hasattr(self.objective, "set_group_info"):
            # keyed on the matrix and its group version, so continued
            # training on other query groups rebuilds the layout
            # (reference core.py:458-467); no groups: one over all rows
            owner = (id(dtrain), dtrain.group_version)
            if getattr(self.objective, "_group_owner", None) != owner:
                gp = dtrain.group_ptr
                if gp is None:
                    gp = np.array([0, dtrain.num_row()], np.int64)
                self.objective.set_group_info(gp)
                self.objective._group_owner = owner
        self._sync_margin(cache)
        return cache

    def update(self, dtrain: DMatrix, iteration: int, fobj=None) -> None:
        """One boosting iteration (learner.cc:1108 UpdateOneIter).  ``fobj``:
        a custom objective, called as ``fobj(margin, dtrain) -> (grad,
        hess)`` on the raw margins of the rows, (R,) or (R, K)."""
        cache = self._train_cache(dtrain)
        bounds = cache.bounds()
        if bounds is not None and hasattr(self.objective, "set_bounds"):
            # before each gradient (reference core.py:452-456)
            self.objective.set_bounds(*bounds)
        if fobj is not None:
            margin = cache.margin[cache.valid].cpu().numpy()
            grad, hess = fobj(margin[:, 0] if self.n_groups == 1 else margin,
                              dtrain)
            gpair = self._dense_gpair(cache, grad, hess)
        else:
            gpair = self.objective.get_gradient(cache.margin, cache.labels,
                                                cache.weights, iteration)
        gpair = gpair * cache.valid[:, None, None]  # (R_pad, K, 2)
        self._boost_trees(cache, gpair, iteration)

    def boost(self, dtrain: DMatrix, grad, hess, iteration: int = 0) -> None:
        """One iteration from the caller's gradient pairs, (R,) or (R, K)
        each (reference: XGBoosterBoostOneIter, core.py:551)."""
        cache = self._train_cache(dtrain)
        gpair = self._dense_gpair(cache, grad, hess)
        self._boost_trees(cache, gpair * cache.valid[:, None, None],
                          iteration)

    def _dense_gpair(self, cache: _Cache, grad, hess) -> torch.Tensor:
        """Host gradient pairs of the rows -> (R_pad, K, 2) f32 on the
        device, zero on the padding rows (reference core.py:536)."""
        R = cache.ellpack.n_rows
        g = np.asarray(grad, np.float32).reshape(R, -1)
        h = np.asarray(hess, np.float32).reshape(R, -1)
        out = torch.zeros((cache.n_rows(), g.shape[1], 2),
                          dtype=torch.float32, device=self.device)
        out[:R] = torch.from_numpy(np.stack([g, h], axis=-1)).to(self.device)
        return out

    def _subsample_mask(self, gpair, iteration: int):
        """Row subsampling: zeroed gradient pairs drop rows from the
        histograms and leaves (reference core.py:898, the same threefry
        draws over the padded rows).

        uniform: Bernoulli(subsample).  gradient_based: keep-probability
        proportional to the gradient norm sqrt(g^2 + lambda h^2), kept rows
        reweighted by 1/p so that histogram sums stay unbiased (reference
        src/tree/gpu_hist/sampler.cuh)."""
        tp = self.tparam
        if tp.subsample >= 1.0:
            return gpair
        key = prng_key((int(self.params.get("seed", 0)) * 7919 + iteration)
                       % (2**31))
        R, dev = gpair.shape[0], gpair.device
        if tp.sampling_method == "gradient_based":
            lam = float(tp.lambda_)
            norm = sqrt_f32(gpair[..., 0] ** 2 + lam * gpair[..., 1] ** 2)
            norm = norm.amax(dim=1)  # (R_pad,) across output groups
            total = torch.clamp(sum_f32(norm), min=1e-12)
            target = tp.subsample * (norm > 0).sum().to(torch.float32)
            p = torch.clamp(norm * target / total, 0.0, 1.0)
            keep = uniform(key, R, dev) < p
            scale = torch.where(keep, 1.0 / torch.clamp(p, min=1e-12), 0.0)
            return gpair * scale[:, None, None]
        mask = bernoulli(key, tp.subsample, R, dev)
        return gpair * mask[:, None, None]

    def _rng(self, iteration: int, tag: int) -> np.random.Generator:
        seed = int(self.params.get("seed", 0))
        return np.random.default_rng(
            (seed * 1_000_003 + iteration * 131 + tag) % (2**63))

    def _feature_masks(self, iteration: int, group: int, n_features: int,
                       feature_weights=None):
        """ColumnSampler (reference: src/common/random.h ColumnSampler):
        each level samples exactly max(1, frac * n_avail) of the surviving
        features without replacement, by the k smallest exponential keys
        per row, divided by ``feature_weights`` where given (the weighted
        draw, Efraimidis-Spirakis).  The draws are numpy on the host, in
        the reference's order, so they agree with it bitwise.  None when
        nothing is sampled."""
        tp = self.tparam
        fw = None
        if feature_weights is not None:
            # validated even when nothing is sampled, as the reference does
            fw = np.asarray(feature_weights, np.float64).reshape(-1)
            if fw.shape[0] != n_features:
                raise ValueError(
                    f"feature_weights has {fw.shape[0]} entries for "
                    f"{n_features} features")
            if (fw < 0).any():
                raise ValueError("feature_weights must be non-negative")
            if not (fw > 0).any():
                raise ValueError("feature_weights sums to zero")
        if tp.colsample_bytree >= 1.0 and tp.colsample_bylevel >= 1.0 \
                and tp.colsample_bynode >= 1.0:
            return None
        # parallel tree p: iteration * 131 + p and tag 17 + p (reference
        # core.py:857, :1517); its K class trees continue one stream
        rng = self._rng(iteration, 17 + group)
        w_row = np.ones(n_features, np.float64) if fw is None else fw

        def sample(prev_mask, frac):
            if frac >= 1.0:
                return prev_mask
            m2 = np.atleast_2d(prev_mask)
            rows, F = m2.shape
            with np.errstate(divide="ignore"):
                keys = rng.exponential(size=(rows, F)) / w_row
            keys = np.where(m2 & (w_row > 0), keys, np.inf)
            n_ok = np.isfinite(keys).sum(axis=1)
            if np.any(n_ok == 0):
                raise ValueError(
                    "feature_weights leaves no sampleable feature")
            k = np.minimum(np.maximum(1, (frac * m2.sum(axis=1)).astype(
                np.int64)), n_ok)
            order = np.argsort(keys, axis=1, kind="stable")
            ranks = np.empty_like(order)
            np.put_along_axis(ranks, order, np.broadcast_to(
                np.arange(F), (rows, F)).copy(), axis=1)
            out = ranks < k[:, None]
            return out if prev_mask.ndim == 2 else out[0]

        tree_mask = sample(np.ones(n_features, bool), tp.colsample_bytree)

        def per_level(depth: int, n_nodes: int):
            m = sample(tree_mask, tp.colsample_bylevel)
            if tp.colsample_bynode < 1.0:
                m = sample(np.broadcast_to(m, (n_nodes, n_features)).copy(),
                           tp.colsample_bynode)
            return torch.from_numpy(np.atleast_2d(m)).to(self.device)

        return per_level

    def _boost_trees(self, cache: _Cache, gpair, iteration: int) -> None:
        """Grow one round's trees (reference core.py:1516-1617, the
        sequential branch): for each parallel tree p its column sampler
        and row sample, seeded by ``iteration * 131 + p`` and shared by the
        K class trees, which grow in class order on their own column of
        the gradient pairs; tree k adds its leaves into margin column k."""
        mono = self.tparam.monotone_constraints
        n_features = cache.bins.shape[1]
        if mono is not None and len(mono) != n_features:
            raise ValueError(
                f"monotone_constraints has {len(mono)} entries but data has "
                f"{n_features} features")
        K = gpair.shape[1]
        cat_mask = cache.dmat.cat_mask()
        if self.multi_strategy == "multi_output_tree" and K > 1:
            self._boost_multi_target(cache, gpair, iteration, cat_mask)
            return
        # the reference's lockstep gate (core.py:1510-1516, :1522); where
        # it does not hold, the sequential loop is the reference's own
        # semantics, not a fallback of the device
        lockstep = self._lockstep and K > 1 and cat_mask is None
        for p in range(self.num_parallel_tree):
            fmask_fn = self._feature_masks(iteration * 131 + p, p,
                                           n_features,
                                           cache.dmat.feature_weights)
            gp = self._subsample_mask(gpair, iteration * 131 + p)
            if lockstep and fmask_fn is None:
                lk = self._lockstep_grower
                state = lk.grow(cache.bins, gp.contiguous(), cache.valid,
                                cache.cuts_pad, cache.n_bins)
                cache.margin += leaf_margin_delta_k(state.pos,
                                                    state.leaf_val).T
                for k in range(K):
                    self.trees.append(RegTree.from_grown(
                        lk.to_host_class(state, k)))
                    self.tree_info.append(k)
                continue
            for k in range(K):
                state = self._grower.grow(
                    cache.bins, gp[:, k, :].contiguous(), cache.valid,
                    cache.cuts_pad, cache.n_bins, feature_masks=fmask_fn,
                    cat_mask=cat_mask)
                tree = None
                if self._best_first:
                    tree, leaf_val = self._grower.to_regtree(
                        state, cache.cuts_host)
                else:
                    leaf_val = state.leaf_val
                if self._adaptive:
                    leaf_val = self._refit_leaves(cache, state, tree, k)
                    if not self._best_first:
                        state.leaf_val = leaf_val
                if tree is None:
                    tree = RegTree.from_grown(HistTreeGrower.to_host(state))
                cache.margin[:, k] += leaf_margin_delta(state.pos, leaf_val)
                self.trees.append(tree)
                self.tree_info.append(k)
        cache.n_trees_applied = len(self.trees)

    def _refit_leaves(self, cache: _Cache, state, tree: Optional[RegTree],
                      k: int) -> torch.Tensor:
        """Output group k's tree with exact quantile leaves (reference
        core.py:1565-1605, ObjFunction::UpdateTreeLeaf): each leaf becomes
        eta times the alpha-quantile of its rows' residuals against the
        margin before the tree, on the device.  A best-first tree takes the
        values into its leaves' split_conditions."""
        if self._best_first:
            is_leaf, n_slots = self._grower.leaf_mask(state), \
                self._grower.n_slots
        else:
            is_leaf, n_slots = state.is_leaf, self._grower.max_nodes
        residual = cache.labels - cache.margin[:, k]
        leaf_val = segment_quantile_leaf(
            state.pos, residual, cache.valid, is_leaf,
            float(self.objective.adaptive_alpha(k)), float(self.tparam.eta),
            max_nodes=n_slots)
        if self._best_first:
            lv = leaf_val[: tree.n_nodes].cpu().numpy()
            lm = tree.left_children == -1
            tree.split_conditions[lm] = lv[lm]
        return leaf_val

    def _boost_multi_target(self, cache: _Cache, gpair, iteration: int,
                            cat_mask) -> None:
        """One vector-leaf tree a round per parallel tree (reference
        core.py:1121-1190): 2K-channel histograms, summed-gain splits,
        K-vector leaves, seeded as the scalar trees (iteration * 131 + p)."""
        if self.deterministic_histogram:
            raise NotImplementedError(
                "deterministic_histogram is not supported with "
                "multi_output_tree yet")
        if cat_mask is not None and np.any(cat_mask):
            raise NotImplementedError(
                "multi_output_tree with categorical features is not "
                "supported yet")
        mono = self.tparam.monotone_constraints
        if mono is not None and any(c != 0 for c in mono):
            raise NotImplementedError(
                "multi_output_tree with monotone constraints is not "
                "supported")
        n_features = cache.bins.shape[1]
        for p in range(self.num_parallel_tree):
            fmask_fn = self._feature_masks(iteration * 131 + p, p,
                                           n_features,
                                           cache.dmat.feature_weights)
            gp = self._subsample_mask(gpair, iteration * 131 + p)
            state = self._multi_grower.grow(
                cache.bins, gp.contiguous(), cache.valid, cache.cuts_pad,
                cache.n_bins, feature_masks=fmask_fn)
            cache.margin += leaf_margin_delta_multi(state.pos,
                                                    state.leaf_val)
            self.trees.append(RegTree.from_grown_multi(
                MultiTargetTreeGrower.to_host(state)))
            self.tree_info.append(0)
        cache.n_trees_applied = len(self.trees)

    # ------------------------------------------------------------------ eval
    def eval_set(self, evals: Sequence[Tuple[DMatrix, str]],
                 iteration: int = 0, feval=None,
                 output_margin: bool = True) -> str:
        """(reference: learner.cc:1159 EvalOneIter).  ``feval``: a custom
        metric, ``feval(margin, dmat) -> (name, value)`` or a list of
        them, given the raw (R, K) margins (the transformed predictions
        with ``output_margin=False``)."""
        self._configure()
        msgs = [f"[{iteration}]"]
        metrics = self._eval_metric_list()
        for dmat, name in evals:
            cache = self._get_cache(dmat)
            self._sync_margin(cache)
            margin = cache.margin[: dmat.num_row()]
            preds = self.objective.pred_transform(margin).cpu().numpy()
            if self.n_groups == 1:
                preds = preds[:, 0]
            labels = dmat.get_label()
            mkw = self._metric_kwargs(dmat)
            for fn, mname in metrics:
                kw, lab = dict(mkw), labels
                if "alphas" in kw and "alphas" not in inspect.signature(
                        getattr(fn, "__wrapped__", fn)).parameters:
                    # a generic metric of a multi-alpha model: the labels
                    # tiled so that (R, Q) predictions broadcast per level
                    kw.pop("alphas")
                    if preds.ndim == 2 and lab.ndim == 1:
                        lab = np.repeat(lab[:, None], preds.shape[1], axis=1)
                v = fn(preds, lab, dmat.get_weight(), **kw)
                msgs.append(f"{name}-{mname}:{v:g}")
            if feval is not None:
                res = feval(margin.cpu().numpy() if output_margin else preds,
                            dmat)
                for mname, v in [res] if isinstance(res, tuple) else res:
                    msgs.append(f"{name}-{mname}:{v:g}")
        return "\t".join(msgs)

    def _metric_kwargs(self, dmat: DMatrix) -> dict:
        """The metrics' keyword arguments (reference core.py:1694-1708):
        the query groups, the booster's device (where aft-nloglik takes
        its f32 loss and the ranking metrics their segment sums),
        survival bounds, AFT's distribution and scale, huber_slope, and
        the alphas of a multi-alpha model."""
        mkw = {"group_ptr": dmat.group_ptr, "device": self.device}
        if dmat.label_lower_bound is not None:
            mkw["y_lower"] = dmat.label_lower_bound
            ub = dmat.label_upper_bound
            mkw["y_upper"] = (np.full_like(mkw["y_lower"], np.inf)
                              if ub is None else ub)
        if hasattr(self.objective, "dist"):
            mkw["dist"] = self.objective.dist
            mkw["sigma"] = self.objective.sigma
        if "huber_slope" in self.params:
            mkw["slope"] = float(self.params["huber_slope"])
        if hasattr(self.objective, "_alphas") and self.n_groups > 1:
            mkw["alphas"] = self.objective._alphas()
        return mkw

    def _eval_metric_list(self):
        names = self.params.get("eval_metric", None)
        if names is None:
            if str(self.params.get("disable_default_eval_metric", "0")
                   ).lower() in ("1", "true"):
                return []
            names = [self.objective.default_metric()]
        elif isinstance(names, str):
            names = [names]
        return [create_metric(n) for n in names]

    # ------------------------------------------------------------------ predict
    def _device_X(self, dmat: DMatrix) -> torch.Tensor:
        """The matrix on the booster's device, its categorical codes
        recoded onto the training frame's categories where they differ."""
        host = dmat.host_dense()
        X = recode_dense(host, self._cat_categories, dmat.cat_categories)
        if X is host and dmat.X is not None:
            return dmat.X.to(self.device)
        return torch.from_numpy(X).to(self.device)

    def _stacked(self, tree_slice: slice):
        trees = self.trees[tree_slice]
        width = max(t.n_nodes for t in trees)
        depth = max(t.max_depth for t in trees) + 1
        has_cat = any(t.has_categorical for t in trees)
        if any(t.leaf_vector is not None for t in trees) and not all(
                t.leaf_vector is not None for t in trees):
            raise ValueError("a model mixes vector-leaf and scalar trees")
        cols: Dict[str, list] = {}
        for t in trees:
            for k, v in t.padded_arrays(width).items():
                cols.setdefault(k, []).append(v)
        if has_cat:
            n_cats = max(t.max_category for t in trees) + 1
            cols["catm"] = [t.cat_matrix(width, n_cats) for t in trees]
        else:
            del cols["is_cat"]
        stacked = {k: torch.from_numpy(np.stack(v)).to(self.device)
                   for k, v in cols.items()}
        return stacked, self.tree_info[tree_slice], depth

    def _margin_delta_for(self, X, tree_slice: slice, init=None):
        s, groups, depth = self._stacked(tree_slice)
        if "value_vec" in s:  # vector leaves add to every output
            return predict_margin_delta_multi(
                X, s["feat"], s["thr"], s["dleft"], s["left"], s["right"],
                s["value_vec"], init, depth=depth)
        return predict_margin_delta(
            X, s["feat"], s["thr"], s["dleft"], s["left"], s["right"],
            s["value"], groups, init, s.get("is_cat"), s.get("catm"),
            n_groups=self.n_groups, depth=depth)

    def predict(self, data: DMatrix, output_margin: bool = False,
                pred_leaf: bool = False,
                iteration_range: Tuple[int, int] = (0, 0),
                strict_shape: bool = False) -> np.ndarray:
        """(reference: core.py:2424 Booster.predict).  ``iteration_range``
        counts rounds; ``pred_leaf``: the (R, T) int32 leaf id of every
        row in every tree of the range."""
        self._configure()
        lo, hi = iteration_range
        hi = hi or self.num_boosted_rounds()
        tpr = self.trees_per_round
        tree_slice = slice(lo * tpr, hi * tpr)
        if pred_leaf:
            if not self.trees[tree_slice]:
                return np.zeros((data.num_row(), 0), np.int32)
            s, _, depth = self._stacked(tree_slice)
            return predict_leaf_ids(
                self._device_X(data), s["feat"], s["thr"], s["dleft"],
                s["left"], s["right"], s.get("is_cat"), s.get("catm"),
                depth=depth).cpu().numpy()
        base = np.broadcast_to(self.base_score.reshape(-1), (self.n_groups,))
        if self.trees[tree_slice]:
            X = self._device_X(data)
            delta = self._margin_delta_for(X, tree_slice).cpu().numpy()
            margin = delta + base[None, :]
        else:
            margin = np.broadcast_to(
                base, (data.num_row(), self.n_groups)).copy()
        if data.base_margin is not None:
            um = np.asarray(data.base_margin, np.float32).reshape(
                data.num_row(), -1)
            margin = margin - base[None, :] + um
        out = margin if output_margin else \
            self.objective.pred_transform(torch.from_numpy(margin)).numpy()
        if self.n_groups == 1 and not strict_shape:
            out = out[:, 0]
        return out

    def inplace_predict(self, data, iteration_range: Tuple[int, int] = (0, 0),
                        predict_type: str = "value", missing: float = np.nan,
                        validate_features: bool = True, base_margin=None,
                        strict_shape: bool = False) -> np.ndarray:
        """Predict from raw data without a caller's DMatrix (reference
        core.py:2044): a numpy array, a scipy sparse matrix, a pandas frame
        or a tensor on the CPU or the card, staged on the booster's device.
        ``predict_type``: ``"value"`` or ``"margin"``."""
        if predict_type not in ("value", "margin"):
            raise ValueError(f"unknown predict_type {predict_type!r}")
        d = DMatrix(data, missing=missing, base_margin=base_margin,
                    device=self.device)
        return self.predict(d, output_margin=predict_type == "margin",
                            iteration_range=iteration_range,
                            strict_shape=strict_shape)

    # ------------------------------------------------------------------ model
    @property
    def trees_per_round(self) -> int:
        self._configure()
        if self.multi_strategy == "multi_output_tree" and self.n_groups > 1:
            return self.num_parallel_tree  # one vector tree a parallel tree
        return self.n_groups * self.num_parallel_tree

    def num_boosted_rounds(self) -> int:
        return len(self.trees) // self.trees_per_round

    def __getitem__(self, val: slice) -> "Booster":
        """The rounds ``val.start`` to ``val.stop`` as a booster of their
        own, on this booster's device, without the caches (reference
        core.py:2478, Learner::Slice)."""
        if not isinstance(val, slice):
            raise TypeError("Booster slicing requires a slice of rounds")
        if val.step not in (None, 1):
            raise ValueError("Booster slicing takes no step")
        self._configure()
        lo = val.start or 0
        hi = val.stop if val.stop is not None else self.num_boosted_rounds()
        out = Booster(dict(self.params), device=self.device)
        k = self.trees_per_round
        out.trees = self.trees[lo * k: hi * k]
        out.tree_info = self.tree_info[lo * k: hi * k]
        # the training frame's categories too: a slice recodes frames at
        # prediction as its booster does
        for name in ("_base_margin_value", "_num_feature", "feature_names",
                     "feature_types", "best_iteration", "best_score",
                     "_cat_categories"):
            setattr(out, name, getattr(self, name))
        out.attributes = dict(self.attributes)
        return out

    def copy(self) -> "Booster":
        """A booster of the same trees and parameters, without the caches
        (reference core.py:2502)."""
        return self[0: self.num_boosted_rounds()]

    def num_features(self) -> int:
        if self._num_feature:
            return self._num_feature
        if self.trees:
            return int(max(t.split_indices.max(initial=0)
                           for t in self.trees)) + 1
        return 0

    def get_categories(self) -> Optional[Dict[str, list]]:
        """The training frame's category values per categorical feature,
        keyed by feature name (or index), None without frame categories
        (reference: ``XGBoosterGetCategories``)."""
        return categories_by_name(self._cat_categories, self.feature_names)

    def _fmap_names(self, fmap: str) -> Optional[List[str]]:
        """The feature names, those of a feature-map file where given:
        ``<id>\t<name>\t<type>`` a line (reference core.py:2505-2520,
        src/common/feature_map.h LoadText); tab-separated, so names may
        hold spaces; split on whitespace only where a line has no tab."""
        names = self.feature_names
        if not fmap:
            return names
        names = list(names or [f"f{i}" for i in range(self.num_features())])
        with open(fmap) as fh:
            for line in fh:
                line = line.rstrip("\n")
                parts = line.split("\t") if "\t" in line else line.split()
                if len(parts) >= 2:
                    fid = int(parts[0])
                    while len(names) <= fid:
                        names.append(f"f{len(names)}")
                    names[fid] = parts[1]
        return names

    def get_dump(self, fmap: str = "", with_stats: bool = False,
                 dump_format: str = "text") -> List[str]:
        """Each tree as text or JSON (tree_model.cc DumpModel), features
        named by ``feature_names`` or the feature map ``fmap``."""
        names = self._fmap_names(fmap)
        if dump_format == "json":
            return [t.dump_json(names, with_stats) for t in self.trees]
        return [t.dump_text(names, with_stats) for t in self.trees]

    def get_score(self, fmap: str = "", importance_type: str = "weight"
                  ) -> Dict[str, float]:
        """Feature importance by name (reference core.py:2526): ``weight``
        (the splits on a feature), ``gain`` and ``cover`` (the mean loss
        change and hessian sum of its splits), ``total_gain`` and
        ``total_cover`` (their sums).  Features named as ``get_dump`` names
        them."""
        if importance_type not in ("weight", "gain", "cover", "total_gain",
                                   "total_cover"):
            raise ValueError(f"unknown importance_type {importance_type!r}")
        self._configure()
        names = self._fmap_names(fmap) or [
            f"f{i}" for i in range(self.num_features())]
        acc: Dict[str, float] = {}
        cnt: Dict[str, int] = {}
        for t in self.trees:
            for nid in range(t.n_nodes):
                if t.left_children[nid] == -1:
                    continue
                f = names[t.split_indices[nid]]
                cnt[f] = cnt.get(f, 0) + 1
                if importance_type in ("gain", "total_gain"):
                    acc[f] = acc.get(f, 0.0) + float(t.loss_changes[nid])
                elif importance_type in ("cover", "total_cover"):
                    acc[f] = acc.get(f, 0.0) + float(t.sum_hessian[nid])
                else:
                    acc[f] = acc.get(f, 0.0) + 1.0
        if importance_type in ("gain", "cover"):
            return {k: v / cnt[k] for k, v in acc.items()}
        return acc

    def attr(self, key: str) -> Optional[str]:
        return self.attributes.get(key)

    def set_attr(self, **kwargs: Optional[str]) -> None:
        for k, v in kwargs.items():
            if v is None:
                self.attributes.pop(k, None)
            else:
                self.attributes[k] = str(v)

    def save_model(self, fname: Union[str, os.PathLike]) -> None:
        """JSON (``.json``) or UBJSON (``.ubj``) model file (reference:
        learner.cc:950 SaveModel)."""
        fname = os.fspath(fname)
        raw = self.save_raw("ubj" if fname.endswith(".ubj") else "json")
        with open(fname, "wb") as fh:
            fh.write(raw)

    def save_raw(self, raw_format: str = "ubj") -> bytearray:
        """The model file's bytes, UBJSON or JSON (reference core.py:2268)."""
        obj = self.save_raw_dict()
        if raw_format == "json":
            return bytearray(json.dumps(obj).encode())
        import io

        from .utils.ubjson import dump_ubjson

        buf = io.BytesIO()
        dump_ubjson(obj, buf)
        return bytearray(buf.getvalue())

    def _base_score_str(self) -> str:
        """base_score in probability space, reference model-JSON form: a
        scalar, or the bracketed vector where the groups' values differ
        (reference core.py:2093-2103)."""
        probs = [float(self.objective.margin_to_prob(torch.tensor(m)))
                 for m in np.asarray(self.base_score, np.float32).reshape(-1)]
        if len(probs) > 1 and not np.allclose(probs, probs[0]):
            return "[" + ",".join(f"{p:.9E}" for p in probs) + "]"
        return f"{probs[0]:.9E}"

    def save_raw_dict(self) -> dict:
        self._configure()
        n_feat = self.num_features()
        model = {
            "gbtree_model_param": {
                "num_trees": str(len(self.trees)),
                "num_parallel_tree": str(self.num_parallel_tree)},
            "trees": [t.to_json_dict(n_feat, tree_id=i)
                      for i, t in enumerate(self.trees)],
            "tree_info": list(self.tree_info),
        }
        objective = {"name": self.objective.name}
        if self.objective.name.startswith("multi:"):
            objective["softmax_multiclass_param"] = {
                "num_class": str(self.num_class)}
        # the exact f32 margin rides as an attribute: prob <-> margin does
        # not round-trip bitwise in f32
        attrs = dict(self.attributes)
        attrs["base_margin_exact"] = " ".join(
            repr(float(v)) for v in np.asarray(self.base_score).reshape(-1))
        if self._cat_categories:
            # the training frame's categories, for recoding at prediction
            attrs["cat_categories"] = json.dumps(self._cat_categories)
        return {
            "version": [3, 1, 0],
            "learner": {
                "attributes": attrs,
                "feature_names": self.feature_names or [],
                "feature_types": self.feature_types or [],
                "gradient_booster": {"model": model, "name": "gbtree"},
                "learner_model_param": {
                    "base_score": self._base_score_str(),
                    "boost_from_average": "1",
                    "num_class": str(self.num_class),
                    "num_feature": str(n_feat),
                    "num_target": str(self.n_groups if self.num_class == 0
                                      else 1),
                },
                "objective": objective,
            },
        }

    def load_model(self, fname: Union[str, os.PathLike, bytes, bytearray]) -> None:
        if isinstance(fname, (bytes, bytearray)):
            import io

            from .utils.ubjson import load_ubjson

            try:
                obj = json.loads(fname)
            except (UnicodeDecodeError, json.JSONDecodeError):
                obj = load_ubjson(io.BytesIO(bytes(fname)))
        else:
            fname = os.fspath(fname)
            if fname.endswith(".ubj"):
                from .utils.ubjson import load_ubjson

                with open(fname, "rb") as fh:
                    obj = load_ubjson(fh)
            else:
                with open(fname) as fh:
                    obj = json.load(fh)
        self.load_model_dict(obj)

    def load_model_dict(self, obj: dict) -> None:
        learner = obj["learner"]
        lmp = learner["learner_model_param"]
        gbooster = learner["gradient_booster"]
        self.params.setdefault("objective", learner["objective"]["name"])
        for key, default in (("num_class", "0"), ("num_target", "1")):
            if str(lmp.get(key, default) or default) != default:
                self.params[key] = int(lmp[key])
        self.params.setdefault("booster", gbooster.get("name", "gbtree"))
        self._configured = False
        self._caches.clear()
        self._configure()
        exact = learner.get("attributes", {}).get("base_margin_exact")
        if exact is not None:
            vals = np.asarray([float(v) for v in str(exact).split()], np.float32)
        else:
            # a scalar, or the bracketed per-group vector of XGBoost >= 3
            raw = str(lmp["base_score"]).strip().strip("[]()")
            probs = np.asarray([float(v) for v in
                                raw.replace(",", " ").split()], np.float32)
            if probs.size == 0:
                raise ValueError(
                    f"Cannot parse base_score {lmp['base_score']!r}")
            vals = self.objective.prob_to_margin(
                torch.from_numpy(probs)).numpy()
        if vals.size not in (1, self.n_groups):
            raise ValueError(
                f"base_score has {vals.size} entries but the model has "
                f"{self.n_groups} output groups")
        self._base_margin_value = np.broadcast_to(
            vals.astype(np.float32).reshape(-1), (self.n_groups,)).copy()
        self._num_feature = int(lmp.get("num_feature", "0")) or None
        gb = gbooster["model"]
        self.trees = [RegTree.from_json_dict(t) for t in gb["trees"]]
        self.tree_info = [int(i) for i in gb["tree_info"]]
        if any(t.leaf_vector is not None for t in self.trees):
            self.params["multi_strategy"] = "multi_output_tree"
            self._configured = False
        npt = gb.get("gbtree_model_param", {}).get("num_parallel_tree", "1")
        self.num_parallel_tree = int(npt or 1)
        self.params.setdefault("num_parallel_tree", self.num_parallel_tree)
        self.attributes = dict(learner.get("attributes", {}))
        self.attributes.pop("base_margin_exact", None)
        cc = self.attributes.pop("cat_categories", None)
        self._cat_categories = ({int(k): list(v)
                                 for k, v in json.loads(cc).items()}
                                if cc else None)
        self.feature_names = learner.get("feature_names") or None
        self.feature_types = learner.get("feature_types") or None

    # ------------------------------------------------------- configuration
    # The model files above carry the model; these carry the training
    # configuration (reference: learner.cc:625 SaveConfig, :570 LoadConfig),
    # in the reference's layout, so a restored booster continues training
    # as the one it was saved from.
    def _device_str(self) -> str:
        """``cpu`` or ``cuda:N``: the device this booster runs on."""
        if self.device.type != "cuda":
            return self.device.type
        index = self.device.index
        if index is None:
            index = torch.cuda.current_device()
        return f"cuda:{index}"

    def _config_dict(self) -> dict:
        """(reference core.py:2284) Every value a string, as the
        reference's: lists and tuples as JSON, booleans as "1"/"0"."""
        self._configure()

        def s(v):
            if isinstance(v, bool):
                return "1" if v else "0"
            if isinstance(v, (list, tuple, dict)):
                return json.dumps(v)
            return str(v)

        params = {k: v for k, v in self.params.items() if v is not None}
        tkeys = tree_keys()
        hist_param = {}
        for k in sorted(tkeys):
            v = getattr(self.tparam, "lambda_" if k == "lambda" else k)
            if v is not None:
                hist_param[k] = s(v)
        placed = set(tkeys)

        def take(section: dict, key: str, default=None) -> None:
            if key in params:
                section[key] = s(params[key])
                placed.add(key)
            elif default is not None:
                section[key] = s(default)

        learner_train = {"booster": "gbtree",
                         "objective": self.objective.name}
        placed |= {"booster", "objective"}
        take(learner_train, "disable_default_eval_metric", 0)
        take(learner_train, "multi_strategy", self.multi_strategy)

        # the device the booster runs on, whatever the parameter said
        generic = {"device": self._device_str()}
        placed.add("device")
        take(generic, "seed", 0)
        take(generic, "seed_per_iteration", 0)
        take(generic, "nthread", 0)
        take(generic, "validate_parameters", 0)

        gbt = {"num_parallel_tree": s(self.num_parallel_tree)}
        placed.add("num_parallel_tree")
        take(gbt, "process_type", "default")
        take(gbt, "tree_method", "hist")
        take(gbt, "updater")
        gb = {"name": "gbtree", "gbtree_train_param": gbt,
              "updater": {"grow_quantile_histmaker": {
                  "hist_train_param": hist_param}}}

        obj_sec: dict = {"name": self.objective.name}
        for k in ("scale_pos_weight", "num_class", "tweedie_variance_power",
                  "huber_slope", "quantile_alpha", "expectile_alpha",
                  "aft_loss_distribution", "aft_loss_distribution_scale",
                  "lambdarank_num_pair_per_sample", "lambdarank_pair_method",
                  "ndcg_exp_gain", "lambdarank_unbiased",
                  "lambdarank_bias_norm"):
            take(obj_sec, k)

        names = params.get("eval_metric")
        if names is None:
            metrics = []
        elif isinstance(names, (list, tuple)):
            metrics = [{"name": str(m)} for m in names]
        else:
            metrics = [{"name": str(names)}]
        placed.add("eval_metric")

        # the user's other known parameters ride in generic_param, so that
        # load_config restores every one of them
        for k in sorted(params):
            if k not in placed and k in (KNOWN_LEARNER_KEYS | tkeys):
                generic[k] = s(params[k])

        return {
            "version": [3, 1, 0],
            "learner": {
                "generic_param": generic,
                "gradient_booster": gb,
                "learner_model_param": {
                    "base_score": ("5E-1" if self._base_margin_value is None
                                   else self._base_score_str()),
                    "num_class": str(self.num_class),
                    "num_feature": str(self.num_features()),
                    "num_target": str(self.n_groups if self.num_class == 0
                                      else 1),
                },
                "learner_train_param": learner_train,
                "metrics": metrics,
                "objective": obj_sec,
            },
        }

    def save_config(self) -> str:
        """The training configuration as a JSON string (reference:
        Booster.save_config, XGBoosterSaveJsonConfig)."""
        return json.dumps(self._config_dict())

    def load_config(self, config: Union[str, bytes, dict]) -> None:
        """Apply a ``save_config()`` snapshot, this package's or the
        reference's (learner.cc:570 LoadConfig): every known parameter of
        its sections, as strings.  Leading-underscore keys are not part of
        a configuration.  The ``device`` it names applies unless this
        booster was given one explicitly."""
        obj = config if isinstance(config, dict) else json.loads(config)
        learner = obj.get("learner", obj)
        known = KNOWN_LEARNER_KEYS | tree_keys()
        collected: Dict[str, Any] = {}

        def walk(d: dict) -> None:
            for k, v in d.items():
                if k == "learner_model_param":
                    continue  # model state, not configuration
                if isinstance(v, dict):
                    walk(v)
                elif k != "name" and isinstance(v, (str, int, float, bool)):
                    if k in known:
                        collected[k] = v

        walk(learner)
        metrics = learner.get("metrics") or []
        names = [m["name"] if isinstance(m, dict) else str(m)
                 for m in metrics]
        if names:
            collected["eval_metric"] = names
        else:
            collected.pop("eval_metric", None)
        booster_name = learner.get("gradient_booster", {}).get("name")
        if booster_name:
            collected["booster"] = booster_name
        if collected:
            self.set_param(collected)

    def serialize(self) -> bytearray:
        """Model and training configuration in one UBJSON buffer,
        ``{"Model": ..., "Config": ...}`` (reference core.py:2441,
        learner.cc:987 Save)."""
        import io

        from .utils.ubjson import dump_ubjson

        buf = io.BytesIO()
        dump_ubjson({"Model": self.save_raw_dict(),
                     "Config": self._config_dict()}, buf)
        return bytearray(buf.getvalue())

    def unserialize(self, buf: Union[bytes, bytearray]) -> None:
        """Restore a ``serialize()`` buffer, this package's or the
        reference's (learner.cc:1003 Load).  The configuration applies
        first: the model's output groups may depend on it (a list of
        ``quantile_alpha``)."""
        import io

        from .utils.ubjson import load_ubjson

        try:
            snap = json.loads(buf)
        except (UnicodeDecodeError, json.JSONDecodeError):
            snap = load_ubjson(io.BytesIO(bytes(buf)))
        self.load_config(snap["Config"])
        self.load_model_dict(snap["Model"])

    def __getstate__(self) -> dict:
        """A pickle holds the ``serialize()`` bytes and the device's name:
        no tensor and no cache."""
        return {"raw": bytes(self.serialize()), "device": str(self.device)}

    def __setstate__(self, state: dict) -> None:
        try:
            device = resolve_device(state["device"])
        except RuntimeError as e:
            raise RuntimeError(
                f"this Booster was pickled on {state['device']} and no CUDA "
                "device is available here; restore its bytes on the CPU "
                "with xgboost_tpu_torch.Booster(device=\"cpu\")"
                ".unserialize(bst.serialize())") from e
        self.__init__(device=device)
        self.unserialize(state["raw"])
        best = self.attr("best_iteration")
        if best is not None:  # early stopping's bests, as the attributes
            self.best_iteration = int(best)
            score = self.attr("best_score")
            self.best_score = None if score is None else float(score)
