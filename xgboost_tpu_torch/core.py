"""Booster: the trained model + training-step engine (port of
xgboost_tpu/core.py: gbtree, DART and gblinear; the hist, approx and exact
tree methods; process_type="update").

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

The other boosters and updaters (reference core.py:206-255):
- ``booster="dart"`` (gbtree.cc Dart): before a round's trees, a random
  set of earlier trees is dropped (``_select_dart_drops``, numpy draws on
  the host); the gradient is taken once, on the margin without them
  (their margin through the predict traversal on the booster's device),
  and afterwards the new and the dropped trees are rescaled
  (``_dart_commit``).  Each tree carries a weight (``tree_weights``),
  applied to its leaf values where the trees are stacked for prediction.
- ``tree_method="approx"`` (updater_approx.cc): every round the
  hessians are copied to the host once, the host sketches the rows
  weighted by them (numpy, as the reference's), and the card bins the
  matrix against those cuts (``data/ellpack.py``); the round's trees grow
  on those bins with K1 or K2 and K3, as on the hist path.
- ``tree_method="exact"`` (tree/exact.py, host numpy as XGBoost's CPU-only
  colmaker): the gradients come to the host once a parallel tree, the
  tree is enumerated and pruned there and its leaves go back as the
  margin's delta.  No sketch, no binned page, no grower.
- ``process_type="update"`` with ``updater`` among refresh, prune, sync
  (models/updaters.py, host numpy): round i's gradients, taken on the
  device from the margin of the rounds before it as already updated,
  come to the host once; the round's trees are refreshed and pruned
  there.
- ``booster="gblinear"`` (models/gblinear.py): the coordinate chain in
  PyTorch operations on the device, the selectors' orders from the host.

Across ranks (reference core.py:930-936 ``_process_parallel``): when the
collective (collective.py) spans several ranks, each holding a row shard,
the training matrix's cuts come from every shard's host sketch
(``sketch_distributed``), the base score from the gathered labels, each
tree from ``ProcessHistTreeGrower`` (parallel/process.py), or the
best-first and vector-leaf growers with ``distributed=True``, which sum
the root and each level's histogram over the ranks; approx sketches the
round's hessians over the ranks, the adaptive refit gathers the leaves'
rows, and ``eval_set`` reports the global metrics.  Out of core, each
rank's pages stream through the streaming grower with
``distributed=True``, which sums each level's page histograms over the
ranks once.  exact gathers every rank's rows and gradients, so every rank
enumerates the whole set, and takes rank 0's tree; process_type="update"
sums each node's refreshed (G, H) over the ranks, and ``sync`` gives every
rank rank 0's model.  gblinear raises there (ROADMAP Queue 3 item 8): it
may not train a rank's rows alone.

Out of core (reference core.py:680-837): on an ExtMemQuantileDMatrix the
trees grow on StreamingHistTreeGrower (tree/stream.py), which streams the
host pages to the device at every level; the training state (margins,
gradients, row positions) lives on the device over the page-padded rows.
Prediction on the pages routes rows by the trees' split bins
(``_predict_extmem``); a SparsePageDMatrix's raw pages take the raw
traversal a page at a time.  As the reference, pages refuse exact, DART,
gblinear, process_type="update" and the per-feature outputs of predict.
"""
from __future__ import annotations

import copy
import inspect
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import collective
from .data.dmatrix import DMatrix, categories_by_name, recode_dense
from .data.ellpack import build_ellpack
from .data.quantile import sketch_distributed
from .metric import create_metric, distributed_reduction
from .models import gblinear
from .models.tree import RegTree
from .models.updaters import _route_masks, prune_tree, refresh_tree, sync_trees
from .objective import ObjFunction, create_objective
from .ops.adaptive import segment_quantile_leaf
from .ops.predict import (predict_leaf_ids, predict_margin_delta,
                          predict_margin_delta_binned,
                          predict_margin_delta_multi)
from .ops.split import SplitParams
from .parallel.process import ProcessHistTreeGrower
from .params import (KNOWN_LEARNER_KEYS, TrainParam, canonicalize,
                     reject_unsupported, split_unknown, tree_keys)
from .tree.bestfirst import BestFirstGrower
from .tree.exact import grow_exact
from .tree.grow import HistTreeGrower, leaf_margin_delta
from .tree.grow_lockstep import LockstepHistGrower, leaf_margin_delta_k
from .tree.grow_multi import MultiTargetTreeGrower, leaf_margin_delta_multi
from .tree.stream import StreamingHistTreeGrower
from .utils.device import resolve_device
from .utils.fp import sqrt_f32, sum_f32
from .utils.random import bernoulli, prng_key, uniform

__all__ = ["Booster"]


def _gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` in rank order, on ``t``'s device."""
    return torch.from_numpy(collective.allgather_ragged(
        t.cpu().numpy())).to(t.device)


class _Cache:
    """Per-DMatrix state on the booster's device: the margin cache, and for
    a training matrix the binned page with padded labels/weights/valid.
    For an external-memory matrix the rows are its page-padded rows and
    the pages stay on the host."""

    def __init__(self, dmat: DMatrix, device: torch.device):
        self.dmat = dmat
        self.device = device
        self.ellpack = None
        self.ready = False  # labels, weights and valid are on the device
        self.margin: Optional[torch.Tensor] = None  # (rows, K) f32
        self.n_trees_applied = 0
        self.weights_version = 0  # the booster's tree-weight epoch here
        self.raw_X: Optional[torch.Tensor] = None  # the matrix on device
        self.host_X: Optional[np.ndarray] = None
        self.linear_XT: Optional[torch.Tensor] = None  # gblinear (F, R)

    @property
    def is_extmem(self) -> bool:
        return hasattr(self.dmat, "_pages")

    def ensure_train(self, max_bin: int, distributed: bool = False) -> None:
        if self.is_extmem:
            if not self.ready:
                self._stage_extmem()
            return
        if self.ellpack is not None:
            return
        ell = self.dmat.ensure_ellpack(max_bin=max_bin,
                                       distributed=distributed)
        self.ellpack = ell
        self.bins = ell.bins.to(self.device)
        self.cuts_pad = ell.cuts_pad.to(self.device)
        self.cuts_host = ell.cuts_pad.cpu().numpy()
        self.n_bins = ell.n_bins.to(self.device)
        self._stage(ell.n_padded, ell.n_rows)

    def ensure_train_raw(self) -> None:
        """Labels, weights and valid rows without a sketch or a binned
        page, unpadded (reference core.py:64-78): exact, gblinear and
        process_type="update" read the raw matrix alone."""
        if not self.ready:
            R = self.dmat.num_row()
            self._stage(R, R)

    def _stage_extmem(self) -> None:
        """Valid rows, labels and weights in the pages' padded layout
        (reference core.py:84-100), and the cuts, on the device."""
        d, dev = self.dmat, self.device
        R_pad = d.n_padded_total
        self.n_padded, self.n_real = R_pad, d.num_row()
        self.valid = torch.from_numpy(d.valid_mask()).to(dev)
        lab = d.padded_labels()
        self.labels = torch.from_numpy(
            lab if lab is not None else np.zeros(R_pad, np.float32)).to(dev)
        w = d.padded_weights()
        self.weights = None if w is None else torch.from_numpy(w).to(dev)
        self.cuts_pad = d.cuts_pad.to(dev)
        self.cuts_host = d.cuts_pad.numpy()
        self.n_bins = d.n_bins.to(dev)
        if self.margin is not None and self.margin.shape[0] != R_pad:
            extra = torch.zeros((R_pad - self.margin.shape[0],
                                 self.margin.shape[1]), device=dev)
            self.margin = torch.cat([self.margin, extra])
        self.ready = True

    def _stage(self, R_pad: int, R: int) -> None:
        dev = self.device
        self.n_padded, self.n_real = R_pad, R
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
        self.ready = True

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
                out = torch.ones(self.n_rows(), dtype=torch.float32,
                                 device=self.device)
                out[: a.shape[0]] = torch.from_numpy(
                    np.asarray(a, np.float32)).to(self.device)
                return out

            self._bounds = (padded(lo), padded(hi))
            self._bounds_key = key
        return self._bounds

    def n_rows(self) -> int:
        return self.n_padded if self.ready else self.dmat.num_row()

    def base_margin_init(self, base_score: np.ndarray, K: int) -> torch.Tensor:
        R_pad = self.n_rows()
        out = torch.empty((R_pad, K), dtype=torch.float32, device=self.device)
        out[:] = torch.tensor(np.asarray(base_score, np.float32))
        user = self.dmat.base_margin
        if user is not None and self.is_extmem:
            # the pages' layout, zero on the padding rows (reference
            # core.py:142-147)
            m = self.dmat.padded_base_margin().reshape(R_pad, -1)
            out[:] = torch.from_numpy(np.ascontiguousarray(m))
        elif user is not None:
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
        # DART's weight of each tree (gbtree.cc weight_drop_), 1.0 elsewhere
        self.tree_weights: List[float] = []
        # gblinear's (F, K) weights and (K,) bias, and its rounds
        self.linear_weights: Optional[np.ndarray] = None
        self.linear_bias: Optional[np.ndarray] = None
        self._linear_rounds = 0
        # bumped whenever committed trees change (a DART rescale, an
        # update pass): every cached margin then rebuilds from scratch
        self._weights_version = 0
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
        # (reference core.py:206-255)
        self.booster_kind = str(p.get("booster", "gbtree"))
        if self.booster_kind not in ("gbtree", "dart", "gblinear"):
            raise ValueError(f"unknown booster {self.booster_kind}")
        self.tree_method = str(p.get("tree_method", "hist"))
        if self.tree_method in ("auto", "gpu_hist"):
            self.tree_method = "hist"
        if self.tree_method not in ("hist", "approx", "exact"):
            raise ValueError(f"unknown tree_method {self.tree_method!r}")
        # process_type=update re-processes an existing model's trees with
        # the non-growing updaters (gbtree.cc InitUpdater)
        self.process_type = str(p.get("process_type", "default"))
        if self.process_type not in ("default", "update"):
            raise ValueError(f"unknown process_type {self.process_type!r}")
        upd = p.get("updater")
        self.updater_seq = ([u.strip() for u in str(upd).split(",")
                             if u.strip()] if upd else None)
        self.refresh_leaf = bool(self.tparam.refresh_leaf)
        # DART (gbtree.cc Dart)
        self.rate_drop = float(p.get("rate_drop", 0.0))
        self.skip_drop = float(p.get("skip_drop", 0.0))
        self.one_drop = str(p.get("one_drop", "0")).lower() in ("1", "true")
        self.sample_type = str(p.get("sample_type", "uniform"))
        self.normalize_type = str(p.get("normalize_type", "tree"))
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
        # the adaptive leaf refit after each tree (reg:absoluteerror,
        # reg:quantileerror; reference core.py:1565-1605)
        self._adaptive = self.objective.adaptive_leaf()
        self._lockstep = False
        self._grower = self._lockstep_grower = self._multi_grower = None
        self._stream_growers: Dict[tuple, StreamingHistTreeGrower] = {}
        # rows sharded over ranks (reference core.py:930 _process_parallel)
        self._distributed = collective.is_distributed()
        dist = self._distributed
        if self.booster_kind == "gblinear" or self.tree_method == "exact":
            # neither grows on histograms
            self._configured = True
            return
        if self._best_first and self.deterministic_histogram:
            # refused where an in-memory matrix would grow best-first (the
            # streaming grower takes lossguide level by level)
            self._grower = None
        elif self._best_first:
            # depth bounded by the leaf budget alone when max_depth <= 0
            self._grower = BestFirstGrower(
                max(tp.max_depth, 0), self._split_params,
                max_leaves=tp.max_leaves,
                interaction_sets=tp.interaction_constraints,
                distributed=dist)
        elif dist:
            self._grower = ProcessHistTreeGrower(
                self._resolve_max_depth(lossguide), self._split_params,
                interaction_sets=tp.interaction_constraints,
                max_leaves=tp.max_leaves,
                quantised=self.deterministic_histogram)
        else:
            self._grower = HistTreeGrower(
                self._resolve_max_depth(lossguide), self._split_params,
                interaction_sets=tp.interaction_constraints,
                max_leaves=tp.max_leaves,
                quantised=self.deterministic_histogram)
        # the reference's opt-in class-batched grower (core.py:1510-1516):
        # the K class trees of a round in one level loop, numeric f32
        # histograms only; _boost_trees checks the rest of its gate
        self._lockstep = (
            not self._best_first and not self.deterministic_histogram
            and not dist
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
            distributed=dist,
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
            if not self.trees and self.linear_weights is None:
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
            elif not self.trees and cache.ready:
                v = cache.valid
                lab = cache.labels[v]
                wts = None if cache.weights is None else cache.weights[v]
                if self._distributed:
                    # every rank estimates on the global labels (the
                    # reference allreduces inside FitStump, fit_stump.cc:52)
                    lab = _gather_rows(lab)
                    wts = None if wts is None else _gather_rows(wts)
                bm = self.objective.init_estimation(lab, wts)
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
        """Catch the cached margin up with all committed trees (reference
        core.py:351-419): gblinear's margin anew after each round, and a
        margin from before a DART rescale or an update pass from
        scratch."""
        if cache.is_extmem:
            cache.ensure_train(self.tparam.max_bin)
        self._ensure_base_margin(cache)
        if self.booster_kind == "gblinear":
            rounds = self._linear_rounds
            if self.linear_weights is None or \
                    cache.n_trees_applied == rounds > 0:
                return
            cache.margin = self._linear_margin(cache)
            cache.n_trees_applied = rounds
            return
        if cache.weights_version != self._weights_version:
            cache.margin = cache.base_margin_init(self._base_margin_value,
                                                  self.n_groups)
            cache.n_trees_applied = 0
            cache.weights_version = self._weights_version
        if cache.n_trees_applied < len(self.trees) and cache.is_extmem:
            new = slice(cache.n_trees_applied, len(self.trees))
            # the page-padded delta, added as the reference adds it
            cache.margin = cache.margin + self._predict_extmem(cache.dmat,
                                                               new)
            cache.n_trees_applied = len(self.trees)
        elif cache.n_trees_applied < len(self.trees):
            new = slice(cache.n_trees_applied, len(self.trees))
            X = self._device_X(cache.dmat)
            R = X.shape[0]
            m = self._margin_delta_for(X, new, init=cache.margin[:R])
            cache.margin = torch.cat([m, cache.margin[R:]])
            cache.n_trees_applied = len(self.trees)

    # ------------------------------------------------------------------ train
    def _train_cache(self, dtrain: DMatrix) -> _Cache:
        self._configure()
        if self._distributed != collective.is_distributed():
            # the collective changed since the growers were made
            self._configured = False
            self._configure()
        if self._distributed:
            self._check_distributed_training(dtrain)
        cache = self._get_cache(dtrain)
        if cache.is_extmem:
            self._check_extmem_training()
            cache.ensure_train(self.tparam.max_bin)
        elif (self.tree_method == "exact" or self.booster_kind == "gblinear"
                or self.process_type == "update"):
            cache.ensure_train_raw()
        else:
            cache.ensure_train(self.tparam.max_bin, self._distributed)
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
        return cache

    def _check_distributed_training(self, dtrain: DMatrix) -> None:
        """Refuse gblinear across ranks: the reference's coordinate
        descent reduces nothing across ranks, so a rank would train its
        rows alone (ROADMAP Queue 3 item 8).  exact, process_type="update"
        and out-of-core matrices train across ranks (item 9b.1); what
        Queue 1 item 9 leaves (the tracker, elastic membership, federated
        and n_devices > 1) is refused where it is asked for."""
        if self.booster_kind == "gblinear":
            raise NotImplementedError(
                "booster='gblinear' across ranks is not ported to "
                "xgboost_tpu_torch: the reference reduces nothing across "
                "ranks there (ROADMAP Queue 3 item 8; Queue 1 item 9 ports "
                "the tree paths)")

    def _check_extmem_training(self) -> None:
        """Refuse what the pages cannot train, as the reference does:
        gblinear and process_type="update" read the raw matrix (reference
        core.py:586, :1191: host_dense raises).  The ranking objectives'
        query groups are not carried by pages: the reference takes the
        page padding into its one group, so the port refuses them."""
        if self.booster_kind == "gblinear" or self.process_type == "update":
            raise NotImplementedError(
                "ExtMemQuantileDMatrix does not materialize raw data; "
                "booster='gblinear' and process_type='update' need an "
                "in-memory DMatrix")
        if hasattr(self.objective, "set_group_info"):
            raise NotImplementedError(
                "ranking objectives need query groups, which "
                "ExtMemQuantileDMatrix pages do not carry; use an "
                "in-memory DMatrix")

    def update(self, dtrain: DMatrix, iteration: int, fobj=None) -> None:
        """One boosting iteration (learner.cc:1108 UpdateOneIter).  ``fobj``:
        a custom objective, called as ``fobj(margin, dtrain) -> (grad,
        hess)`` on the raw margins of the rows, (R,) or (R, K); on a DART
        round that drops trees, once, on the margin without them."""
        cache = self._train_cache(dtrain)
        bounds = cache.bounds()
        if bounds is not None and hasattr(self.objective, "set_bounds"):
            # before each gradient (reference core.py:452-456)
            self.objective.set_bounds(*bounds)
        if self.process_type == "update":
            # the update flow keeps its own margin of the rounds already
            # updated (reference core.py:489-499)
            if fobj is not None:
                raise NotImplementedError(
                    "process_type='update' with a custom objective is not "
                    "supported (refresh recomputes gradients internally)")
            self._ensure_base_margin(cache)
            self._update_existing_trees(cache, iteration)
            return
        self._sync_margin(cache)
        drop_idx = self._select_dart_drops(iteration)
        if drop_idx:
            # the gradient of a drop round is taken on the margin without
            # the dropped trees, in _boost_trees
            gpair = None
        elif fobj is not None:
            gpair = self._fobj_gpair(cache, fobj, cache.margin, dtrain)
        else:
            gpair = self.objective.get_gradient(cache.margin, cache.labels,
                                                cache.weights, iteration)
        if gpair is not None:
            gpair = gpair * cache.valid[:, None, None]  # (R_pad, K, 2)
        if self.booster_kind == "gblinear":
            self._boost_linear(cache, gpair)
        else:
            self._boost_trees(cache, gpair, iteration, fobj=fobj,
                              drop_idx=drop_idx)

    def _fobj_gpair(self, cache: _Cache, fobj, margin, dmat: DMatrix):
        """A custom objective's gradient pairs on the rows' raw margins."""
        m = margin[cache.valid].cpu().numpy()
        grad, hess = fobj(m[:, 0] if self.n_groups == 1 else m, dmat)
        return self._dense_gpair(cache, grad, hess)

    def boost(self, dtrain: DMatrix, grad, hess, iteration: int = 0) -> None:
        """One iteration from the caller's gradient pairs, (R,) or (R, K)
        each (reference: XGBoosterBoostOneIter, core.py:551)."""
        self._configure()
        if self.process_type == "update":
            raise NotImplementedError(
                "boost() with raw grad/hess cannot drive process_type="
                "'update' (the refresh updater recomputes gradients per "
                "round); use update() instead")
        if self._select_dart_drops(iteration):
            raise NotImplementedError(
                "boost() with raw grad/hess cannot honour a DART dropout "
                "round; use update(fobj=...) or set rate_drop=0")
        cache = self._train_cache(dtrain)
        self._sync_margin(cache)
        gpair = self._dense_gpair(cache, grad, hess) * \
            cache.valid[:, None, None]
        if self.booster_kind == "gblinear":
            self._boost_linear(cache, gpair)
        else:
            self._boost_trees(cache, gpair, iteration)

    def _dense_gpair(self, cache: _Cache, grad, hess) -> torch.Tensor:
        """Host gradient pairs of the rows -> (R_pad, K, 2) f32 on the
        device, zero on the padding rows (reference core.py:536)."""
        R = cache.n_real
        g = np.asarray(grad, np.float32).reshape(R, -1)
        h = np.asarray(hess, np.float32).reshape(R, -1)
        out = torch.zeros((cache.n_rows(), g.shape[1], 2),
                          dtype=torch.float32, device=self.device)
        # the valid rows: the first R, or the pages' rows out of core
        out[cache.valid] = torch.from_numpy(np.stack([g, h], axis=-1)).to(
            self.device)
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
                       feature_weights=None, host: bool = False):
        """ColumnSampler (reference: src/common/random.h ColumnSampler):
        each level samples exactly max(1, frac * n_avail) of the surviving
        features without replacement, by the k smallest exponential keys
        per row, divided by ``feature_weights`` where given (the weighted
        draw, Efraimidis-Spirakis).  The draws are numpy on the host, in
        the reference's order, so they agree with it bitwise.  None when
        nothing is sampled.  ``host``: the masks as numpy (the exact
        grower's), else tensors on the booster's device."""
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
            m = np.atleast_2d(m)
            return m if host else torch.from_numpy(m).to(self.device)

        return per_level

    def _boost_trees(self, cache: _Cache, gpair, iteration: int, fobj=None,
                     drop_idx=()) -> None:
        """Grow one round's trees (reference core.py:1307-1618, the
        sequential branch): for each parallel tree p its column sampler
        and row sample, seeded by ``iteration * 131 + p`` and shared by the
        K class trees, which grow in class order on their own column of
        the gradient pairs; tree k adds its leaves into margin column k.
        ``gpair`` is None on a DART round that drops ``drop_idx``: the
        gradient is taken here, on the margin without them."""
        if cache.is_extmem:
            # (reference core.py:1313-1326)
            if self.tree_method == "exact":
                raise NotImplementedError(
                    "tree_method='exact' needs raw in-memory values; it is "
                    "not supported with ExtMemQuantileDMatrix")
            if self.booster_kind == "dart":
                raise ValueError("booster='dart' is not supported with "
                                 "ExtMemQuantileDMatrix yet")
            self._boost_trees_extmem(cache, gpair, iteration)
            return
        if self._best_first and self.deterministic_histogram:
            raise NotImplementedError(
                "deterministic_histogram is not supported with the "
                "best-first (lossguide + max_leaves) grower yet")
        if self.tree_method == "exact":
            # raw host values: no sketch, no binned page, no grower
            if self.deterministic_histogram:
                raise NotImplementedError(
                    "deterministic_histogram applies to histogram growers; "
                    "tree_method='exact' has no histogram")
            if self.tparam.max_depth <= 0 and self.tparam.max_leaves <= 0:
                raise ValueError(
                    "tree_method='exact' with max_depth=0 needs a positive "
                    "max_leaves to bound the tree")
            self._boost_trees_exact_loop(cache, gpair, iteration, fobj,
                                         drop_idx)
            return
        mono = self.tparam.monotone_constraints
        n_features = cache.bins.shape[1]
        if mono is not None and len(mono) != n_features:
            raise ValueError(
                f"monotone_constraints has {len(mono)} entries but data has "
                f"{n_features} features")
        drop_margin = start = None
        if drop_idx:
            gpair, drop_margin = self._dart_gpair(cache, drop_idx, fobj,
                                                  iteration)
            # the round's trees add into cache.margin in place; the commit
            # needs the margin they started from
            start = cache.margin.clone()
        K = gpair.shape[1]
        cat_mask = cache.dmat.cat_mask()
        if self.multi_strategy == "multi_output_tree" and K > 1:
            if self.tree_method == "approx":
                raise NotImplementedError(
                    f"tree_method={self.tree_method!r} with "
                    "multi_output_tree is not supported yet")
            self._boost_multi_target(cache, gpair, iteration, cat_mask)
            return
        bins, cuts_pad, n_bins, cuts_host = (cache.bins, cache.cuts_pad,
                                             cache.n_bins, cache.cuts_host)
        if self.tree_method == "approx":
            bins, cuts_pad, n_bins, cuts_host = self._approx_page(cache,
                                                                  gpair)
        # the reference's lockstep gate (core.py:1510-1516, :1522); where
        # it does not hold, the sequential loop is the reference's own
        # semantics, not a fallback of the device
        lockstep = self._lockstep and K > 1 and cat_mask is None
        n_new = 0
        for p in range(self.num_parallel_tree):
            fmask_fn = self._feature_masks(iteration * 131 + p, p,
                                           n_features,
                                           cache.dmat.feature_weights)
            gp = self._subsample_mask(gpair, iteration * 131 + p)
            if lockstep and fmask_fn is None:
                lk = self._lockstep_grower
                state = lk.grow(bins, gp.contiguous(), cache.valid, cuts_pad,
                                n_bins)
                cache.margin += leaf_margin_delta_k(state.pos,
                                                    state.leaf_val).T
                for k in range(K):
                    self._append_tree(RegTree.from_grown(
                        lk.to_host_class(state, k)), k)
                n_new += K
                continue
            for k in range(K):
                state = self._grower.grow(
                    bins, gp[:, k, :].contiguous(), cache.valid, cuts_pad,
                    n_bins, feature_masks=fmask_fn, cat_mask=cat_mask)
                tree = None
                if self._best_first:
                    tree, leaf_val = self._grower.to_regtree(state,
                                                             cuts_host)
                else:
                    leaf_val = state.leaf_val
                if self._adaptive:
                    leaf_val = self._refit_leaves(cache, state, tree, k)
                    if not self._best_first:
                        state.leaf_val = leaf_val
                if tree is None:
                    tree = RegTree.from_grown(HistTreeGrower.to_host(state))
                cache.margin[:, k] += leaf_margin_delta(state.pos, leaf_val)
                self._append_tree(tree, k)
                n_new += 1
        if drop_idx:
            cache.margin = self._dart_commit(cache, start, n_new, drop_idx,
                                             drop_margin)
        cache.n_trees_applied = len(self.trees)

    def _stream_grower(self) -> StreamingHistTreeGrower:
        """The streaming grower of the current parameters (reference
        core.py:695-715): ``_extmem_prefetch`` 0 puts page copies and
        compute in series; ``_extmem_page_skip`` 0 keeps sampled-out pages
        in every level pass.  Across ranks it sums each level over them
        (the growers are made anew when the collective changes)."""
        tp = self.tparam
        lossguide = tp.grow_policy == "lossguide"

        def on(key):
            return str(self.params.get(key, "1")).lower() in ("1", "true")

        prefetch = None if on("_extmem_prefetch") else 0
        page_skip = (tp.subsample < 1.0
                     and tp.sampling_method == "gradient_based"
                     and on("_extmem_page_skip"))
        key = (prefetch, page_skip)
        if key not in self._stream_growers:
            self._stream_growers[key] = StreamingHistTreeGrower(
                self._resolve_max_depth(lossguide), self._split_params,
                interaction_sets=tp.interaction_constraints,
                max_leaves=tp.max_leaves, lossguide=lossguide,
                quantised=self.deterministic_histogram, prefetch=prefetch,
                page_skip=page_skip, distributed=self._distributed)
        return self._stream_growers[key]

    def _boost_trees_extmem(self, cache: _Cache, gpair,
                            iteration: int) -> None:
        """A round over the pages (reference core.py:680-739): for each
        parallel tree its column sampler and row sample, for each output
        group a tree from the streaming grower, its leaves added to the
        margin.  As the reference, the trees are scalar (multi_strategy
        and _lockstep are not read) and adaptive objectives keep the
        grower's leaves."""
        d = cache.dmat
        mono = self.tparam.monotone_constraints
        if mono is not None and len(mono) != d.num_col():
            raise ValueError(
                f"monotone_constraints has {len(mono)} entries but data has "
                f"{d.num_col()} features")
        grower = self._stream_grower()
        cat_mask = d.cat_mask()
        for p in range(self.num_parallel_tree):
            fmask_fn = self._feature_masks(iteration * 131 + p, p,
                                           d.num_col(), d.feature_weights)
            gp = self._subsample_mask(gpair, iteration * 131 + p)
            for k in range(gpair.shape[1]):
                state = grower.grow(d, gp[:, k, :].contiguous(), cache.valid,
                                    cache.cuts_pad, cache.n_bins,
                                    feature_masks=fmask_fn,
                                    cat_mask=cat_mask)
                cache.margin[:, k] += leaf_margin_delta(state.pos,
                                                        state.leaf_val)
                tree = RegTree.from_grown(HistTreeGrower.to_host(state))
                tree.cuts_token = d._cuts.token
                self._append_tree(tree, k)
        cache.n_trees_applied = len(self.trees)

    def _predict_extmem(self, data, tree_slice: slice) -> torch.Tensor:
        """The trees' margin over an external-memory matrix's pages,
        (R_pad, K) on the booster's device in the pages' padded layout
        (reference core.py:760): each page streamed to the device and its
        rows routed by the trees' split bins."""
        from .data.extmem import prefetch_lookahead

        self._ensure_split_bins(tree_slice, data._cuts)
        s, groups, depth = self._stacked(tree_slice)
        n_bin = data.cuts_pad.shape[1]
        offs = data.page_offsets()
        out = torch.empty((offs[-1], self.n_groups), dtype=torch.float32,
                          device=self.device)
        sched = data.scheduler(data._pages, self.device, prefetch_lookahead())
        try:
            for j in range(len(data._pages)):
                bins = sched.get(j)
                out[offs[j]: offs[j + 1]] = predict_margin_delta_binned(
                    bins, s["feat"], s["sbin"], s["dleft"], s["left"],
                    s["right"], s["value"], groups, None, s.get("is_cat"),
                    s.get("catm"), n_groups=self.n_groups, depth=depth,
                    n_bin=n_bin)
                sched.release(j)
        finally:
            sched.close()
        return out

    def _ensure_split_bins(self, tree_slice: slice, cuts) -> None:
        """Split bins for trees that lack them or index other cuts (a
        loaded model, or one trained on another matrix; reference
        core.py:800): a threshold is a cut, cuts[f][sbin], so its bin is an
        exact search of the matrix's cuts."""
        for t in self.trees[tree_slice]:
            if t.split_bins is not None and t.cuts_token == cuts.token:
                continue
            sbin = np.zeros(t.n_nodes, np.int32)
            for nid in range(t.n_nodes):
                if t.left_children[nid] == -1:
                    continue
                if t.split_type is not None and t.split_type[nid] == 1:
                    continue  # a categorical split routes by its set
                seg = cuts.feature_cuts(int(t.split_indices[nid]))
                b = int(np.searchsorted(seg, t.split_conditions[nid],
                                        side="left"))
                if b >= len(seg) or seg[b] != t.split_conditions[nid]:
                    raise ValueError(
                        "cannot map split threshold onto this matrix's bin "
                        "cuts; was the model trained with different cuts, "
                        "or with tree_method='exact' (raw-value "
                        "thresholds)? Use an in-memory DMatrix for "
                        "prediction.")
                sbin[nid] = b
            t.split_bins = sbin
            t.cuts_token = cuts.token

    def _append_tree(self, tree: RegTree, group: int) -> None:
        self.trees.append(tree)
        self.tree_info.append(group)
        self.tree_weights.append(1.0)

    def _approx_page(self, cache: _Cache, gpair):
        """tree_method="approx" (reference core.py:1456-1497, grow_histmaker
        of updater_approx.cc): the round's hessians summed over the output
        groups, copied to the host once, weight the rows of a fresh host
        sketch (numpy, the reference's bits), and the device bins the
        matrix against those cuts.  The cut width stays ``max_bin``.
        Returns the round's (bins, cuts_pad, n_bins, host cuts)."""
        max_bin = self.tparam.max_bin
        hess = gpair[..., 1].cpu().numpy()  # (R_pad, K)
        hess_w = hess.sum(axis=1)[: cache.n_real]
        # each column's sort is the matrix's, found once (a training
        # frame's codes are the booster's: no recoding)
        if self._distributed:
            # one merge of every rank's weighted grid (reference
            # core.py:1467-1472, quantile.cc AllreduceV)
            cuts = sketch_distributed(self._host_X(cache), max_bin,
                                      weights=hess_w.astype(np.float64),
                                      cat_mask=cache.dmat.cat_mask())
        else:
            cuts = cache.dmat.weighted_sketch().cuts(
                max_bin, hess_w.astype(np.float64))
        page = build_ellpack(self._cache_X(cache), cuts)
        if page.n_padded != cache.bins.shape[0]:
            raise AssertionError("approx page padding mismatch")
        cuts_host = cuts.padded(max_bin)
        return (page.bins, torch.from_numpy(cuts_host).to(self.device),
                torch.from_numpy(cuts.n_bins_array()).to(self.device),
                cuts_host)

    def _boost_trees_exact_loop(self, cache: _Cache, gpair, iteration: int,
                                fobj, drop_idx) -> None:
        """A tree_method="exact" round (reference core.py:953-987): the
        host enumerator, with the DART, forest, column and row sampling
        machinery of the hist path."""
        drop_margin = start = None
        if drop_idx:
            gpair, drop_margin = self._dart_gpair(cache, drop_idx, fobj,
                                                  iteration)
            start = cache.margin.clone()
        K = gpair.shape[1]
        if self.multi_strategy == "multi_output_tree" and K > 1:
            raise NotImplementedError(
                "tree_method='exact' with multi_output_tree is not "
                "supported yet")
        n_new = 0
        n_features = cache.dmat.num_col()
        for p in range(self.num_parallel_tree):
            fmask_fn = self._feature_masks(iteration * 131 + p, p,
                                           n_features,
                                           cache.dmat.feature_weights,
                                           host=True)
            gp = self._subsample_mask(gpair, iteration * 131 + p)
            # the parallel tree's gradients to the host, once (every
            # rank's, in rank order)
            gp_host = self._gather_host(gp[: cache.n_real].cpu().numpy())
            for k in range(K):
                tree, delta = self._grow_exact_one(cache, gp_host, k,
                                                   fmask_fn)
                cache.margin[:, k] += torch.from_numpy(delta).to(self.device)
                self._append_tree(tree, k)
                n_new += 1
        if drop_idx:
            cache.margin = self._dart_commit(cache, start, n_new, drop_idx,
                                             drop_margin)
        cache.n_trees_applied = len(self.trees)

    def _gather_host(self, a: np.ndarray) -> np.ndarray:
        """Every rank's rows of a host array in rank order (``a`` itself
        in one process)."""
        return collective.allgather_ragged(a) if self._distributed else a

    def _exact_rows(self, cache: _Cache):
        """exact's host matrix and its columns' sort, made once a cache
        (round-invariant, as the colmaker's SortedCSC); across ranks every
        rank's rows in rank order, so every rank enumerates the whole set
        (reference core.py:1018-1037, updater_sync.cc).  Returns (X, order,
        this rank's first row in X, its row count)."""
        if getattr(cache, "exact_X", None) is None:
            X = self._host_X(cache)
            cache.exact_n_local, cache.exact_row_start = X.shape[0], 0
            if self._distributed:
                sizes = collective.allgather(
                    np.asarray([X.shape[0]], np.int64))[:, 0]
                cache.exact_row_start = int(
                    sizes[: collective.get_rank()].sum())
                X = collective.allgather_ragged(X)
            cache.exact_X = X
            cache.exact_order = np.argsort(X, axis=0,
                                           kind="stable").astype(np.int32)
        return (cache.exact_X, cache.exact_order, cache.exact_row_start,
                cache.exact_n_local)

    def _grow_exact_one(self, cache: _Cache, gp_host: np.ndarray, k: int,
                        fmask_fn):
        """One exact tree (reference core.py:989-1119): the host
        enumeration over raw values (updater_colmaker.cc ColMaker) chained
        with the pruner, as the reference chains "grow_colmaker,prune";
        returns (RegTree, the margin's delta as host f32 over the cache's
        rows).  ``gp_host``: the gradients of every rank's rows.  Across
        ranks every rank grows the same tree from the same inputs and
        keeps rank 0's, broadcast (TreeSyncher)."""
        tp = self.tparam
        cat_mask = cache.dmat.cat_mask()
        if cat_mask is not None and np.any(cat_mask):
            raise NotImplementedError(
                "tree_method='exact' does not support categorical features "
                "(same as the reference updater)")
        if tp.monotone_constraints is not None or tp.interaction_constraints:
            raise NotImplementedError(
                "constraints are not supported with tree_method='exact'; "
                "use hist or approx")
        if tp.grow_policy == "lossguide":
            raise ValueError("tree_method='exact' only supports depthwise "
                             "growth (driver.h lossguide needs hist/approx)")
        X, order, row_start, R_local = self._exact_rows(cache)
        R = X.shape[0]
        gh = np.asarray(gp_host[:, k, :], np.float64)
        tree, pos = grow_exact(
            X, gh[:, 0], gh[:, 1],
            max_depth=int(tp.max_depth), max_leaves=int(tp.max_leaves),
            lambda_=float(tp.lambda_), alpha=float(tp.alpha),
            min_child_weight=float(tp.min_child_weight),
            max_delta_step=float(tp.max_delta_step),
            eta=float(tp.eta), feature_masks=fmask_fn,
            col_order=order)
        tree, n_pruned = prune_tree(tree, gamma=float(tp.gamma),
                                    eta=float(tp.eta))
        if n_pruned:
            # node ids changed: route the rows through the pruned tree
            masks = _route_masks(tree, X)
            pos = np.zeros(R, np.int32)
            for nid in np.nonzero(tree.left_children == -1)[0]:
                pos[masks[nid]] = nid
        if self._adaptive:
            # ObjFunction::UpdateTreeLeaf: each leaf the weighted
            # alpha-quantile of its rows' residuals against the running
            # margin, on the host as the reference's exact path does
            if getattr(cache, "exact_adaptive_meta", None) is None:
                cache.exact_adaptive_meta = (
                    self._gather_host(
                        cache.labels[:R_local].cpu().numpy()),
                    self._gather_host(cache.valid[:R_local].cpu().numpy()
                                      ).astype(bool),
                    (self._gather_host(cache.weights[:R_local].cpu().numpy())
                     if cache.weights is not None else None))
            labels, valid, w = cache.exact_adaptive_meta
            residual = labels - self._gather_host(
                cache.margin[:R_local, k].cpu().numpy())
            alpha_q = float(self.objective.adaptive_alpha(k))
            for nid in np.nonzero(tree.left_children == -1)[0]:
                m = (pos == nid) & valid
                if not np.any(m):
                    continue
                res = residual[m]
                if w is None:
                    q = np.quantile(res, alpha_q)
                else:
                    srt = np.argsort(res)
                    cw = np.cumsum(w[m][srt])
                    q = res[srt][np.searchsorted(cw, alpha_q * cw[-1])]
                tree.split_conditions[nid] = np.float32(float(tp.eta) * q)
        if self._distributed:
            # rank 0's tree, the same by construction, made certain
            # (reference core.py:1107-1115)
            tree = RegTree.from_json_dict(
                collective.broadcast(tree.to_json_dict(0, 0), 0))
        delta = np.zeros(cache.margin.shape[0], np.float32)
        delta[:R_local] = tree.split_conditions[pos][
            row_start: row_start + R_local]
        return tree, delta

    # ----------------------------------------------------------------- DART
    def _select_dart_drops(self, iteration: int) -> List[int]:
        """The round's dropped trees (reference core.py:1281-1305,
        gbtree.cc Dart::DropTrees): numpy draws, the same for a given
        iteration; empty when dropout does not fire."""
        if not (self.booster_kind == "dart" and self.trees
                and self.rate_drop > 0.0):
            return []
        rng = self._rng(iteration, 97)
        if rng.random() < self.skip_drop:
            return []
        n = len(self.trees)
        if self.sample_type == "weighted":
            wts = np.asarray(self.tree_weights, np.float64)
            prob = wts / max(wts.sum(), 1e-16)
            k_drop = int(rng.binomial(n, self.rate_drop))
            if k_drop == 0 and self.one_drop:
                k_drop = 1
            if k_drop == 0:
                return []
            return list(rng.choice(n, size=min(k_drop, n), replace=False,
                                   p=prob))
        mask = rng.random(n) < self.rate_drop
        drop_idx = list(np.nonzero(mask)[0])
        if not drop_idx and self.one_drop:
            drop_idx = [int(rng.integers(0, n))]
        return drop_idx

    def _dart_gpair(self, cache: _Cache, drop_idx, fobj, iteration: int):
        """A drop round's gradient pairs, on the margin without the dropped
        trees (reference core.py:1620-1647), and the dropped trees' margin;
        a custom objective is called here, once."""
        drop_margin = self._margin_for_trees(self._cache_X(cache), drop_idx)
        pad = cache.margin.shape[0] - drop_margin.shape[0]
        if pad:
            drop_margin = torch.cat([drop_margin, drop_margin.new_zeros(
                (pad, drop_margin.shape[1]))])
        reduced = cache.margin - drop_margin
        if fobj is not None:
            gpair = self._fobj_gpair(cache, fobj, reduced, cache.dmat)
        else:
            gpair = self.objective.get_gradient(reduced, cache.labels,
                                                cache.weights, iteration)
        return gpair * cache.valid[:, None, None], drop_margin

    def _dart_commit(self, cache: _Cache, start, n_new: int, drop_idx,
                     drop_margin):
        """The rescale after a drop round (reference core.py:1649-1676,
        Dart::NormalizeTrees): with k dropped and lr = eta, "tree" scales
        the new trees by 1/(k+lr) and the dropped by k/(k+lr), "forest"
        both by 1/(1+lr).  Returns the round's margin: the start margin
        less the dropped trees' lost share plus the new trees' scaled
        contribution, their f32 difference from the start, in the
        reference's order."""
        k_d = len(drop_idx)
        lr = float(self.tparam.eta)
        if self.normalize_type == "forest":
            new_w = 1.0 / (1.0 + lr)
            factor = 1.0 / (1.0 + lr)
        else:
            new_w = 1.0 / (k_d + lr)
            factor = k_d / (k_d + lr)
        for t in range(len(self.trees) - n_new, len(self.trees)):
            self.tree_weights[t] = new_w
        for t in drop_idx:
            self.tree_weights[t] *= factor
        new_contrib = cache.margin - start
        f32 = lambda v: torch.tensor(np.float32(v), device=start.device)  # noqa: E731
        out = start - f32(1.0 - factor) * drop_margin + f32(new_w) * \
            new_contrib
        self._weights_version += 1
        cache.weights_version = self._weights_version
        return out

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
        pos, residual, valid = (state.pos, cache.labels - cache.margin[:, k],
                                cache.valid)
        if self._distributed:
            # the quantile of the leaf's rows on every rank (reference
            # core.py:1579-1590)
            pos, residual, valid = (_gather_rows(t)
                                    for t in (pos, residual, valid))
        leaf_val = segment_quantile_leaf(
            pos, residual, valid, is_leaf,
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
        if self.booster_kind == "dart":
            raise NotImplementedError(
                "booster='dart' with multi_strategy='multi_output_tree' is "
                "not supported")
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
            self._append_tree(RegTree.from_grown_multi(
                MultiTargetTreeGrower.to_host(state)), 0)
        cache.n_trees_applied = len(self.trees)

    # ------------------------------------------------------------- gblinear
    def _linear_XT(self, cache: _Cache) -> torch.Tensor:
        """The zero-filled matrix transposed, (F, R) contiguous on the
        device, made once a cache: a coordinate reads one row."""
        if cache.linear_XT is None:
            cache.linear_XT = torch.nan_to_num(
                self._cache_X(cache), nan=0.0).T.contiguous()
        return cache.linear_XT

    def _linear_margin(self, cache: _Cache) -> torch.Tensor:
        """The linear model's margin over the cache's rows, padded as the
        cache is (reference core.py:586-600)."""
        XT = self._linear_XT(cache)
        dev = XT.device
        base = torch.from_numpy(self._base_margin_value).to(dev)[None, :]
        m = gblinear.linear_predict(
            XT, torch.from_numpy(self.linear_weights).to(dev),
            torch.from_numpy(self.linear_bias).to(dev)) + base
        rows = (cache.margin.shape[0] if cache.margin is not None
                else cache.n_rows())
        if rows > m.shape[0]:
            m = torch.cat([m, m.new_zeros((rows - m.shape[0], m.shape[1]))])
        return m

    def _boost_linear(self, cache: _Cache, gpair) -> None:
        """A gblinear round (reference core.py:602-668, gblinear.cc
        GBLinear::DoBoost): per output group, the bias step and the
        coordinate chain in the selector's order, on the device; the
        weights come back to the host once a round."""
        F = cache.dmat.num_col()
        K = gpair.shape[1]
        if self.linear_weights is None:
            self.linear_weights = np.zeros((F, K), np.float32)
            self.linear_bias = np.zeros(K, np.float32)
        updater = str(self.params.get("updater", "coord_descent"))
        if updater not in ("coord_descent", "shotgun"):
            raise ValueError(
                f"unknown gblinear updater {updater!r}; expected "
                "'coord_descent' or 'shotgun'")
        # coordinate_common.h: shotgun shuffles its order every round,
        # coord_descent walks the features cyclically
        selector = str(self.params.get(
            "feature_selector",
            "shuffle" if updater == "shotgun" else "cyclic"))
        if selector not in gblinear.SELECTORS:
            raise ValueError(
                f"unknown feature_selector {selector!r}; expected one of "
                f"{gblinear.SELECTORS}")
        top_k = int(self.params.get("top_k", 0) or 0)
        order = None
        if selector not in ("greedy", "thrifty"):
            order = gblinear.selector_order(
                selector, F, self._linear_rounds,
                int(self.params.get("seed", 0)))
        XT = self._linear_XT(cache)
        dev = XT.device
        W = torch.from_numpy(self.linear_weights).to(dev)
        b = torch.from_numpy(self.linear_bias).to(dev)
        R = cache.n_real
        eta, lam, alpha = (float(self.tparam.eta), float(self.tparam.lambda_),
                           float(self.tparam.alpha))
        for k in range(K):
            g, h = gpair[:R, k, 0], gpair[:R, k, 1]
            if selector == "greedy":
                wk, bk, _ = gblinear.linear_update_greedy(
                    XT, g, h, W[:, k], b[k],
                    steps=gblinear.effective_top_k(top_k, F), eta=eta,
                    lambda_=lam, alpha=alpha)
            else:
                if selector == "thrifty":
                    # ranked per group from the round's starting gradients
                    # (host f64, as the reference ranks them)
                    gh = gpair[:R, k, :].cpu().numpy()
                    order = gblinear.thrifty_order(
                        np.nan_to_num(self._host_X(cache), nan=0.0),
                        gh[:, 0], gh[:, 1], self.linear_weights[:, k],
                        top_k=top_k, alpha=alpha, lambda_=lam)
                wk, bk = gblinear.linear_update(
                    XT, g, h, W[:, k], b[k], order, eta=eta, lambda_=lam,
                    alpha=alpha)
            W[:, k] = wk
            b[k] = bk
        self.linear_weights = W.cpu().numpy()
        self.linear_bias = b.cpu().numpy()
        self._linear_rounds += 1
        cache.margin = self._linear_margin(cache)
        cache.n_trees_applied = self._linear_rounds

    # -------------------------------------------------- process_type=update
    def _update_existing_trees(self, cache: _Cache, iteration: int) -> None:
        """process_type="update" (reference core.py:1191-1279, gbtree.cc
        DoBoost with kUpdate): the updater sequence over round
        ``iteration``'s existing trees.  The round's gradients come from
        the margin of the rounds before it as already updated, taken on
        the device and copied to the host once; refresh, prune and sync
        rewrite the trees there.  Across ranks each rank refreshes on its
        own rows with the node sums of all of them, and sync gives every
        rank rank 0's trees."""
        if not self.updater_seq:
            raise ValueError(
                "process_type='update' requires updater=..., e.g. "
                "updater='refresh,prune'")
        bad = set(self.updater_seq) - {"prune", "refresh", "sync"}
        if bad:
            raise ValueError(f"unsupported updater(s) for process_type="
                             f"'update': {sorted(bad)}")
        tpr = self.trees_per_round
        start = iteration * tpr
        if start >= len(self.trees):
            raise ValueError(
                f"process_type='update' round {iteration} exceeds the "
                f"model's {len(self.trees) // tpr} boosted rounds")
        X = self._cache_X(cache)

        def margin_of(ids):  # the trees' margin, padded to the cache's rows
            delta = self._margin_for_trees(X, ids)
            pad = cache.n_rows() - delta.shape[0]
            if pad:
                delta = torch.cat([delta, delta.new_zeros(
                    (pad, delta.shape[1]))])
            return delta

        if getattr(cache, "upd_margin_round", None) != iteration:
            # the margin of the updated prefix, for a fresh cache at any
            # starting round
            margin = cache.base_margin_init(self._base_margin_value,
                                            self.n_groups)
            if start > 0:
                margin = margin + margin_of(list(range(0, start)))
            cache.upd_margin = margin
        gpair = self.objective.get_gradient(
            cache.upd_margin, cache.labels, cache.weights, iteration
        ) * cache.valid[:, None, None]
        gp = gpair.cpu().numpy()
        valid = cache.valid.cpu().numpy()
        Xh = self._host_X(cache)
        end = min(start + tpr, len(self.trees))
        # across ranks each node's (G, H) is summed over the ranks before
        # the weights (reference core.py:1243-1246); prune stays local
        reduce = collective.allreduce if self._distributed else None
        for tid in range(start, end):
            k = self.tree_info[tid]
            tree = self.trees[tid]
            for upd in self.updater_seq:
                if upd == "refresh":
                    tree = refresh_tree(
                        tree, Xh, gp[valid, k, 0], gp[valid, k, 1],
                        eta=float(self.tparam.eta),
                        lambda_=float(self.tparam.lambda_),
                        alpha=float(self.tparam.alpha),
                        refresh_leaf=self.refresh_leaf, reduce=reduce)
                elif upd == "prune":
                    tree, _ = prune_tree(
                        tree, gamma=float(self.tparam.gamma),
                        eta=float(self.tparam.eta),
                        max_depth=max(int(self.tparam.max_depth), 0))
            self.trees[tid] = tree
        if "sync" in self.updater_seq:
            self.trees, self.tree_info, self.tree_weights = sync_trees(
                self.trees, self.tree_info, self.tree_weights)
        # the running margin takes this round's updated trees
        cache.upd_margin = cache.upd_margin + margin_of(
            list(range(start, end)))
        cache.upd_margin_round = iteration + 1
        # the trees changed: every cached margin rebuilds
        self._weights_version += 1

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
            margin = (cache.margin[cache.valid] if cache.is_extmem
                      else cache.margin[: dmat.num_row()])
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
                if self._distributed:
                    # every rank reports the global metric (reference
                    # core.py:1721-1727)
                    with distributed_reduction():
                        v = fn(preds, lab, dmat.get_weight(), **kw)
                else:
                    v = fn(preds, lab, dmat.get_weight(), **kw)
                msgs.append(f"{name}-{mname}:{v:g}")
            if feval is not None:
                res = feval(margin.cpu().numpy() if output_margin else preds,
                            dmat)
                for mname, v in [res] if isinstance(res, tuple) else res:
                    if self._distributed:
                        # a custom metric sees its rank's rows: its mean
                        # over the ranks (reference core.py:1741-1746)
                        num, den = collective.global_sum(
                            np.array([float(v), 1.0], np.float64))
                        v = num / den
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

    def _host_dense(self, dmat: DMatrix) -> np.ndarray:
        """The (R, F) f32 host matrix, recoded as ``_device_X`` recodes
        it (reference ``_host_dense_recoded``)."""
        return recode_dense(dmat.host_dense(), self._cat_categories,
                            dmat.cat_categories)

    def _cache_X(self, cache: _Cache) -> torch.Tensor:
        """A cache's matrix on the booster's device, made once."""
        if cache.raw_X is None:
            cache.raw_X = self._device_X(cache.dmat)
        return cache.raw_X

    def _host_X(self, cache: _Cache) -> np.ndarray:
        """A cache's (R, F) f32 host matrix, recoded as ``_device_X``
        recodes it, made once: the host steps' input (approx's sketch,
        exact's enumeration, the updaters' routing)."""
        if cache.host_X is None:
            cache.host_X = self._host_dense(cache.dmat)
        return cache.host_X

    def _stacked(self, tree_slice: slice, tree_ids=None):
        """The trees' padded node arrays stacked on the device, a DART
        tree's leaf values times its weight (reference core.py:1774-1811:
        ``value * np.float32(w)`` on the host where w != 1)."""
        if tree_ids is not None:
            trees = [self.trees[i] for i in tree_ids]
            info = [self.tree_info[i] for i in tree_ids]
            wts = [self.tree_weights[i] for i in tree_ids]
        else:
            trees = self.trees[tree_slice]
            info = self.tree_info[tree_slice]
            wts = self.tree_weights[tree_slice]
        width = max(t.n_nodes for t in trees)
        depth = max(t.max_depth for t in trees) + 1
        has_cat = any(t.has_categorical for t in trees)
        if any(t.leaf_vector is not None for t in trees) and not all(
                t.leaf_vector is not None for t in trees):
            raise ValueError("a model mixes vector-leaf and scalar trees")
        cols: Dict[str, list] = {}
        for t, w in zip(trees, wts):
            arrs = t.padded_arrays(width)
            if w != 1.0:
                arrs["value"] = arrs["value"] * np.float32(w)
            for k, v in arrs.items():
                cols.setdefault(k, []).append(v)
        if has_cat:
            n_cats = max(t.max_category for t in trees) + 1
            cols["catm"] = [t.cat_matrix(width, n_cats) for t in trees]
        else:
            del cols["is_cat"]
        stacked = {k: torch.from_numpy(np.stack(v)).to(self.device)
                   for k, v in cols.items()}
        return stacked, info, depth

    def _margin_for_trees(self, X, tree_ids: Sequence[int]):
        """The margin of the trees ``tree_ids`` alone (reference
        core.py:1813), from zero."""
        return self._margin_delta_for(X, slice(0, 0), tree_ids=tree_ids)

    def _margin_delta_for(self, X, tree_slice: slice, init=None,
                          tree_ids=None):
        s, groups, depth = self._stacked(tree_slice, tree_ids)
        if "value_vec" in s:  # vector leaves add to every output
            return predict_margin_delta_multi(
                X, s["feat"], s["thr"], s["dleft"], s["left"], s["right"],
                s["value_vec"], init, depth=depth)
        return predict_margin_delta(
            X, s["feat"], s["thr"], s["dleft"], s["left"], s["right"],
            s["value"], groups, init, s.get("is_cat"), s.get("catm"),
            n_groups=self.n_groups, depth=depth)

    def predict(self, data: DMatrix, output_margin: bool = False,
                pred_leaf: bool = False, pred_contribs: bool = False,
                approx_contribs: bool = False,
                pred_interactions: bool = False,
                validate_features: bool = True, training: bool = False,
                iteration_range: Tuple[int, int] = (0, 0),
                strict_shape: bool = False) -> np.ndarray:
        """(reference: core.py:2424 Booster.predict).  ``iteration_range``
        counts rounds; ``pred_leaf``: the (R, T) int32 leaf id of every
        row in every tree of the range; ``pred_contribs``: the (R, F+1) or
        (R, K, F+1) f64 SHAP values (``approx_contribs``: Saabas'), bias
        last; ``pred_interactions``: the (R, [K,] F+1, F+1) SHAP
        interaction values (``interpret/``).  Neither adds the matrix's
        base margin, as in the reference."""
        self._configure()
        if self.booster_kind == "gblinear":
            if pred_leaf:
                raise ValueError(
                    "pred_leaf is not defined for the gblinear booster")
            if pred_interactions:
                raise ValueError(
                    "pred_interactions is not supported for gblinear")
            if pred_contribs:
                return self._linear_contribs(data)
            return self._predict_linear(data, output_margin, strict_shape)
        lo, hi = iteration_range
        hi = hi or self.num_boosted_rounds()
        tpr = self.trees_per_round
        tree_slice = slice(lo * tpr, hi * tpr)
        if hasattr(data, "_pages"):
            return self._predict_pages(data, tree_slice, output_margin,
                                       pred_leaf or pred_contribs
                                       or pred_interactions, strict_shape)
        if pred_contribs or pred_interactions:
            from .interpret import predict_contribs, predict_interactions

            if pred_interactions:
                return predict_interactions(self, data, tree_slice)
            return predict_contribs(self, data, tree_slice,
                                    approx=approx_contribs)
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

    def _predict_pages(self, data, tree_slice: slice, output_margin: bool,
                       per_feature: bool, strict_shape: bool) -> np.ndarray:
        """predict on an external-memory matrix (reference core.py:
        1908-1940): the binned pages' margins, or a SparsePageDMatrix's
        raw pages a page at a time with the trees' float thresholds."""
        if per_feature:
            raise ValueError(
                "pred_leaf/pred_contribs are not supported for "
                "ExtMemQuantileDMatrix; predict on an in-memory DMatrix")
        # the margins stay on the device through the transform
        dev = self.device
        base = torch.from_numpy(np.array(np.broadcast_to(
            self.base_score.reshape(-1), (self.n_groups,)),
            np.float32)).to(dev)
        if self.trees[tree_slice]:
            if getattr(data, "has_raw_pages", False):
                margin = torch.cat([
                    self._margin_delta_for(torch.from_numpy(pg).to(dev),
                                           tree_slice)
                    for pg in data.raw_dense_pages()]) + base[None, :]
            else:
                valid = torch.from_numpy(data.valid_mask()).to(dev)
                margin = self._predict_extmem(data, tree_slice)[valid] + \
                    base[None, :]
        else:
            margin = base[None, :].expand(data.num_row(), -1).clone()
        if data.base_margin is not None:
            um = torch.from_numpy(np.asarray(data.base_margin, np.float32)
                                  .reshape(data.num_row(), -1)).to(dev)
            margin = margin - base[None, :] + um
        out = (margin if output_margin
               else self.objective.pred_transform(margin)).cpu().numpy()
        return out[:, 0] if self.n_groups == 1 and not strict_shape else out

    def _linear_contribs(self, data: DMatrix) -> np.ndarray:
        """gblinear's contributions (reference core.py:1983-1997,
        gblinear.cc PredictContribution): phi_f = x_f w_f in f32 (missing
        as 0), the bias column b + base_score, stored in f64."""
        X = np.nan_to_num(self._host_dense(data), nan=0.0)
        R, F = X.shape
        K = self.n_groups
        W = (self.linear_weights if self.linear_weights is not None
             else np.zeros((F, K), np.float32))
        b = (self.linear_bias if self.linear_bias is not None
             else np.zeros(K, np.float32))
        base = np.broadcast_to(self.base_score.reshape(-1), (K,))
        out = np.zeros((R, K, F + 1), np.float64)
        for k in range(K):
            out[:, k, :F] = X * W[:, k][None, :]
            out[:, k, F] = b[k] + base[k]
        return out[:, 0, :] if K == 1 else out

    def _predict_linear(self, data: DMatrix, output_margin: bool,
                        strict_shape: bool) -> np.ndarray:
        """X @ W + b plus the base margin (reference core.py:1999-2020;
        as there, a matrix's own base margin is not read)."""
        base = np.broadcast_to(self.base_score.reshape(-1), (self.n_groups,))
        if self.linear_weights is None:
            margin = np.broadcast_to(
                base, (data.num_row(), self.n_groups)).copy()
        else:
            XT = torch.nan_to_num(self._device_X(data), nan=0.0).T
            margin = gblinear.linear_predict(
                XT, torch.from_numpy(self.linear_weights).to(self.device),
                torch.from_numpy(self.linear_bias).to(self.device)
            ).cpu().numpy() + base[None, :]
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
        self._configure()
        if self.booster_kind == "gblinear":
            return self._linear_rounds
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
        if self.booster_kind == "gblinear":
            raise ValueError("Slice is not supported by the gblinear booster")
        lo = val.start or 0
        hi = val.stop if val.stop is not None else self.num_boosted_rounds()
        out = self._bare_copy()
        k = self.trees_per_round
        # the trees' own copies: an update pass rewrites trees in place
        out.trees = copy.deepcopy(self.trees[lo * k: hi * k])
        out.tree_info = self.tree_info[lo * k: hi * k]
        out.tree_weights = list(self.tree_weights[lo * k: hi * k])
        return out

    def _bare_copy(self) -> "Booster":
        """A booster of the same parameters and model state but no trees,
        on this booster's device, without the caches."""
        out = Booster(dict(self.params), device=self.device)
        # the training frame's categories too: a copy recodes frames at
        # prediction as its booster does
        for name in ("_base_margin_value", "_num_feature", "feature_names",
                     "feature_types", "best_iteration", "best_score",
                     "_cat_categories", "_linear_rounds"):
            setattr(out, name, getattr(self, name))
        out.attributes = dict(self.attributes)
        return out

    def copy(self) -> "Booster":
        """A booster of the same model and parameters, without the caches
        (reference core.py:2502; a gblinear booster, which cannot be
        sliced, copies its weights)."""
        self._configure()
        if self.booster_kind != "gblinear":
            return self[0: self.num_boosted_rounds()]
        out = self._bare_copy()
        if self.linear_weights is not None:
            out.linear_weights = self.linear_weights.copy()
            out.linear_bias = self.linear_bias.copy()
        return out

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

    def _gbooster_dict(self, n_feat: int) -> dict:
        """The model's ``gradient_booster`` section (reference
        core.py:2112-2144): gbtree's trees; DART's the same under
        ``gbtree`` beside ``weight_drop``; gblinear's feature-major
        weights with the per-group bias last (gblinear.cc SaveModel)."""
        if self.booster_kind == "gblinear":
            W = self.linear_weights if self.linear_weights is not None \
                else np.zeros((n_feat, self.n_groups), np.float32)
            b = self.linear_bias if self.linear_bias is not None \
                else np.zeros(self.n_groups, np.float32)
            return {"model": {
                "weights": [float(x) for x in
                            np.concatenate([W.reshape(-1), b])],
                "param": {"num_feature": str(n_feat),
                          "num_output_group": str(self.n_groups),
                          "num_boosted_rounds": str(self._linear_rounds)}},
                "name": "gblinear"}
        model = {
            "gbtree_model_param": {
                "num_trees": str(len(self.trees)),
                "num_parallel_tree": str(self.num_parallel_tree)},
            "trees": [t.to_json_dict(n_feat, tree_id=i)
                      for i, t in enumerate(self.trees)],
            "tree_info": list(self.tree_info),
        }
        if self.booster_kind == "dart":
            return {"gbtree": {"model": model},
                    "weight_drop": [float(w) for w in self.tree_weights],
                    "name": "dart"}
        return {"model": model, "name": "gbtree"}

    def save_raw_dict(self) -> dict:
        self._configure()
        n_feat = self.num_features()
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
                "gradient_booster": self._gbooster_dict(n_feat),
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
        self._load_gbooster(gbooster)
        self.attributes = dict(learner.get("attributes", {}))
        self.attributes.pop("base_margin_exact", None)
        cc = self.attributes.pop("cat_categories", None)
        self._cat_categories = ({int(k): list(v)
                                 for k, v in json.loads(cc).items()}
                                if cc else None)
        self.feature_names = learner.get("feature_names") or None
        self.feature_types = learner.get("feature_types") or None

    def _load_gbooster(self, gbooster: dict) -> None:
        """Read the ``gradient_booster`` section the way the reference does
        (core.py:2233-2258)."""
        name = gbooster.get("name", "gbtree")
        if name == "gblinear":
            flat = np.asarray(gbooster["model"]["weights"], np.float32)
            K = max(self.n_groups, 1)
            F = self._num_feature or (len(flat) // K - 1)
            self.linear_weights = flat[: F * K].reshape(F, K)
            self.linear_bias = flat[F * K: F * K + K]
            self._linear_rounds = int(gbooster["model"].get("param", {}).get(
                "num_boosted_rounds", "0") or 0)
            self.trees, self.tree_info, self.tree_weights = [], [], []
            return
        gb = gbooster["gbtree"]["model"] if name == "dart" \
            else gbooster["model"]
        self.trees = [RegTree.from_json_dict(t) for t in gb["trees"]]
        self.tree_info = [int(i) for i in gb["tree_info"]]
        self.tree_weights = [float(w) for w in gbooster.get(
            "weight_drop", [1.0] * len(self.trees))]
        if any(t.leaf_vector is not None for t in self.trees):
            self.params["multi_strategy"] = "multi_output_tree"
            self._configured = False
        npt = gb.get("gbtree_model_param", {}).get("num_parallel_tree", "1")
        self.num_parallel_tree = int(npt or 1)
        self.params.setdefault("num_parallel_tree", self.num_parallel_tree)

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

        learner_train = {"booster": self.booster_kind,
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

        # (reference core.py:2329-2351)
        gb: dict = {"name": self.booster_kind}
        if self.booster_kind == "gblinear":
            lin: dict = {}
            for k in ("updater", "feature_selector", "top_k", "eta"):
                take(lin, k)
            lin["lambda"] = hist_param.get("lambda", "0")
            lin["alpha"] = hist_param.get("alpha", "0")
            gb["gblinear_train_param"] = lin
        else:
            gbt = {"num_parallel_tree": s(self.num_parallel_tree)}
            placed.add("num_parallel_tree")
            take(gbt, "process_type", "default")
            take(gbt, "tree_method", "hist")
            take(gbt, "updater")
            gb["gbtree_train_param"] = gbt
            gb["updater"] = {"grow_quantile_histmaker": {
                "hist_train_param": hist_param}}
            if self.booster_kind == "dart":
                dart: dict = {}
                for k in ("rate_drop", "one_drop", "skip_drop",
                          "sample_type", "normalize_type"):
                    take(dart, k)
                gb["dart_train_param"] = dart

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
