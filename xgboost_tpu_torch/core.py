"""Booster: the trained model + training-step engine (port of the gbtree /
hist subset of xgboost_tpu/core.py).

Call stack for one boosting iteration:
  train() -> Booster.update(dtrain, i)
    -> objective.get_gradient on the cached margin           [device]
    -> HistTreeGrower.grow: per level histogram (CUDA kernel
       K1 on the card, K2 under deterministic_histogram=1),
       split scan under the column sample and constraints,
       row routing                                            [device]
    -> leaf_margin_delta updates the margin cache            [device]
    -> RegTree.from_grown appends the host model
The model dict (``save_raw_dict``) follows the reference's JSON schema, so
models cross-load between the two packages.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .data.dmatrix import DMatrix
from .metric import create_metric
from .models.tree import RegTree
from .objective import ObjFunction, create_objective
from .ops.predict import predict_margin_delta
from .ops.split import SplitParams
from .params import TrainParam, canonicalize, reject_unsupported
from .tree.grow import HistTreeGrower, leaf_margin_delta
from .utils.device import resolve_device

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
        self.n_bins = ell.n_bins.to(dev)
        R_pad, R = ell.n_padded, ell.n_rows
        self.valid = torch.arange(R_pad, device=dev) < R

        def padded(a):
            out = torch.zeros(R_pad, dtype=torch.float32, device=dev)
            out[:R] = torch.from_numpy(a).to(dev)
            return out

        self.labels = padded(self.dmat.get_label())
        w = self.dmat.get_weight()
        self.weights = None if w is None else padded(w)
        if self.margin is not None and self.margin.shape[0] != R_pad:
            extra = torch.zeros((R_pad - self.margin.shape[0],
                                 self.margin.shape[1]), device=dev)
            self.margin = torch.cat([self.margin, extra])

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
    ``None`` means the ``device`` parameter if given, else ``cuda``."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 cache: Sequence[DMatrix] = (),
                 model_file: Optional[Union[str, os.PathLike]] = None,
                 device=None) -> None:
        self.params: Dict[str, Any] = canonicalize(dict(params or {}))
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
        reject_unsupported(p)
        self.tparam = TrainParam.from_dict(p)
        self.objective: ObjFunction = create_objective(
            str(p.get("objective", "reg:squarederror")), p)
        self.n_groups = 1
        self._base_score_param = p.get("base_score", None)
        # exact limb histograms (ops/quantise.py): trees that do not depend
        # on the order of any sum (reference quantiser.cuh)
        self.deterministic_histogram = str(
            p.get("deterministic_histogram", "0")).lower() in ("1", "true")
        self._split_params = SplitParams(
            eta=float(self.tparam.eta), gamma=float(self.tparam.gamma),
            min_child_weight=float(self.tparam.min_child_weight),
            lambda_=float(self.tparam.lambda_), alpha=float(self.tparam.alpha),
            max_delta_step=float(self.tparam.max_delta_step),
            monotone=self.tparam.monotone_constraints)
        self._grower = HistTreeGrower(
            self.tparam.max_depth, self._split_params,
            interaction_sets=self.tparam.interaction_constraints,
            max_leaves=self.tparam.max_leaves,
            quantised=self.deterministic_histogram)
        self._configured = True

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
            X = cache.dmat.X.to(self.device)
            R = X.shape[0]
            m = self._margin_delta_for(X, new, init=cache.margin[:R])
            cache.margin = torch.cat([m, cache.margin[R:]])
            cache.n_trees_applied = len(self.trees)

    # ------------------------------------------------------------------ train
    def update(self, dtrain: DMatrix, iteration: int) -> None:
        """One boosting iteration (learner.cc:1108 UpdateOneIter)."""
        self._configure()
        cache = self._get_cache(dtrain)
        cache.ensure_train(self.tparam.max_bin)
        if self.feature_names is None and dtrain.feature_names:
            self.feature_names = list(dtrain.feature_names)
        self._sync_margin(cache)
        gpair = self.objective.get_gradient(cache.margin, cache.labels,
                                            cache.weights)
        gpair = gpair * cache.valid[:, None, None]  # (R_pad, 1, 2)
        self._boost_trees(cache, gpair, iteration)

    def _rng(self, iteration: int, tag: int) -> np.random.Generator:
        seed = int(self.params.get("seed", 0))
        return np.random.default_rng(
            (seed * 1_000_003 + iteration * 131 + tag) % (2**63))

    def _feature_masks(self, iteration: int, n_features: int):
        """ColumnSampler (reference: src/common/random.h ColumnSampler):
        each level samples exactly max(1, frac * n_avail) of the surviving
        features without replacement, by the k smallest exponential keys
        per row.  The draws are numpy on the host, in the reference's order,
        so they agree with it bitwise.  None when nothing is sampled."""
        tp = self.tparam
        if tp.colsample_bytree >= 1.0 and tp.colsample_bylevel >= 1.0 \
                and tp.colsample_bynode >= 1.0:
            return None
        # the reference seeds parallel tree p with iteration * 131 + p and
        # tag 17 + p (xgboost_tpu/core.py:1517); the port grows p = 0 only
        rng = self._rng(iteration * 131, 17)

        def sample(prev_mask, frac):
            if frac >= 1.0:
                return prev_mask
            m2 = np.atleast_2d(prev_mask)
            rows, F = m2.shape
            keys = np.where(m2, rng.exponential(size=(rows, F)), np.inf)
            k = np.minimum(np.maximum(1, (frac * m2.sum(axis=1)).astype(
                np.int64)), np.isfinite(keys).sum(axis=1))
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
        mono = self.tparam.monotone_constraints
        n_features = cache.bins.shape[1]
        if mono is not None and len(mono) != n_features:
            raise ValueError(
                f"monotone_constraints has {len(mono)} entries but data has "
                f"{n_features} features")
        state = self._grower.grow(
            cache.bins, gpair[:, 0, :].contiguous(), cache.valid,
            cache.cuts_pad, cache.n_bins,
            feature_masks=self._feature_masks(iteration, n_features))
        cache.margin[:, 0] += leaf_margin_delta(state.pos, state.leaf_val)
        self.trees.append(RegTree.from_grown(HistTreeGrower.to_host(state)))
        self.tree_info.append(0)
        cache.n_trees_applied = len(self.trees)

    # ------------------------------------------------------------------ eval
    def eval_set(self, evals: Sequence[Tuple[DMatrix, str]],
                 iteration: int = 0) -> str:
        """(reference: learner.cc:1159 EvalOneIter)"""
        self._configure()
        msgs = [f"[{iteration}]"]
        metrics = self._eval_metric_list()
        for dmat, name in evals:
            cache = self._get_cache(dmat)
            self._sync_margin(cache)
            margin = cache.margin[: dmat.num_row()]
            preds = self.objective.pred_transform(margin)[:, 0].cpu().numpy()
            for fn, mname in metrics:
                v = fn(preds, dmat.get_label(), dmat.get_weight())
                msgs.append(f"{name}-{mname}:{v:g}")
        return "\t".join(msgs)

    def _eval_metric_list(self):
        names = self.params.get("eval_metric", None)
        if names is None:
            names = [self.objective.default_metric()]
        elif isinstance(names, str):
            names = [names]
        return [create_metric(n) for n in names]

    # ------------------------------------------------------------------ predict
    def _stacked(self, tree_slice: slice):
        trees = self.trees[tree_slice]
        width = max(t.n_nodes for t in trees)
        depth = max(t.max_depth for t in trees) + 1
        cols: Dict[str, list] = {}
        for t in trees:
            for k, v in t.padded_arrays(width).items():
                cols.setdefault(k, []).append(v)
        stacked = {k: torch.from_numpy(np.stack(v)).to(self.device)
                   for k, v in cols.items()}
        return stacked, self.tree_info[tree_slice], depth

    def _margin_delta_for(self, X, tree_slice: slice, init=None):
        s, groups, depth = self._stacked(tree_slice)
        return predict_margin_delta(
            X, s["feat"], s["thr"], s["dleft"], s["left"], s["right"],
            s["value"], groups, init, n_groups=self.n_groups, depth=depth)

    def predict(self, data: DMatrix, output_margin: bool = False,
                iteration_range: Tuple[int, int] = (0, 0),
                strict_shape: bool = False) -> np.ndarray:
        """(reference: core.py:2424 Booster.predict)"""
        self._configure()
        lo, hi = iteration_range
        hi = hi or self.num_boosted_rounds()
        tree_slice = slice(lo, hi)
        base = np.broadcast_to(self.base_score.reshape(-1), (self.n_groups,))
        if self.trees[tree_slice]:
            X = data.X.to(self.device)
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
        return out if strict_shape else out[:, 0]

    # ------------------------------------------------------------------ model
    def num_boosted_rounds(self) -> int:
        return len(self.trees)

    def num_features(self) -> int:
        if self._num_feature:
            return self._num_feature
        if self.trees:
            return int(max(t.split_indices.max(initial=0)
                           for t in self.trees)) + 1
        return 0

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
        obj = self.save_raw_dict()
        fname = os.fspath(fname)
        if fname.endswith(".ubj"):
            from .utils.ubjson import dump_ubjson

            with open(fname, "wb") as fh:
                dump_ubjson(obj, fh)
        else:
            with open(fname, "w") as fh:
                json.dump(obj, fh)

    def _base_score_str(self) -> str:
        """base_score in probability space, reference model-JSON form."""
        m = np.asarray(self.base_score, np.float32).reshape(-1)[0]
        prob = self.objective.margin_to_prob(torch.tensor(m))
        return f"{float(prob):.9E}"

    def save_raw_dict(self) -> dict:
        self._configure()
        n_feat = self.num_features()
        model = {
            "gbtree_model_param": {"num_trees": str(len(self.trees)),
                                   "num_parallel_tree": "1"},
            "trees": [t.to_json_dict(n_feat, tree_id=i)
                      for i, t in enumerate(self.trees)],
            "tree_info": list(self.tree_info),
        }
        # the exact f32 margin rides as an attribute: prob <-> margin does
        # not round-trip bitwise in f32
        attrs = dict(self.attributes)
        attrs["base_margin_exact"] = " ".join(
            repr(float(v)) for v in np.asarray(self.base_score).reshape(-1))
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
                    "num_class": "0",
                    "num_feature": str(n_feat),
                    "num_target": "1",
                },
                "objective": {"name": self.objective.name},
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
            raw = str(lmp["base_score"]).strip().strip("[]()")
            prob = float(raw.replace(",", " ").split()[0])
            vals = self.objective.prob_to_margin(
                torch.tensor(prob, dtype=torch.float32)).numpy()
        self._base_margin_value = np.broadcast_to(
            np.asarray(vals, np.float32).reshape(-1)[:1],
            (self.n_groups,)).copy()
        self._num_feature = int(lmp.get("num_feature", "0")) or None
        gb = gbooster["model"]
        self.trees = [RegTree.from_json_dict(t) for t in gb["trees"]]
        self.tree_info = [int(i) for i in gb["tree_info"]]
        self.attributes = dict(learner.get("attributes", {}))
        self.attributes.pop("base_margin_exact", None)
        self.feature_names = learner.get("feature_names") or None
        self.feature_types = learner.get("feature_types") or None
