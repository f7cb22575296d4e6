"""scikit-learn compatible estimators (port of xgboost_tpu/sklearn.py;
reference python-package/xgboost/sklearn.py: XGBModel:820,
XGBClassifier:1712, XGBRegressor:2020, XGBRanker:2176, the random-forest
variants :1964/:2057).

``device=None`` trains and predicts on ``cuda``, as every entry point of
the port does; ``device="cpu"`` runs on the CPU.  sklearn itself is
imported only by ``__sklearn_tags__``, when sklearn asks for the tags."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .core import Booster
from .data.dmatrix import DMatrix
from .training import train as _train

_SKLEARN_PARAMS = [
    "max_depth", "max_leaves", "max_bin", "grow_policy", "learning_rate",
    "n_estimators", "verbosity", "objective", "booster", "tree_method",
    "gamma", "min_child_weight", "max_delta_step", "subsample",
    "sampling_method", "colsample_bytree", "colsample_bylevel",
    "colsample_bynode", "reg_alpha", "reg_lambda", "scale_pos_weight",
    "base_score", "random_state", "missing", "num_parallel_tree",
    "monotone_constraints", "interaction_constraints", "importance_type",
    "device", "validate_parameters", "enable_categorical", "feature_types",
    "max_cat_to_onehot", "max_cat_threshold", "multi_strategy",
    "eval_metric", "early_stopping_rounds", "callbacks",
]


class XGBModel:
    """Base estimator (reference: sklearn.py:820)."""

    def __init__(
        self,
        max_depth: Optional[int] = None,
        max_leaves: Optional[int] = None,
        max_bin: Optional[int] = None,
        grow_policy: Optional[str] = None,
        learning_rate: Optional[float] = None,
        n_estimators: Optional[int] = None,
        verbosity: Optional[int] = None,
        objective: Optional[str] = None,
        booster: Optional[str] = None,
        tree_method: Optional[str] = None,
        n_jobs: Optional[int] = None,
        gamma: Optional[float] = None,
        min_child_weight: Optional[float] = None,
        max_delta_step: Optional[float] = None,
        subsample: Optional[float] = None,
        sampling_method: Optional[str] = None,
        colsample_bytree: Optional[float] = None,
        colsample_bylevel: Optional[float] = None,
        colsample_bynode: Optional[float] = None,
        reg_alpha: Optional[float] = None,
        reg_lambda: Optional[float] = None,
        scale_pos_weight: Optional[float] = None,
        base_score: Optional[float] = None,
        random_state: Optional[int] = None,
        missing: float = np.nan,
        num_parallel_tree: Optional[int] = None,
        monotone_constraints: Optional[Any] = None,
        interaction_constraints: Optional[Any] = None,
        importance_type: Optional[str] = None,
        device: Optional[str] = None,
        validate_parameters: Optional[bool] = None,
        enable_categorical: bool = False,
        feature_types: Optional[Any] = None,
        max_cat_to_onehot: Optional[int] = None,
        max_cat_threshold: Optional[int] = None,
        multi_strategy: Optional[str] = None,
        eval_metric: Optional[Union[str, List[str], Callable]] = None,
        early_stopping_rounds: Optional[int] = None,
        callbacks: Optional[List] = None,
        **kwargs: Any,
    ):
        self.max_depth = max_depth
        self.max_leaves = max_leaves
        self.max_bin = max_bin
        self.grow_policy = grow_policy
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.verbosity = verbosity
        self.objective = objective
        self.booster = booster
        self.tree_method = tree_method
        self.n_jobs = n_jobs
        self.gamma = gamma
        self.min_child_weight = min_child_weight
        self.max_delta_step = max_delta_step
        self.subsample = subsample
        self.sampling_method = sampling_method
        self.colsample_bytree = colsample_bytree
        self.colsample_bylevel = colsample_bylevel
        self.colsample_bynode = colsample_bynode
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.scale_pos_weight = scale_pos_weight
        self.base_score = base_score
        self.random_state = random_state
        self.missing = missing
        self.num_parallel_tree = num_parallel_tree
        self.monotone_constraints = monotone_constraints
        self.interaction_constraints = interaction_constraints
        self.importance_type = importance_type
        self.device = device
        self.validate_parameters = validate_parameters
        self.enable_categorical = enable_categorical
        self.feature_types = feature_types
        self.max_cat_to_onehot = max_cat_to_onehot
        self.max_cat_threshold = max_cat_threshold
        self.multi_strategy = multi_strategy
        self.eval_metric = eval_metric
        self.early_stopping_rounds = early_stopping_rounds
        self.callbacks = callbacks
        self.kwargs = kwargs
        self._Booster: Optional[Booster] = None

    # --- sklearn protocol ---
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        out = {k: getattr(self, k) for k in _SKLEARN_PARAMS
               if hasattr(self, k)}
        out["n_jobs"] = self.n_jobs
        out["random_state"] = self.random_state
        out.update(self.kwargs)
        return out

    def set_params(self, **params: Any) -> "XGBModel":
        for k, v in params.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self.kwargs[k] = v
        return self

    def _more_tags(self):
        return {"allow_nan": True}

    def __sklearn_tags__(self):
        # sklearn >= 1.6 tags protocol; sklearn is imported only here
        from sklearn.base import BaseEstimator

        tags = BaseEstimator.__sklearn_tags__(self)
        tags.input_tags.allow_nan = True
        return tags

    def _default_objective(self) -> str:
        return "reg:squarederror"

    def _xgb_params(self) -> Dict[str, Any]:
        mapping = {
            "learning_rate": "eta",
            "reg_alpha": "alpha",
            "reg_lambda": "lambda",
            "random_state": "seed",
        }
        skip = {"n_estimators", "n_jobs", "missing", "importance_type",
                "enable_categorical", "feature_types", "early_stopping_rounds",
                "callbacks", "eval_metric", "kwargs"}
        params: Dict[str, Any] = {}
        for k in _SKLEARN_PARAMS:
            if k in skip or not hasattr(self, k):
                continue
            v = getattr(self, k)
            if v is None:
                continue
            params[mapping.get(k, k)] = v
        params.update(self.kwargs)
        fit_obj = getattr(self, "_fit_objective", None)
        if fit_obj is not None:
            params["objective"] = fit_obj
        params.setdefault("objective", self._default_objective())
        if self.eval_metric is not None and not callable(self.eval_metric):
            params["eval_metric"] = self.eval_metric
        return params

    def _n_rounds(self) -> int:
        return self.n_estimators if self.n_estimators is not None else 100

    def fit(
        self,
        X,
        y,
        *,
        sample_weight=None,
        base_margin=None,
        eval_set: Optional[Sequence[Tuple[Any, Any]]] = None,
        verbose: Optional[Union[bool, int]] = False,
        xgb_model=None,
        sample_weight_eval_set=None,
        base_margin_eval_set=None,
        feature_weights=None,
    ) -> "XGBModel":
        dtrain = DMatrix(X, label=y, weight=sample_weight,
                         base_margin=base_margin, missing=self.missing,
                         feature_weights=feature_weights, device=self.device)
        evals = []
        if eval_set:
            for i, (Xe, ye) in enumerate(eval_set):
                we = (sample_weight_eval_set[i] if sample_weight_eval_set
                      else None)
                bme = (base_margin_eval_set[i] if base_margin_eval_set
                       else None)
                if Xe is X and ye is y:
                    evals.append((dtrain, f"validation_{i}"))
                else:
                    evals.append(
                        (DMatrix(Xe, label=ye, weight=we, base_margin=bme,
                                 missing=self.missing, device=self.device),
                         f"validation_{i}")
                    )
        res: Dict[str, Dict[str, List[float]]] = {}
        self._Booster = _train(
            self._xgb_params(), dtrain, self._n_rounds(), evals=evals,
            early_stopping_rounds=self.early_stopping_rounds,
            evals_result=res, verbose_eval=verbose,
            xgb_model=xgb_model, callbacks=self.callbacks, device=self.device,
        )
        self.evals_result_ = res
        self.n_features_in_ = dtrain.num_col()
        if self._Booster.best_iteration is not None:
            self.best_iteration = self._Booster.best_iteration
            self.best_score = self._Booster.best_score
        return self

    def get_booster(self) -> Booster:
        if self._Booster is None:
            raise ValueError("need to call fit or load_model first")
        return self._Booster

    def predict(
        self,
        X,
        *,
        output_margin: bool = False,
        validate_features: bool = True,
        base_margin=None,
        iteration_range: Optional[Tuple[int, int]] = None,
    ):
        d = DMatrix(X, missing=self.missing, base_margin=base_margin,
                    device=self.device)
        return self.get_booster().predict(
            d, output_margin=output_margin,
            iteration_range=self._iteration_range(iteration_range),
        )

    def _iteration_range(self, iteration_range):
        """Default to (0, best_iteration+1) after early stopping; upstream
        treats both None and hi == 0 as "unspecified"
        (reference: sklearn.py _get_iteration_range)."""
        if iteration_range is not None and iteration_range[1] != 0:
            return iteration_range
        best = getattr(self._Booster, "best_iteration", None)
        if best is not None:
            return (0, int(best) + 1)
        return (0, 0)

    def apply(self, X, iteration_range=None):
        d = DMatrix(X, missing=self.missing, device=self.device)
        return self.get_booster().predict(
            d, pred_leaf=True,
            iteration_range=self._iteration_range(iteration_range))

    def save_model(self, fname) -> None:
        self.get_booster().save_model(fname)

    def load_model(self, fname) -> None:
        self._Booster = Booster(device=self.device)
        self._Booster.load_model(fname)

    @property
    def feature_importances_(self) -> np.ndarray:
        b = self.get_booster()
        score = b.get_score(importance_type=self.importance_type or "weight")
        n = (self.n_features_in_ if hasattr(self, "n_features_in_")
             else b.num_features())
        names = b.feature_names or [f"f{i}" for i in range(n)]
        total = sum(score.values()) or 1.0
        return np.array([score.get(f, 0.0) / total for f in names],
                        dtype=np.float32)

    @property
    def intercept_(self) -> np.ndarray:
        return np.asarray(self.get_booster().base_score)

    def evals_result(self) -> Dict:
        return getattr(self, "evals_result_", {})


class XGBRegressor(XGBModel):
    """(reference: sklearn.py:2020)"""


class XGBClassifier(XGBModel):
    """(reference: sklearn.py:1712)"""

    def _default_objective(self) -> str:
        return "binary:logistic"

    def fit(self, X, y, **kwargs) -> "XGBClassifier":
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        self.n_classes_ = len(self.classes_)
        y_enc = np.searchsorted(self.classes_, y).astype(np.float32)
        # per-fit objective/num_class (refitting with a different class count
        # must not inherit stale state)
        self.kwargs.pop("num_class", None)
        if self.n_classes_ > 2:
            if self.objective is None or \
                    not str(self.objective).startswith("multi"):
                self._fit_objective = "multi:softprob"
            else:
                self._fit_objective = self.objective
            self.kwargs["num_class"] = self.n_classes_
        else:
            self._fit_objective = self.objective or self._default_objective()
        super().fit(X, y_enc, **kwargs)
        return self

    def predict(self, X, *, output_margin=False, validate_features=True,
                base_margin=None, iteration_range=None):
        raw = super().predict(
            X, output_margin=output_margin, base_margin=base_margin,
            iteration_range=iteration_range,
        )
        if output_margin:
            return raw
        if raw.ndim == 2:
            idx = np.argmax(raw, axis=1)
        elif getattr(self, "n_classes_", 2) > 2:
            idx = raw.astype(np.int64)  # multi:softmax emits class ids
        else:
            idx = (raw > 0.5).astype(np.int64)
        return self.classes_[idx]

    def predict_proba(self, X, *, validate_features=True, base_margin=None,
                      iteration_range=None):
        fit_obj = str(getattr(self, "_fit_objective", self.objective))
        if getattr(self, "n_classes_", 2) > 2 and fit_obj == "multi:softmax":
            # softmax objective transforms to class ids; recover probabilities
            # from raw margins (reference sklearn.py does the same)
            m = super().predict(X, output_margin=True, base_margin=base_margin,
                                iteration_range=iteration_range)
            e = np.exp(m - m.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        raw = super().predict(X, base_margin=base_margin,
                              iteration_range=iteration_range)
        if raw.ndim == 2:
            return raw
        return np.stack([1 - raw, raw], axis=1)


class XGBRanker(XGBModel):
    """(reference: sklearn.py:2176)"""

    def _default_objective(self) -> str:
        return "rank:ndcg"

    def fit(self, X, y, *, group=None, qid=None, sample_weight=None,
            eval_set=None, eval_group=None, eval_qid=None, verbose=False,
            **kwargs) -> "XGBRanker":
        dtrain = DMatrix(X, label=y, weight=sample_weight,
                         missing=self.missing, group=group, qid=qid,
                         device=self.device)
        evals = []
        if eval_set:
            for i, (Xe, ye) in enumerate(eval_set):
                ge = eval_group[i] if eval_group else None
                qe = eval_qid[i] if eval_qid else None
                evals.append((DMatrix(Xe, label=ye, missing=self.missing,
                                      group=ge, qid=qe, device=self.device),
                              f"validation_{i}"))
        res: Dict = {}
        self._Booster = _train(
            self._xgb_params(), dtrain, self._n_rounds(), evals=evals,
            early_stopping_rounds=self.early_stopping_rounds,
            evals_result=res, verbose_eval=verbose, callbacks=self.callbacks,
            device=self.device,
        )
        self.evals_result_ = res
        self.n_features_in_ = dtrain.num_col()
        return self


def _rf_defaults(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    kwargs.setdefault("learning_rate", 1.0)
    kwargs.setdefault("subsample", 0.8)
    kwargs.setdefault("colsample_bynode", 0.8)
    kwargs.setdefault("reg_lambda", 1e-5)
    return kwargs


class XGBRFRegressor(XGBRegressor):
    """Random-forest style (reference: sklearn.py:2057)."""

    def __init__(self, **kwargs):
        super().__init__(**_rf_defaults(kwargs))


class XGBRFClassifier(XGBClassifier):
    """(reference: sklearn.py:1964)"""

    def __init__(self, **kwargs):
        super().__init__(**_rf_defaults(kwargs))
