"""Training hyper-parameters (port of the subset of xgboost_tpu/params.py
that the ``hist`` growers read).

``TrainParam`` holds the tree parameters the slice supports;
``reject_unsupported`` fails loudly on every parameter the port does not
implement yet, naming it, instead of training a different model quietly.
The objectives read their own parameters from the dict (``huber_slope``,
``tweedie_variance_power``, ``quantile_alpha`` and ``expectile_alpha``, a
number or a list, ``aft_loss_distribution``,
``aft_loss_distribution_scale``, ``scale_pos_weight``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

# alias -> canonical (reference: DMLC_DECLARE_ALIAS in src/tree/param.h)
_ALIASES = {
    "learning_rate": "eta",
    "min_split_loss": "gamma",
    "reg_lambda": "lambda",
    "reg_alpha": "alpha",
}


def canonicalize(params: Dict[str, Any]) -> Dict[str, Any]:
    return {_ALIASES.get(k, k): v for k, v in params.items()}


@dataclasses.dataclass
class TrainParam:
    """Tree-construction parameters (reference: src/tree/param.h:82-173)."""

    eta: float = 0.3
    gamma: float = 0.0
    max_depth: int = 6
    max_leaves: int = 0
    max_bin: int = 256
    grow_policy: str = "depthwise"  # depthwise | lossguide
    min_child_weight: float = 1.0
    lambda_: float = 1.0
    alpha: float = 0.0
    max_delta_step: float = 0.0
    subsample: float = 1.0
    sampling_method: str = "uniform"  # uniform | gradient_based
    colsample_bytree: float = 1.0
    colsample_bylevel: float = 1.0
    colsample_bynode: float = 1.0
    monotone_constraints: Optional[Tuple[int, ...]] = None
    interaction_constraints: Optional[Tuple[Tuple[int, ...], ...]] = None
    # categorical splits: one-hot below this many categories, the sorted
    # partition from it on (src/tree/param.h max_cat_to_onehot)
    max_cat_to_onehot: int = 4
    # accepted as the reference accepts it; no code of the port reads it
    max_cat_threshold: int = 64
    # the refresh updater's (process_type="update"): rewrite the leaves too
    refresh_leaf: bool = True

    @staticmethod
    def from_dict(params: Dict[str, Any]) -> "TrainParam":
        p = canonicalize(params)
        self = TrainParam()
        for f in dataclasses.fields(TrainParam):
            key = "lambda" if f.name == "lambda_" else f.name
            if key not in p:
                continue
            v = p[key]
            if f.name == "monotone_constraints" and v is not None:
                if isinstance(v, str):  # "(1,0,-1)"
                    v = v.strip("()[] ")
                    v = tuple(int(x) for x in v.split(",")
                              if x.strip()) if v else None
                else:
                    v = tuple(int(x) for x in v)
            elif f.name == "interaction_constraints" and v is not None:
                if isinstance(v, str):  # "[[0, 1], [2, 3]]"
                    v = json.loads(v)
                v = tuple(tuple(int(i) for i in grp) for grp in v)
            elif f.type == "int":
                v = int(v)
            elif f.type == "float":
                v = float(v)
            elif f.type == "bool":
                v = v if isinstance(v, bool) else \
                    str(v).lower() in ("1", "true", "yes")
            setattr(self, f.name, v)
        self.validate()
        return self

    def validate(self) -> None:
        if self.max_depth < 0:
            raise ValueError("max_depth must be >= 0")
        if self.max_depth == 0 and self.max_leaves == 0:
            raise ValueError("one of max_depth / max_leaves must be positive")
        if self.max_leaves < 0:
            raise ValueError("max_leaves must be >= 0")
        if not 0.0 < self.subsample <= 1.0:
            raise ValueError("subsample must be in (0, 1]")
        if self.max_bin < 2:
            raise ValueError("max_bin must be >= 2")
        for name in ("colsample_bytree", "colsample_bylevel",
                     "colsample_bynode"):
            if not 0.0 < getattr(self, name) <= 1.0:
                raise ValueError(f"{name} must be in (0, 1]")
        if self.grow_policy not in ("depthwise", "lossguide"):
            raise ValueError("grow_policy must be 'depthwise' or 'lossguide'")
        if self.sampling_method not in ("uniform", "gradient_based"):
            raise ValueError(
                "sampling_method must be 'uniform' or 'gradient_based'")


# Known learner-level keys (reference: xgboost_tpu/params.py:123-142,
# src/learner.cc LearnerTrainParam and the objective and metric registries):
# what load_config collects, and what validate_parameters accepts beside
# the tree parameters
KNOWN_LEARNER_KEYS = {
    "objective", "base_score", "num_class", "eval_metric", "seed", "nthread",
    "device", "tree_method", "booster", "verbosity",
    "disable_default_eval_metric", "num_parallel_tree", "multi_strategy",
    "num_target",
    # dart
    "rate_drop", "one_drop", "skip_drop", "sample_type", "normalize_type",
    # gblinear
    "updater", "feature_selector", "top_k",
    # ranking
    "lambdarank_num_pair_per_sample", "lambdarank_pair_method",
    "ndcg_exp_gain", "lambdarank_unbiased", "lambdarank_bias_norm",
    "lambdarank_normalization", "lambdarank_score_normalization",
    # survival / quantile
    "aft_loss_distribution", "aft_loss_distribution_scale", "quantile_alpha",
    "expectile_alpha",
    # tweedie / huber
    "tweedie_variance_power", "huber_slope",
    "scale_pos_weight", "enable_categorical", "missing", "validate_parameters",
    "n_devices", "process_type", "refresh_leaf", "deterministic_histogram",
}


def tree_keys() -> set:
    """The TrainParam fields under their parameter names."""
    return {("lambda" if f.name == "lambda_" else f.name)
            for f in dataclasses.fields(TrainParam)}


def split_unknown(params: Dict[str, Any]) -> List[str]:
    """Parameters neither a tree nor a learner key; leading-underscore
    keys are internal hooks (``_lockstep``, ``_hist_impl``), outside the
    public surface (reference params.py:145)."""
    known = tree_keys() | KNOWN_LEARNER_KEYS
    return [k for k in canonicalize(params)
            if k not in known and not k.startswith("_")]


def _is_default(v) -> bool:
    """Whether ``v`` is the one value of an unsupported key the port
    implements, 1, compared parsed: ``load_config`` gives every value as a
    string."""
    return not isinstance(v, bool) and str(v).strip() == "1"


# parameters the port does not implement: at any value but their default
# they raise NotImplementedError (n_devices: one device a process)
UNSUPPORTED = ("n_devices",)


def reject_unsupported(params: Dict[str, Any]) -> None:
    p = canonicalize(params)
    for key in UNSUPPORTED:
        if key in p and not _is_default(p[key]):
            raise NotImplementedError(
                f"parameter {key}={p[key]!r} is not supported by "
                "xgboost_tpu_torch yet")
