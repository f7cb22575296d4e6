"""Training hyper-parameters (port of the subset of xgboost_tpu/params.py
that the depthwise ``hist`` slice reads).

``TrainParam`` holds the tree parameters the slice supports;
``reject_unsupported`` fails loudly on every parameter the port does not
implement yet, naming it, instead of training a different model quietly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

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
    max_bin: int = 256
    min_child_weight: float = 1.0
    lambda_: float = 1.0
    alpha: float = 0.0
    max_delta_step: float = 0.0

    @staticmethod
    def from_dict(params: Dict[str, Any]) -> "TrainParam":
        p = canonicalize(params)
        self = TrainParam()
        for f in dataclasses.fields(TrainParam):
            key = "lambda" if f.name == "lambda_" else f.name
            if key in p:
                cast = int if f.type == "int" else float
                setattr(self, f.name, cast(p[key]))
        self.validate()
        return self

    def validate(self) -> None:
        if self.max_depth < 1:
            raise ValueError("max_depth must be >= 1 (max_leaves-bounded "
                             "trees are not supported)")
        if self.max_bin < 2:
            raise ValueError("max_bin must be >= 2")


def _truthy(v) -> bool:
    return str(v).lower() in ("1", "true", "yes")


def _is_default(key: str, v) -> bool:
    if key == "monotone_constraints":  # all zero: no constraint
        return v is None or all(
            c.strip() in ("0", "") for c in str(v).strip("()[] ").split(","))
    if key == "interaction_constraints":
        return v is None or not str(v).strip("()[] ")
    if key in ("subsample", "colsample_bytree", "colsample_bylevel",
               "colsample_bynode", "num_parallel_tree", "num_target"):
        return float(v) == 1.0
    if key in ("max_leaves", "num_class"):
        return int(v) == 0
    if key in ("deterministic_histogram", "enable_categorical"):
        return not _truthy(v)
    return {"grow_policy": "depthwise", "booster": "gbtree",
            "tree_method": "hist", "multi_strategy": "one_output_per_tree",
            "process_type": "default", "n_devices": 1}[key] == v


# parameters the slice does not implement: at any value but their default
# they raise NotImplementedError
UNSUPPORTED = ("monotone_constraints", "interaction_constraints", "subsample",
               "colsample_bytree", "colsample_bylevel", "colsample_bynode",
               "grow_policy", "max_leaves", "deterministic_histogram",
               "num_parallel_tree", "booster", "tree_method", "num_class",
               "num_target", "multi_strategy", "process_type", "n_devices",
               "enable_categorical")


def reject_unsupported(params: Dict[str, Any]) -> None:
    p = canonicalize(params)
    for key in UNSUPPORTED:
        if key in p and not _is_default(key, p[key]):
            raise NotImplementedError(
                f"parameter {key}={p[key]!r} is not supported by "
                "xgboost_tpu_torch yet")
