"""Training hyper-parameters (port of the subset of xgboost_tpu/params.py
that the depthwise ``hist`` grower reads).

``TrainParam`` holds the tree parameters the slice supports;
``reject_unsupported`` fails loudly on every parameter the port does not
implement yet, naming it, instead of training a different model quietly.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

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
    min_child_weight: float = 1.0
    lambda_: float = 1.0
    alpha: float = 0.0
    max_delta_step: float = 0.0
    colsample_bytree: float = 1.0
    colsample_bylevel: float = 1.0
    colsample_bynode: float = 1.0
    monotone_constraints: Optional[Tuple[int, ...]] = None
    interaction_constraints: Optional[Tuple[Tuple[int, ...], ...]] = None

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
            setattr(self, f.name, v)
        self.validate()
        return self

    def validate(self) -> None:
        if self.max_depth < 1:
            raise ValueError("max_depth must be >= 1 (trees bounded by "
                             "max_leaves alone are not supported)")
        if self.max_leaves < 0:
            raise ValueError("max_leaves must be >= 0")
        if self.max_bin < 2:
            raise ValueError("max_bin must be >= 2")
        for name in ("colsample_bytree", "colsample_bylevel",
                     "colsample_bynode"):
            if not 0.0 < getattr(self, name) <= 1.0:
                raise ValueError(f"{name} must be in (0, 1]")


def _truthy(v) -> bool:
    return str(v).lower() in ("1", "true", "yes")


def _is_default(key: str, v) -> bool:
    if key in ("subsample", "num_parallel_tree", "num_target"):
        return float(v) == 1.0
    if key == "num_class":
        return int(v) == 0
    if key == "enable_categorical":
        return not _truthy(v)
    return {"grow_policy": "depthwise", "booster": "gbtree",
            "tree_method": "hist", "multi_strategy": "one_output_per_tree",
            "process_type": "default", "n_devices": 1}[key] == v


# parameters the port does not implement: at any value but their default
# they raise NotImplementedError.  subsample's row mask is a
# jax.random.bernoulli draw in the reference, which torch cannot reproduce
# bitwise; grow_policy=lossguide is the best-first grower
UNSUPPORTED = ("subsample", "grow_policy", "num_parallel_tree", "booster",
               "tree_method", "num_class", "num_target", "multi_strategy",
               "process_type", "n_devices", "enable_categorical")


def reject_unsupported(params: Dict[str, Any]) -> None:
    p = canonicalize(params)
    for key in UNSUPPORTED:
        if key in p and not _is_default(key, p[key]):
            raise NotImplementedError(
                f"parameter {key}={p[key]!r} is not supported by "
                "xgboost_tpu_torch yet")
