"""Objective functions (port of xgboost_tpu/objective/__init__.py).

Each objective computes per-row (grad, hess) pairs on the margin's device,
plus the link functions and the one-step Newton ``init_estimation``
(reference: ObjFunction::InitEstimation + FitStump, src/tree/fit_stump.cc:34).
Registry dispatch by name mirrors XGBOOST_REGISTER_OBJECTIVE.
"""
from __future__ import annotations

from typing import Dict, Type

import torch

from ..utils.fp import sum_f32

_REGISTRY: Dict[str, Type["ObjFunction"]] = {}


def register_objective(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls

    return deco


def create_objective(name: str, params: dict) -> "ObjFunction":
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"objective {name!r} is not supported by xgboost_tpu_torch yet; "
            f"supported: {sorted(_REGISTRY)}")
    return _REGISTRY[name](params)


class ObjFunction:
    """Base objective (objective.h:28)."""

    name = ""

    def __init__(self, params: dict) -> None:
        self.params = params

    def n_groups(self) -> int:
        return 1

    def get_gradient(self, preds, labels, weights):
        """(R, K) margin, (R,) labels -> (R, K, 2) f32 gpair."""
        raise NotImplementedError

    def pred_transform(self, margin):
        return margin

    def prob_to_margin(self, prob):
        return prob

    def margin_to_prob(self, margin):
        return margin

    def init_estimation(self, labels, weights):
        """One Newton step from margin 0 (FitStump) -> base margin."""
        g = self.get_gradient(
            torch.zeros((labels.shape[0], self.n_groups()),
                        dtype=torch.float32, device=labels.device),
            labels, weights)
        G = sum_f32(g[..., 0], dim=0)
        H = sum_f32(g[..., 1], dim=0)
        return -G / torch.clamp(H, min=1e-6)

    def default_metric(self) -> str:
        return "rmse"


from . import multiclass, regression  # noqa: E402,F401  (registers objectives)
