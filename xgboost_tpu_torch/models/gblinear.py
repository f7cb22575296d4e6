"""gblinear, the linear booster (port of xgboost_tpu/models/gblinear.py;
reference src/gbm/gblinear.cc and src/linear/: coordinate descent
updater_coordinate.cc:100, the shotgun updater updater_shotgun.cc:96, the
feature selectors of coordinate_common.h).

Both updaters run one CoordinateDelta chain: the bias step, then per
coordinate two dot products, the soft-thresholded weight step and the
gradient refresh.  ``coord_descent`` walks the features cyclically by
default; ``shotgun`` shuffles them every round by default and is the
reference's shotgun at one thread (its lock-free parallel form is
run-dependent by design).  ``feature_selector`` picks the order:

- ``cyclic``: 0, 1, ..., F-1;
- ``shuffle``: a permutation each round, from ``seed`` and the round;
- ``random``: F coordinates drawn with replacement each round;
- ``thrifty``: the ``top_k`` largest univariate weight changes from the
  round's starting gradients (host f64), in decreasing order;
- ``greedy``: ``top_k`` steps, each taking the coordinate whose weight
  change is largest against the current gradient (the lowest index on a
  tie; a step whose best change is zero changes nothing).

The cyclic, shuffle and random orders are numpy draws on the host
(``SeedSequence``), the reference's bits; the chain itself is PyTorch
operations on the tensors' device, with no read back to the host:
greedy's argmax stays a tensor.  The data is the zero-filled matrix
transposed, (F, R) and contiguous, so that a coordinate reads one
contiguous row.  Missing values count as zeros, as in the reference.
The chain's dot products and sums are not in XLA's order: weights agree
with the reference within 1e-5 relative, 1e-6 absolute, not bitwise.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

SELECTORS = ("cyclic", "shuffle", "random", "greedy", "thrifty")


def _soft_threshold(x, alpha: float):
    return torch.sign(x) * torch.clamp(torch.abs(x) - alpha, min=0.0)


def f32_matmul(a, b):
    """a @ b in full f32: TF32 stays off whatever the caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def selector_order(selector: str, n_features: int, round_idx: int,
                   seed: int) -> np.ndarray:
    """The coordinate order of one round for the gradient-free selectors
    (coordinate_common.h FeatureSelector::NextFeature), host numpy: the
    same (selector, seed, round) gives the same order everywhere."""
    if selector not in SELECTORS:
        raise ValueError(
            f"unknown feature_selector {selector!r}; expected one of "
            f"{SELECTORS}")
    if selector in ("greedy", "thrifty"):
        raise ValueError(
            f"feature_selector={selector!r} is gain-ranked — its order "
            "depends on the gradients, not just (round, seed); use "
            "thrifty_order() / linear_update_greedy()")
    if selector == "cyclic":
        return np.arange(n_features, dtype=np.int32)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed & 0x7FFFFFFF, round_idx]))
    if selector == "shuffle":
        return rng.permutation(n_features).astype(np.int32)
    return rng.integers(0, n_features, size=n_features).astype(np.int32)


def effective_top_k(top_k: int, n_features: int) -> int:
    """coordinate_common.h: ``top_k == 0`` means every feature."""
    k = int(top_k)
    return n_features if k <= 0 else min(k, n_features)


def thrifty_order(Xz: np.ndarray, grad: np.ndarray, hess: np.ndarray,
                  weights: np.ndarray, *, top_k: int, alpha: float,
                  lambda_: float) -> np.ndarray:
    """ThriftyFeatureSelector: features ranked by their univariate weight
    change against the round's starting gradients, the ``top_k`` largest
    in decreasing order; host f64 (the reference sums in double), a stable
    sort, so equal magnitudes keep feature order."""
    Xh = np.asarray(Xz, np.float64)
    g = np.asarray(grad, np.float64)
    h = np.asarray(hess, np.float64)
    w = np.asarray(weights, np.float64)
    num = Xh.T @ g + lambda_ * w
    den = (Xh * Xh).T @ h + lambda_
    dw = np.sign(num) * np.maximum(np.abs(num) - alpha, 0.0) / den
    k = effective_top_k(top_k, Xh.shape[1])
    return np.argsort(-np.abs(dw), kind="stable")[:k].astype(np.int32)


def _bias_step(grad, hess, eta: float):
    """The bias step first (the updaters' bias update): its change and the
    gradients refreshed for it."""
    db = -torch.sum(grad) / torch.clamp(torch.sum(hess), min=1e-6) * eta
    return db, grad + hess * db


def linear_update(XT, grad, hess, weights, bias, order, *, eta: float,
                  lambda_: float, alpha: float) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """One round of one output group: XT (F, R) f32 zero-filled, grad and
    hess (R,), weights (F,), bias 0-d, ``order`` the host coordinate
    order.  Returns (weights, bias), new tensors."""
    h = hess
    db, g = _bias_step(grad, h, eta)
    w = weights.clone()
    for j in np.asarray(order).tolist():
        xj = XT[j]
        num = torch.dot(xj, g) + lambda_ * w[j]
        den = torch.dot(xj * xj, h) + lambda_
        dw = -_soft_threshold(num, alpha) / den * eta
        g = g + h * xj * dw
        w[j] += dw
    return w, bias + db


def linear_update_greedy(XT, grad, hess, weights, bias, *, steps: int,
                         eta: float, lambda_: float, alpha: float):
    """One round with the greedy selector: the bias step, then ``steps``
    picks of the coordinate with the largest weight change against the
    current gradient, each applied and the gradient refreshed
    (GreedyFeatureSelector interleaves NextFeature with UpdateFeature).
    Returns (weights, bias, order), ``order`` a tensor holding -1 at steps
    where every remaining change was zero."""
    h = hess
    db, g = _bias_step(grad, h, eta)
    den = f32_matmul(XT * XT, h) + lambda_  # h is fixed all round
    w = weights.clone()
    used = torch.zeros(XT.shape[0], dtype=torch.bool, device=XT.device)
    picked = []
    for _ in range(steps):
        num = f32_matmul(XT, g) + lambda_ * w
        dwv = -_soft_threshold(num, alpha) / den * eta
        mag = torch.where(used, 0.0, torch.abs(dwv))
        j = torch.argmax(mag).reshape(1)  # the first of equal maxima
        live = mag[j] > 0
        dw = torch.where(live, dwv[j], 0.0)
        g = g + h * XT[j][0] * dw
        w.index_add_(0, j, dw)
        used.index_fill_(0, j, True)
        picked.append(torch.where(live, j, -1))
    order = (torch.cat(picked) if picked
             else torch.zeros(0, dtype=torch.long, device=XT.device))
    return w, bias + db, order


def linear_predict(XT, weights, bias):
    """(R, K) margins X @ W + b from the zero-filled (F, R) transpose."""
    return f32_matmul(XT.T, weights) + bias[None, :]
