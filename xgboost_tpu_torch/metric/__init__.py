"""Evaluation metrics (port of rmse, logloss, error, merror, mlogloss and
auc from xgboost_tpu/metric/__init__.py; reference src/metric/).

Metrics take transformed predictions as host numpy arrays and reduce in
float64 on the host, as the reference's do.  rmse, logloss and error
also take the (R, K) predictions and labels of K targets.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

_REGISTRY: Dict[str, Callable] = {}


def register_metric(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def create_metric(name: str):
    """Resolve ``base[@arg]`` -> (callable, display name)."""
    base, _, param = name.partition("@")
    if base not in _REGISTRY:
        raise NotImplementedError(
            f"metric {name!r} is not supported by xgboost_tpu_torch yet; "
            f"supported: {sorted(_REGISTRY)}")
    fn = _REGISTRY[base]
    if param:
        at = float(param)
        return (lambda *a, **k: fn(*a, at=at, **k)), name
    return fn, name


def _w(labels, weights):
    return (np.ones_like(labels, dtype=np.float64) if weights is None
            else weights.astype(np.float64))


def _wmean(err, labels, weights):
    """The weighted mean; of (R, K) errors (K targets) the mean over rows
    x targets (reference metric/__init__.py:121-132)."""
    w = _w(labels if err.ndim == 1 else err[:, 0], weights)
    if err.ndim == 2:
        return float(np.sum(err * w[:, None])) / (float(np.sum(w))
                                                  * err.shape[1])
    return float(np.sum(err * w)) / float(np.sum(w))


@register_metric("rmse")
def rmse(preds, labels, weights=None, **kw):
    return float(np.sqrt(_wmean((preds - labels) ** 2, labels, weights)))


@register_metric("logloss")
def logloss(preds, labels, weights=None, **kw):
    p = np.clip(np.asarray(preds, np.float64), 1e-16, 1 - 1e-16)
    return _wmean(-(labels * np.log(p) + (1 - labels) * np.log(1 - p)),
                  labels, weights)


@register_metric("error")
def error(preds, labels, weights=None, at: float = 0.5, **kw):
    return _wmean(((preds > at) != (labels > 0.5)).astype(np.float64),
                  labels, weights)


@register_metric("merror")
def merror(preds, labels, weights=None, **kw):
    cls = preds if preds.ndim == 1 else np.argmax(preds, axis=1)
    return _wmean((cls != labels).astype(np.float64), labels, weights)


@register_metric("mlogloss")
def mlogloss(preds, labels, weights=None, **kw):
    p = np.clip(np.asarray(preds, np.float64), 1e-16, 1 - 1e-16)
    ll = -np.log(p[np.arange(len(labels)), labels.astype(np.int64)])
    return _wmean(ll, labels, weights)


@register_metric("auc")
def auc(preds, labels, weights=None, **kw):
    """Binary ROC-AUC via the rank statistic with exact tie handling
    (reference: src/metric/auc.cc BinaryROCAUC); for (R, K) class
    probabilities the mean of the K one-vs-rest AUCs (MultiClassOVR)."""
    s = np.asarray(preds, dtype=np.float64)
    if s.ndim == 2:
        return float(np.mean([
            auc(s[:, k], (labels == k).astype(np.float64), weights)
            for k in range(s.shape[1])]))
    y = labels > 0.5
    w = _w(labels, weights)
    order = np.argsort(s, kind="stable")
    ss, yy, ww = s[order], y[order], w[order]
    uniq, first = np.unique(ss, return_index=True)
    grp = np.searchsorted(uniq, ss)
    pos_w = float(np.sum(ww[yy]))
    neg_w = float(np.sum(ww[~yy]))
    # each positive scores (neg weight strictly below) + (tied neg weight)/2
    cw_neg = np.cumsum(ww * (~yy))
    below = np.concatenate([[0.0], cw_neg])[first[grp]]
    ties_neg = np.zeros(len(uniq))
    np.add.at(ties_neg, grp, ww * (~yy))
    score = below + ties_neg[grp] / 2.0
    area = float(np.sum(ww[yy] * score[yy]))
    pairs = pos_w * neg_w
    if pairs == 0:
        return 0.5
    return min(area / pairs, 1.0)
