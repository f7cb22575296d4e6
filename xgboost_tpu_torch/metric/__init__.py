"""Evaluation metrics (port of xgboost_tpu/metric/__init__.py but for the
ranking metrics ndcg, map and pre; reference src/metric/).

Metrics take transformed predictions as host numpy arrays and reduce in
float64 on the host, as the reference's do.  The elementwise ones also
take the (R, K) predictions and labels of K targets; quantile and
expectile take the ``alphas`` of a multi-alpha model, the survival
metrics the rows' bounds (``y_lower``, ``y_upper``) and AFT's ``dist``
and ``sigma``, mphe the ``slope``: the booster passes them as keywords
(core.py eval_set).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

_REGISTRY: Dict[str, Callable] = {}


def register_metric(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def create_metric(name: str):
    """Resolve ``base[@arg]`` -> (callable, display name); the callable of
    ``base@arg`` carries the metric's own function as ``__wrapped__``, whose
    signature the booster reads."""
    base, _, param = name.partition("@")
    if base not in _REGISTRY:
        raise NotImplementedError(
            f"metric {name!r} is not supported by xgboost_tpu_torch yet; "
            f"supported: {sorted(_REGISTRY)}")
    fn = _REGISTRY[base]
    if param:
        at = float(param)
        wrapper = lambda *a, **k: fn(*a, **{"at": at, **k})  # noqa: E731
        wrapper.__wrapped__ = fn
        return wrapper, name
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


@register_metric("rmsle")
def rmsle(preds, labels, weights=None, **kw):
    return float(np.sqrt(_wmean(
        (np.log1p(np.maximum(preds, 0)) - np.log1p(labels)) ** 2, labels,
        weights)))


@register_metric("mae")
def mae(preds, labels, weights=None, **kw):
    return _wmean(np.abs(preds - labels), labels, weights)


@register_metric("mape")
def mape(preds, labels, weights=None, **kw):
    return _wmean(np.abs((labels - preds) / np.maximum(np.abs(labels),
                                                       1e-10)),
                  labels, weights)


@register_metric("mphe")
def mphe(preds, labels, weights=None, slope: float = 1.0, **kw):
    z = (preds - labels) / slope
    return _wmean(slope**2 * (np.sqrt(1 + z**2) - 1), labels, weights)


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


@register_metric("poisson-nloglik")
def poisson_nloglik(preds, labels, weights=None, **kw):
    p = np.maximum(preds, 1e-16)
    # log((y + 1)!) of the labels' dtype, taken in f64 and rounded once
    y1 = np.asarray(labels + 1.0)
    lg = torch.special.gammaln(torch.from_numpy(
        y1.astype(np.float64))).numpy().astype(y1.dtype)
    return _wmean(p - labels * np.log(p) + lg, labels, weights)


@register_metric("gamma-nloglik")
def gamma_nloglik(preds, labels, weights=None, **kw):
    # elementwise_metric.cu GammaNLoglik (shape psi = 1)
    p = np.maximum(preds, 1e-16)
    y = np.maximum(labels, 1e-16)
    return _wmean(y / p + np.log(p), labels, weights)


@register_metric("gamma-deviance")
def gamma_deviance(preds, labels, weights=None, **kw):
    p = np.maximum(preds, 1e-16)
    y = np.maximum(labels, 1e-16)
    return _wmean(2 * (np.log(p / y) + y / p - 1), labels, weights)


@register_metric("tweedie-nloglik")
def tweedie_nloglik(preds, labels, weights=None, at: float = 1.5, **kw):
    rho = at
    p = np.maximum(preds, 1e-16)
    a = labels * np.power(p, 1 - rho) / (1 - rho)
    b = np.power(p, 2 - rho) / (2 - rho)
    return _wmean(-a + b, labels, weights)


def _pick_alpha_col(p, alphas, at):
    """Of multi-alpha predictions: the trained column of an explicit
    ``metric@level``, or all columns (the mean over levels)."""
    if at is None:
        return p, np.asarray(alphas, np.float64)[None, :]
    a = np.asarray(alphas, np.float64)
    k = int(np.argmin(np.abs(a - at)))
    if abs(a[k] - at) > 1e-6:
        raise ValueError(
            f"metric level {at} was not trained; trained levels: "
            f"{a.tolist()}")
    return p[:, k], float(a[k])


@register_metric("quantile")
def quantile_loss(preds, labels, weights=None, at=None, alphas=None, **kw):
    """Pinball loss; (R, Q) predictions with ``alphas``: the mean over rows
    x levels, or the requested level's column (quantile_obj.cu)."""
    p = np.asarray(preds, np.float64)
    if p.ndim == 2 and alphas is not None:
        p, a = _pick_alpha_col(p, alphas, at)
        if p.ndim == 2:
            u = labels[:, None] - p
            return _wmean(np.where(u >= 0, a * u, (a - 1) * u), labels,
                          weights)
        at = a
    at = 0.5 if at is None else at
    u = labels - p
    return _wmean(np.where(u >= 0, at * u, (at - 1) * u), labels, weights)


@register_metric("expectile")
def expectile_loss(preds, labels, weights=None, alphas=None, at=None, **kw):
    """|alpha - I(diff < 0)| * diff^2 (elementwise_metric.cu
    ExpectileError), over rows (x levels) or one level's column."""
    p = np.asarray(preds, np.float64)
    if p.ndim == 2 and alphas is not None:
        p, a = _pick_alpha_col(p, alphas, at)
        if p.ndim == 2:
            diff = p - labels[:, None]
            return _wmean(np.where(diff >= 0, 1.0 - a, a) * diff ** 2,
                          labels, weights)
        at = a
    at = 0.5 if at is None else at
    diff = p - labels
    return _wmean(np.where(diff >= 0, 1.0 - at, at) * diff ** 2, labels,
                  weights)


@register_metric("ams")
def ams(preds, labels, weights=None, at: float = 1.0, **kw):
    """Approximate median significance (rank_metric.cc EvalAMS): the top
    ``at`` fraction of rows by prediction, sqrt(2((s+b+br)ln(1+s/(b+br))
    - s)) with br = 10; at the whole set, the best prefix over the
    distinct thresholds."""
    n = len(labels)
    w = _w(labels, weights)
    order = np.argsort(-np.asarray(preds, np.float64), kind="stable")
    ntop = int(at * n) or n
    br = 10.0
    if ntop >= n:
        ps = np.cumsum(np.where(labels[order] > 0.5, w[order], 0.0))
        bs = np.cumsum(np.where(labels[order] > 0.5, 0.0, w[order]))
        sp = np.asarray(preds, np.float64)[order]
        distinct = np.zeros(len(sp), bool)
        if len(sp):
            distinct[:-1] = sp[:-1] != sp[1:]
        cand = np.nonzero(distinct)[0]
        if len(cand) == 0:
            return 0.0
        return float(np.max(np.sqrt(2 * (
            (ps[cand] + bs[cand] + br) * np.log1p(ps[cand] / (bs[cand] + br))
            - ps[cand]))))
    top = order[: min(ntop, n - 1)]
    pos = labels[top] > 0.5
    s_tp = float(np.sum(w[top][pos]))
    b_fp = float(np.sum(w[top][~pos]))
    return float(np.sqrt(2 * ((s_tp + b_fp + br)
                              * np.log1p(s_tp / (b_fp + br)) - s_tp)))


def _pr_area(s, y, w):
    """PR-AUC of one score/label slice, and its pair mass; (0, 0) when
    one class is missing."""
    if len(s) == 0:
        return 0.0, 0.0
    order = np.argsort(-s, kind="stable")
    yy, ww = y[order], w[order]
    tp = np.cumsum(ww * yy)
    fp = np.cumsum(ww * ~yy)
    pos, neg = float(tp[-1]), float(fp[-1])
    if pos <= 0 or neg <= 0:
        return 0.0, 0.0
    precision = tp / np.maximum(tp + fp, 1e-16)
    recall = tp / pos
    return float(np.trapezoid(precision, recall)), pos * neg


@register_metric("aucpr")
def aucpr(preds, labels, weights=None, **kw):
    """Area under the precision-recall curve (auc.cc BinaryPRAUC)."""
    s = np.asarray(preds, dtype=np.float64)
    area, pairs = _pr_area(s, labels > 0.5, _w(labels, weights))
    # the reference's pair-weighted merge of one shard
    return area * pairs / pairs if pairs > 0 else 0.0


@register_metric("aft-nloglik")
def aft_nloglik(preds, labels, weights=None, y_lower=None, y_upper=None,
                dist="normal", sigma=1.0, device="cpu", **kw):
    """(survival_metric.cu AFTNegLogLik) the predictions are times,
    exp(margin); the loss is the objective's, in its f32 operations, on
    ``device`` (the booster's), reduced on the host."""
    from ..objective.survival import aft_neg_loglik

    if y_lower is None:
        y_lower = y_upper = labels
    m = np.log(np.maximum(np.asarray(preds, np.float64), 1e-16))

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    ll = aft_neg_loglik(f32(m), f32(y_lower), f32(y_upper), dist,
                        sigma).cpu().numpy()
    return _wmean(ll.astype(np.float64), labels, weights)


@register_metric("interval-regression-accuracy")
def interval_accuracy(preds, labels, weights=None, y_lower=None,
                      y_upper=None, **kw):
    """The share of predictions inside the label interval
    (survival_metric.cu IntervalRegressionAccuracy)."""
    if y_lower is None:
        y_lower = y_upper = labels
    p = np.asarray(preds, np.float64)
    ok = (p >= y_lower) & (p <= np.where(np.isfinite(y_upper), y_upper,
                                         np.inf))
    return _wmean(ok.astype(np.float64), labels, weights)


@register_metric("cox-nloglik")
def cox_nloglik(preds, labels, weights=None, **kw):
    """Negative partial log likelihood over the events (rank_metric.cc
    CoxNLoglik, Breslow ties); the predictions are hazard ratios."""
    t = np.abs(labels).astype(np.float64)
    event = labels > 0
    r = np.asarray(preds, np.float64)
    order = np.argsort(t, kind="stable")
    r_s, ev_s, ts = r[order], event[order], t[order]
    revcum = np.cumsum(r_s[::-1])[::-1]
    risk = revcum[np.searchsorted(ts, ts, side="left")]
    ll = np.sum(np.log(np.maximum(r_s, 1e-16))[ev_s]
                - np.log(np.maximum(risk, 1e-16))[ev_s])
    return float(-ll) / max(float(ev_s.sum()), 1.0)
