"""Evaluation metrics (port of xgboost_tpu/metric/__init__.py; reference
src/metric/).

Metrics take transformed predictions as host numpy arrays and reduce in
float64 on the host, as the reference's do.  The elementwise ones also
take the (R, K) predictions and labels of K targets; quantile and
expectile take the ``alphas`` of a multi-alpha model, the survival
metrics the rows' bounds (``y_lower``, ``y_upper``) and AFT's ``dist``
and ``sigma``, mphe the ``slope``: the booster passes them as keywords
(core.py eval_set).  The ranking metrics (ndcg, map, pre, and aucpr's
per-group branch) take the query groups as ``group_ptr``; from 64 groups
up, ndcg, map and pre run the segment sums of ``device_rank.py`` on the
booster's ``device``, below it the loop over groups (``use_device_rank``
forces either).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

_REGISTRY: Dict[str, Callable] = {}

# rank metrics with the reference's trailing-minus convention (degenerate
# groups score 0 instead of 1, ranking_utils.cc ParseMetricName)
_MINUS_METRICS = {"ndcg", "map", "pre"}
# the loop over groups wins below this group count
_MIN_DEVICE_GROUPS = 64


def register_metric(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def create_metric(name: str):
    """Resolve ``base[@n][-]`` -> (callable, display name) (reference
    ranking_utils.cc:138 ParseMetricName): ``@n`` is the metric's ``at``
    (the ranking metrics' truncation), a trailing ``-`` scores degenerate
    query groups 0 instead of 1 (``ndcg@5-``, ``map-``).  The callable of
    such a name carries the metric's own function as ``__wrapped__``,
    whose signature the booster reads."""
    base, minus, arg = name, False, None
    if "@" in name:
        base, param = name.split("@", 1)
        if param.endswith("-"):
            minus, param = True, param[:-1]
        if not param:
            raise ValueError(f"Invalid metric name {name!r}: '@' needs a "
                             "numeric truncation/threshold")
        arg = float(param)
    elif base.endswith("-") and base[:-1] in _MINUS_METRICS:
        minus, base = True, base[:-1]
    if base not in _REGISTRY:
        raise NotImplementedError(
            f"metric {name!r} is not supported by xgboost_tpu_torch yet; "
            f"supported: {sorted(_REGISTRY)}")
    if minus and base not in _MINUS_METRICS:
        raise ValueError(f"Unknown metric {name!r}: the '-' suffix applies "
                         f"only to {sorted(_MINUS_METRICS)}")
    fn = _REGISTRY[base]
    if arg is None and not minus:
        return fn, name
    extra = {} if arg is None else {"at": arg}
    if minus:
        extra["minus"] = True
    wrapper = lambda *a, **k: fn(*a, **{**extra, **k})  # noqa: E731
    wrapper.__wrapped__ = fn
    return wrapper, name


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
def auc(preds, labels, weights=None, group_ptr=None, **kw):
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
def aucpr(preds, labels, weights=None, group_ptr=None, **kw):
    """Area under the precision-recall curve (auc.cc BinaryPRAUC); with
    query groups the weighted mean of the groups' PR-AUCs over the groups
    with both classes (auc.cc RankingAUC), weights a group's or a row's."""
    s = np.asarray(preds, dtype=np.float64)
    y = labels > 0.5
    if group_ptr is not None and len(group_ptr) > 1:
        n_groups = len(group_ptr) - 1
        group_w = weights is not None and len(weights) == n_groups
        w = None if group_w else _w(labels, weights)
        total, valid = 0.0, 0.0
        for g in range(n_groups):
            lo, hi = group_ptr[g], group_ptr[g + 1]
            w_rows = np.ones(hi - lo, np.float64) if group_w else w[lo:hi]
            area, pairs = _pr_area(s[lo:hi], y[lo:hi], w_rows)
            if pairs > 0:
                wg = float(weights[g]) if group_w else 1.0
                total += area * wg
                valid += wg
        return total / valid if valid > 0 else 0.0
    area, pairs = _pr_area(s, y, _w(labels, weights))
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


# ---------------------------------------------------------------- ranking
def _use_device_rank(group_ptr, preds, kw) -> bool:
    """The segment sums for 64 groups or more, the loop below;
    ``use_device_rank`` forces either (reference metric/__init__.py:55)."""
    forced = kw.get("use_device_rank")
    if forced is not None:
        return bool(forced)
    return np.ndim(preds) == 1 and len(group_ptr) - 1 >= _MIN_DEVICE_GROUPS


def _group_weight(weights, g, lo, n_groups):
    """A group's weight as the reference keeps it (an f32 value, so that
    the sum of the weights is an f32 sum, as the reference's)."""
    if weights is None:
        return 1.0
    return weights[g if len(weights) == n_groups else lo]


def _dcg_at(rel, k):
    rel = rel[:k]
    return np.sum((2.0**rel - 1.0) / np.log2(np.arange(2, len(rel) + 2)))


@register_metric("ndcg")
def ndcg(preds, labels, weights=None, group_ptr=None, at: float = 0,
         minus: bool = False, **kw):
    """NDCG with exponential gain, truncated at ``at`` (rank_metric.cc
    NDCG); groups without a relevant doc score 1, or 0 under ``minus``;
    the group-weighted mean."""
    if group_ptr is None:
        group_ptr = np.array([0, len(labels)])
    k = int(at) if at else None
    if _use_device_rank(group_ptr, preds, kw):
        from .device_rank import ndcg_pair

        n, d = ndcg_pair(preds, labels, group_ptr, weights, k or 0, minus,
                         kw.get("device"))
        return n / d if d > 0 else 1.0
    n_groups = len(group_ptr) - 1
    vals, ws = [], []
    for g in range(n_groups):
        lo, hi = group_ptr[g], group_ptr[g + 1]
        if hi <= lo:
            continue
        y = labels[lo:hi]
        kk = k or (hi - lo)
        order = np.argsort(-preds[lo:hi], kind="stable")
        dcg = _dcg_at(y[order], kk)
        idcg = _dcg_at(np.sort(y)[::-1], kk)
        vals.append(dcg / idcg if idcg > 0 else (0.0 if minus else 1.0))
        ws.append(_group_weight(weights, g, lo, n_groups))
    num = float(np.dot(vals, ws)) if vals else 0.0
    den = float(np.sum(ws)) if ws else 0.0
    return num / den if den > 0 else 1.0


@register_metric("map")
def map_metric(preds, labels, weights=None, group_ptr=None, at: float = 0,
               minus: bool = False, **kw):
    """Mean average precision, truncated at ``at`` (rank_metric.cc MAP);
    groups without a relevant doc score 1, or 0 under ``minus``; the
    group-weighted mean."""
    if group_ptr is None:
        group_ptr = np.array([0, len(labels)])
    k = int(at) if at else None
    if _use_device_rank(group_ptr, preds, kw):
        from .device_rank import map_pair

        n, d = map_pair(preds, labels, group_ptr, weights, k or 0, minus,
                        kw.get("device"))
        return n / d if d > 0 else 0.0
    n_groups = len(group_ptr) - 1
    vals, ws = [], []
    for g in range(n_groups):
        lo, hi = group_ptr[g], group_ptr[g + 1]
        if hi <= lo:
            continue
        y = (labels[lo:hi] > 0).astype(np.float64)
        order = np.argsort(-preds[lo:hi], kind="stable")
        yo = y[order][: k or (hi - lo)]
        hits = np.cumsum(yo)
        npos = yo.sum()
        vals.append(float(np.sum(yo * hits / np.arange(1, len(yo) + 1))
                          / npos) if npos > 0 else (0.0 if minus else 1.0))
        ws.append(_group_weight(weights, g, lo, n_groups))
    num = float(np.dot(vals, ws)) if vals else 0.0
    den = float(np.sum(ws)) if ws else 0.0
    return num / den if den > 0 else 0.0


@register_metric("pre")
def precision_at(preds, labels, weights=None, group_ptr=None, at: float = 0,
                 **kw):
    """Precision@k (rank_metric.cc EvalPrecision, k = ``at`` or 10): per
    group the label mass of the top k docs over k (the group's size where
    smaller); the group-weighted mean."""
    if group_ptr is None:
        group_ptr = np.array([0, len(labels)])
    k = int(at) if at else 10
    if _use_device_rank(group_ptr, preds, kw):
        from .device_rank import precision_pair

        n, d = precision_pair(preds, labels, group_ptr, weights, k,
                              kw.get("device"))
        return n / d if d > 0 else 0.0
    n_groups = len(group_ptr) - 1
    vals, ws = [], []
    for g in range(n_groups):
        lo, hi = group_ptr[g], group_ptr[g + 1]
        if hi <= lo:
            continue
        order = np.argsort(-preds[lo:hi], kind="stable")
        n = min(k, hi - lo)
        wg = _group_weight(weights, g, lo, n_groups)
        vals.append(float(np.sum(labels[lo:hi][order[:n]])) * wg / n)
        ws.append(wg)
    s, wsum = float(np.sum(vals)), float(np.sum(ws))
    return s / wsum if wsum > 0 else 0.0
