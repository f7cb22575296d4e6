"""Survival objectives: AFT and Cox proportional hazards (port of
xgboost_tpu/objective/survival.py; reference src/objective/aft_obj.cu,
src/common/survival_util.h, regression_obj.cu CoxRegression).

Censoring follows the reference:
 - AFT: per row [label_lower_bound, label_upper_bound]; equal bounds are
   uncensored, an infinite upper bound right-censored, a lower bound of 0
   left-censored.  The margin models log(time).
 - Cox: the label's sign carries the event (y > 0 an event at time y,
   y < 0 right-censored at -y).

The reference takes AFT's gradient with ``jax.grad`` and its hessian with a
``jax.jvp`` of that gradient, each primitive an eager XLA op rounded to
f32.  This module writes the same gradient out op by op, in the order of
the reference's backward pass (cotangents of a value used twice summed
last use first), and evaluates it on dual numbers (``_D``) whose tangents
follow JAX's JVP rule of each primitive, so that the gradient and the
hessian are the reference's bits on either device.
"""
from __future__ import annotations

import math

import torch

from ..utils.fp import cumsum_f32, erf_f32, exp_f32, fma_f32, ftz, \
    log_f32, sigmoid_f32
from . import ObjFunction, register_objective

_SQRT2PI = math.sqrt(2.0 * math.pi)
_SQRT2 = math.sqrt(2.0)
_TWO_OVER_SQRTPI = 2.0 / math.sqrt(math.pi)
_EPS = 1e-12


class _D:
    """A value with an optional tangent (None: JAX's symbolic zero), each
    flushed below the smallest normal f32 as XLA's CPU programs flush
    every result."""

    __slots__ = ("p", "t")

    def __init__(self, p, t=None):
        self.p, self.t = ftz(p), None if t is None else ftz(t)


def _pt(x):
    return (x.p, x.t) if isinstance(x, _D) else (x, None)


def _add(a, b):
    (ap, at), (bp, bt) = _pt(a), _pt(b)
    t = bt if at is None else at if bt is None else at + bt
    return _D(ap + bp, t)


def _sub(a, b):
    (ap, at), (bp, bt) = _pt(a), _pt(b)
    t = (None if at is None and bt is None else -bt if at is None
         else at if bt is None else at - bt)
    return _D(ap - bp, t)


def _neg(a):
    ap, at = _pt(a)
    return _D(-ap, None if at is None else -at)


def _mul(a, b, fused=False):
    """a * b; ``fused``: a jnp-level product, whose JVP XLA compiles as
    one program, fusing the first term's multiply into the sum."""
    (ap, at), (bp, bt) = _pt(a), _pt(b)
    if fused and at is not None and bt is not None:
        return _D(ap * bp, fma_f32(at, bp, ap * bt))
    tx = None if at is None else at * bp
    ty = None if bt is None else ap * bt
    t = ty if tx is None else tx if ty is None else tx + ty
    return _D(ap * bp, t)


def _div(a, b, fused=False):
    """a / b; ``fused`` as for _mul (the y term's last multiply fused). A
    number divisor divides as a device tensor (utils/fp.py true_div)."""
    if not isinstance(b, (_D, torch.Tensor)):
        b = _pt(a)[0].new_full((), b)
    (ap, at), (bp, bt) = _pt(a), _pt(b)
    tx = None if at is None else at / bp
    if fused and at is not None and bt is not None:
        return _D(ap / bp, fma_f32(-bt * ap, 1.0 / (bp * bp), tx))
    # d(x/y)/dy: mul(mul(neg(g), x), integer_pow(y, -2))
    ty = None if bt is None else (-bt * ap) * (1.0 / (bp * bp))
    t = ty if tx is None else tx if ty is None else tx + ty
    return _D(ap / bp, t)


def _exp(a):
    ap, at = _pt(a)
    out = exp_f32(ap)
    return _D(out, None if at is None else at * out)


def _log(a):
    ap, at = _pt(a)
    return _D(log_f32(ap), None if at is None else at / ap)


def _square(a):
    ap, at = _pt(a)
    return _D(ap * ap, None if at is None else at * (2.0 * ap))


def _erf(a):
    ap, at = _pt(a)
    if at is None:
        return _D(erf_f32(ap))
    e = exp_f32(-(ap * ap))
    return _D(erf_f32(ap), _TWO_OVER_SQRTPI * (at * e))


def _abs(a):
    ap, at = _pt(a)
    return _D(ap.abs(), None if at is None
              else torch.where(ap >= 0, at, -at))


def _logistic(a):
    ap, at = _pt(a)
    out = sigmoid_f32(ap)
    return _D(out, None if at is None else at * (out * (1.0 - out)))


def _scale(a, m):
    """a times a mask of 0, 1/2 or 1 (a clip or max's transpose or JVP)."""
    ap, at = _pt(a)
    return _D(ap * m, None if at is None else at * m)


def _select(c, a, b):
    """where(c, a, b); a missing tangent beside a present one is zero."""
    (ap, at), (bp, bt) = _pt(a), _pt(b)
    if at is None and bt is None:
        t = None
    else:
        at = torch.zeros_like(bt) if at is None else at
        bt = torch.zeros_like(at) if bt is None else bt
        t = torch.where(c, at, bt)
    return _D(torch.where(c, ap, bp), t)


def _balanced_eq(x, z, y):
    """The weight of x in z = max(x, y) or min(x, y): 1 where it is z,
    1/2 where y is z too, else 0."""
    one = torch.ones_like(z)
    return torch.where(x == z, one, 0.0 * one) / torch.where(
        y == z, 2.0 * one, one)


def _max_const(a, c):
    """max(a, c) for a constant c, and the mask of its transpose."""
    ap, at = _pt(a)
    z = torch.clamp(ap, min=c)
    m = _balanced_eq(ap, z, torch.full_like(z, c))
    return _D(z, None if at is None else at * m), m


def _clip(a, lo, hi):
    """jnp.clip(a, lo, hi) as max then min; the masks (max, min) of its
    transpose, which multiplies by the min's mask first."""
    ap, at = _pt(a)
    k = torch.clamp(ap, min=lo)
    m1 = _balanced_eq(ap, k, torch.full_like(k, lo))
    v = torch.clamp(k, max=hi)
    m2 = _balanced_eq(k, v, torch.full_like(v, hi))
    return _D(v, None if at is None else (at * m1) * m2), m1, m2


def _clip_t(ct, m1, m2):
    return _scale(_scale(ct, m2), m1)


# Each distribution: pdf(z) -> (value, backward), cdf(z) -> (value,
# backward).  A pdf's backward takes the cotangent of the value and the
# cotangent of z so far, and adds its terms to it in the reference's
# order; a cdf's backward gives its cotangent of z.

def _normal_pdf(z):
    cv = _mul(-0.5, z)
    cw = _mul(cv, z, fused=True)
    cx = _exp(cw)
    val = _div(cx, _SQRT2PI)

    def back(ct, acc):
        fp = _mul(_div(ct, _SQRT2PI), cx)
        acc = _add(acc, _mul(cv, fp))
        return _add(acc, _mul(-0.5, _mul(fp, z)))

    return val, back


def _normal_cdf(z):
    x = _div(z, _SQRT2)
    e = _exp(_neg(_square(x)))
    val = _mul(0.5, _add(1.0, _erf(x)))

    def back(ct):
        return _div(_mul(_mul(_TWO_OVER_SQRTPI, _mul(0.5, ct)), e), _SQRT2)

    return val, back


def _logistic_pdf(z):
    nonneg = _pt(z)[0] >= 0
    cy = _exp(_neg(_abs(z)))
    cz = _add(1.0, cy)
    da = _mul(cz, cz)
    dc = _mul(2.0, cz)
    de = _D(*_ipow_m2(da))
    val = _div(cy, da, fused=True)

    def back(ct, acc):
        fj = _div(ct, da)
        fi = _neg(_mul(_mul(ct, de), cy))
        fm = _mul(_add(fj, _mul(fi, dc)), cy)
        fn = _neg(fm)
        zero = torch.zeros_like(_pt(fn)[0])
        acc = _add(acc, _select(nonneg, fn, zero))
        return _add(acc, _neg(_select(nonneg, zero, fn)))

    return val, back


def _ipow_m2(a):
    """integer_pow(a, -2) = 1 / (a * a), and its JVP
    mul(g, mul(-2, integer_pow(a, -3))) with a^-3 = 1 / (a * (a * a))."""
    ap, at = _pt(a)
    out = 1.0 / (ap * ap)
    return out, None if at is None else at * (-2.0 * (1.0 / (ap * (ap * ap))))


def _logistic_cdf(z):
    du = _logistic(z)
    dw = _mul(du, _sub(1.0, du), fused=True)

    def back(ct):
        return _mul(ct, dw)

    return du, back


def _extreme_pdf(z):
    zc, m1, m2 = _clip(z, -700.0, 30.0)
    ec = _exp(zc)
    ee = _exp(_neg(ec))
    val = _mul(ec, ee, fused=True)

    def back(ct, acc):
        gx = _mul(ec, ct)
        gy = _mul(ct, ee)
        hb = _add(gy, _neg(_mul(gx, ee)))
        return _add(acc, _clip_t(_mul(hb, ec), m1, m2))

    return val, back


def _extreme_cdf(z):
    zc, m1, m2 = _clip(z, -700.0, 30.0)
    ey = _exp(zc)
    fa = _exp(_neg(ey))
    val = _sub(1.0, fa)

    def back(ct):
        return _clip_t(_mul(_neg(_mul(_neg(ct), fa)), ey), m1, m2)

    return val, back


_DISTS = {
    "normal": (_normal_pdf, _normal_cdf),
    "logistic": (_logistic_pdf, _logistic_cdf),
    "extreme": (_extreme_pdf, _extreme_cdf),
}


def _bound_terms(pred, y_lower, y_upper, sigma):
    hi_finite = torch.isfinite(y_upper)
    lo_pos = y_lower > 0
    one = torch.ones_like(y_lower)
    log_lo = log_f32(torch.clamp(torch.where(lo_pos, y_lower, one),
                                 min=_EPS))
    log_hi = log_f32(torch.clamp(torch.where(hi_finite, y_upper, one),
                                 min=_EPS))
    z_lo, lo_m1, lo_m2 = _clip(_div(_sub(log_lo, pred), sigma), -15.0, 15.0)
    z_hi, hi_m1, hi_m2 = _clip(_div(_sub(log_hi, pred), sigma), -15.0, 15.0)
    unc = hi_finite & ((y_upper - y_lower).abs() < _EPS)
    return hi_finite, lo_pos, unc, (z_lo, lo_m1, lo_m2), \
        (z_hi, hi_m1, hi_m2)


def _aft(pred, y_lower, y_upper, dist: str, sigma: float, grad: bool):
    """The AFT loss of each row and, with ``grad``, its derivative in
    pred (a _D: the tangent is the derivative's own derivative where pred
    carries one)."""
    pdf, cdf = _DISTS[dist]
    hi_finite, lo_pos, unc, (z_lo, lo_m1, lo_m2), (z_hi, hi_m1, hi_m2) = \
        _bound_terms(pred, y_lower, y_upper, sigma)
    one = torch.ones_like(y_lower)
    zero = torch.zeros_like(y_lower)
    # uncensored: -log(pdf(z) / (sigma * t)); censored: -log(cdf(hi) -
    # cdf(lo))
    pv, pdf_back = pdf(z_lo)
    pmax, p_m = _max_const(pv, _EPS)
    ll_unc = _sub(_log(pmax), log_f32(sigma * torch.clamp(y_lower, min=_EPS)))
    hv, hi_back = cdf(z_hi)
    hi_cdf = _select(hi_finite, hv, one)
    lv, lo_back = cdf(z_lo)
    lo_cdf = _select(lo_pos, lv, zero)
    cmax, c_m = _max_const(_sub(hi_cdf, lo_cdf), _EPS)
    ll_cen = _log(cmax)
    if not grad:
        return -torch.where(unc, _pt(ll_unc)[0], _pt(ll_cen)[0])
    # the backward pass from a cotangent of one for every row's loss
    ct_unc = torch.where(unc, -one, zero)
    ct_cen = torch.where(unc, zero, -one)
    ey = _mul(_div(ct_cen, cmax), c_m)
    ct_lo = lo_back(_select(lo_pos, _neg(ey), zero))
    ct_hi = hi_back(_select(hi_finite, ey, zero))
    ct_lo = pdf_back(_mul(_div(ct_unc, pmax), p_m), ct_lo)
    g_hi = _neg(_div(_clip_t(ct_hi, hi_m1, hi_m2), sigma))
    g_lo = _neg(_div(_clip_t(ct_lo, lo_m1, lo_m2), sigma))
    return _add(g_hi, g_lo)


def aft_neg_loglik(pred, y_lower, y_upper, dist: str, sigma: float):
    """Per-row AFT negative log likelihood (survival_util.h AFTLoss), in
    the reference's f32 operations."""
    return _aft(pred, y_lower, y_upper, dist, sigma, grad=False)


@register_objective("survival:aft")
class AFT(ObjFunction):
    """Accelerated failure time (reference: aft_obj.cu AFTObj)."""

    def __init__(self, params):
        super().__init__(params)
        self.dist = str(params.get("aft_loss_distribution", "normal"))
        if self.dist not in _DISTS:
            raise ValueError(f"unknown aft_loss_distribution {self.dist!r}")
        self.sigma = float(params.get("aft_loss_distribution_scale", 1.0))
        self._bounds = None

    def set_bounds(self, lower, upper):
        """The rows' bounds (tensors on the margin's device, padded with
        the cache's rows); no upper bound is right-censored."""
        self._bounds = (lower, torch.full_like(lower, float("inf"))
                        if upper is None else upper)

    def _get_bounds(self, labels):
        if self._bounds is None:
            y = labels.to(torch.float32)
            return y, y
        return self._bounds

    def get_gradient(self, preds, labels, weights, iteration: int = 0):
        pred = preds[:, 0] if preds.ndim == 2 else preds
        lo, hi = self._get_bounds(labels)
        d = _aft(_D(pred, torch.ones_like(pred)), lo, hi, self.dist,
                 self.sigma, grad=True)
        g, hess = d.p, torch.clamp(d.t.abs(), min=1e-6)
        if weights is not None:
            g, hess = g * weights, hess * weights
        return torch.stack([g, hess], dim=-1)[:, None, :].to(torch.float32)

    def pred_transform(self, margin):
        return exp_f32(margin)

    def prob_to_margin(self, prob):
        return log_f32(torch.clamp(prob, min=1e-16))

    def margin_to_prob(self, margin):
        return exp_f32(margin)

    def init_estimation(self, labels, weights):
        return torch.zeros((), dtype=torch.float32, device=labels.device)

    def default_metric(self):
        return "aft-nloglik"


@register_objective("survival:cox")
class Cox(ObjFunction):
    """Cox partial likelihood (reference: regression_obj.cu CoxRegression)
    with Breslow ties: the members of a tie group share its risk
    denominator, and the group's whole event mass enters each member's
    sums.  Two sorts and three cumulative sums in ``jnp.cumsum``'s order
    (utils/fp.py cumsum_f32), on the margin's device."""

    def get_gradient(self, preds, labels, weights, iteration: int = 0):
        pred = preds[:, 0] if preds.ndim == 2 else preds
        y = labels.to(torch.float32)
        t = y.abs()
        event = (y > 0).to(torch.float32)
        w = torch.ones_like(t) if weights is None else weights
        order = torch.argsort(t, stable=True)
        inv = torch.argsort(order, stable=True)
        r = exp_f32(pred - pred.max()) * w
        r_sorted = r[order]
        ts = t[order]
        revcum = cumsum_f32(r_sorted.flip(0)).flip(0)
        g_start = torch.searchsorted(ts, ts, right=False)
        g_end = torch.searchsorted(ts, ts, right=True)
        risk = torch.clamp(revcum[g_start], min=_EPS)
        ev_sorted = (event * w)[order]
        a = ev_sorted / risk
        b = ev_sorted / (risk * risk)
        acc_a = cumsum_f32(a)[g_end - 1]
        acc_b = cumsum_f32(b)[g_end - 1]
        grad_sorted = r_sorted * acc_a - ev_sorted
        hess_sorted = r_sorted * acc_a - (r_sorted * r_sorted) * acc_b
        grad = grad_sorted[inv]
        hess = torch.clamp(hess_sorted[inv], min=1e-6)
        return torch.stack([grad, hess], dim=-1)[:, None, :].to(
            torch.float32)

    def pred_transform(self, margin):
        return exp_f32(margin)  # the hazard ratio

    def init_estimation(self, labels, weights):
        return torch.zeros((), dtype=torch.float32, device=labels.device)

    def default_metric(self):
        return "cox-nloglik"
