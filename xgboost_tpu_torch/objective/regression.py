"""Regression, binary and count objectives (port of
xgboost_tpu/objective/regression.py; reference
src/objective/regression_obj.cu).

The gradients are the reference's op by op, each operation rounded to f32
as the reference's eager XLA ops round it: its transcendentals are XLA's
CPU functions (``utils/fp.py``: ``exp_f32``, ``log_f32``, ``log1p_f32``,
``sqrt_f32``), so the gradients are the reference's bits at every round on
either device.  The logistic objectives (``binary:logistic``,
``reg:logistic``, ``binary:logitraw``) share one gradient, the sigmoid's
(ops/sigmoid_cuda.py: the plain version on the CPU, the kernel K4 on the
card, one launch a round).

With ``num_target`` = K > 1 the elementwise objectives take (R, K)
margins and labels and give (R, K, 2) pairs (multi-output regression and
multi-label classification, reference regression.py:33-47); the row
weight multiplies every target of its row.  The quantile and expectile
objectives give one output column per alpha.
"""
from __future__ import annotations

import torch

from ..ops.sigmoid_cuda import logistic_gradient, sigmoid
from ..utils.fp import exp_f32, fma_f32, log1p_f32, log_f32, sqrt_f32, \
    sum_f32, true_div
from . import ObjFunction, register_objective


def _pack(grad, hess, weights):
    """(R,) or (R, K) pairs -> (R, K, 2), weighted by row."""
    if weights is not None:
        w = weights.reshape(-1, *([1] * (grad.ndim - 1)))
        grad, hess = grad * w, hess * w
    if grad.ndim == 1:
        grad, hess = grad[:, None], hess[:, None]
    return torch.stack([grad, hess], dim=-1).to(torch.float32)


def _sign(x):
    """jnp.sign: keeps a signed zero and NaN, as torch.sign does not."""
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _sorted_nan_last(a):
    """jnp.quantile's sort: every value NaN when one is."""
    a = torch.where(torch.isnan(a).any(), torch.full_like(a, float("nan")),
                    a)
    return torch.sort(a).values


def _quantile_points(n: int, q):
    """jnp.quantile's low/high indices and high weight of q (f32): q times
    f32(n) - 1, which is exact below 2**24 rows."""
    q = q * float(n - 1)
    lo, hi = torch.floor(q), torch.ceil(q)
    hw = q - lo
    lo = torch.clamp(lo, 0.0, n - 1.0).to(torch.int64)
    hi = torch.clamp(hi, 0.0, n - 1.0).to(torch.int64)
    return lo, hi, hw


def quantile_f32(a, alphas):
    """jnp.quantile(a, alphas) (linear) of a 1-D f32 tensor: the sort, the
    f32 index arithmetic and the interpolation with the multiply-add that
    XLA's CPU code fuses (its high term)."""
    s = _sorted_nan_last(a.to(torch.float32))
    lo, hi, hw = _quantile_points(a.shape[0], alphas)
    return fma_f32(s[hi], hw, s[lo] * (1.0 - hw))


def median_f32(a):
    """jnp.median(a) of a 1-D f32 tensor: (low + high) * 0.5."""
    s = _sorted_nan_last(a.to(torch.float32))
    lo, hi, _ = _quantile_points(a.shape[0], torch.full_like(s[0], 0.5))
    return (s[lo] + s[hi]) * 0.5


class _Elementwise(ObjFunction):
    def _grad(self, pred, y):  # -> (grad, hess), elementwise
        raise NotImplementedError

    def n_groups(self) -> int:
        # one output column per target (LearnerModelParam num_target)
        return max(int(self.params.get("num_target", 1) or 1), 1)

    def get_gradient(self, preds, labels, weights, iteration: int = 0):
        if self.n_groups() > 1:
            y = labels.to(torch.float32).reshape(labels.shape[0], -1)
            return _pack(*self._grad(preds, y), weights)
        pred = preds[:, 0] if preds.ndim == 2 else preds
        g, h = self._grad(pred, labels.to(torch.float32))
        return _pack(g, h, weights)


@register_objective("reg:squarederror")
class SquaredError(_Elementwise):
    def _grad(self, pred, y):
        return pred - y, torch.ones_like(pred)

    def init_estimation(self, labels, weights):
        # the sums in jnp.sum's order, so the mean is the reference's bits
        if labels.ndim == 2:  # the per-target mean (fit_stump.cc)
            w = (torch.ones(labels.shape[0], device=labels.device)
                 if weights is None else weights).to(torch.float32)
            return sum_f32(labels * w[:, None], dim=0) / torch.clamp(
                sum_f32(w), min=1e-6)
        w = torch.ones_like(labels) if weights is None else weights
        return sum_f32(labels * w) / torch.clamp(sum_f32(w), min=1e-6)


@register_objective("reg:squaredlogerror")
class SquaredLogError(_Elementwise):
    def _grad(self, pred, y):
        pred = torch.clamp(pred, min=-1 + 1e-6)
        t = log1p_f32(pred) - log1p_f32(y)
        p1 = pred + 1
        g = t / p1
        h = torch.clamp((1 - t) / (p1 * p1), min=1e-6)
        return g, h

    def default_metric(self):
        return "rmsle"


@register_objective("reg:pseudohubererror")
class PseudoHuber(_Elementwise):
    def _grad(self, pred, y):
        slope = float(self.params.get("huber_slope", 1.0))
        z = pred - y
        zs = true_div(z, slope)
        scale = 1 + zs * zs
        sqrt_s = sqrt_f32(scale)
        return z / sqrt_s, 1 / (scale * sqrt_s)

    def default_metric(self):
        return "mphe"


@register_objective("reg:absoluteerror")
class AbsoluteError(_Elementwise):
    """MAE with hess = 1; the exact leaf by the adaptive quantile refit
    (ops/adaptive.py)."""

    def _grad(self, pred, y):
        return _sign(pred - y), torch.ones_like(pred)

    def init_estimation(self, labels, weights):
        return median_f32(labels)

    def adaptive_leaf(self):
        return True

    def adaptive_alpha(self, k: int = 0) -> float:
        return 0.5

    def default_metric(self):
        return "mae"


class _LogisticBase(_Elementwise):
    def get_gradient(self, preds, labels, weights, iteration: int = 0):
        # one K4 launch on the card (ops/sigmoid_cuda.py); K targets go
        # through it flattened, each row's weight repeated K times
        spw = float(self.params.get("scale_pos_weight", 1.0))
        K = self.n_groups()
        if K > 1:
            R = preds.shape[0]
            w = None if weights is None else \
                weights.to(torch.float32).repeat_interleave(K)
            out = logistic_gradient(
                preds.reshape(-1).contiguous(),
                labels.to(torch.float32).reshape(-1).contiguous(), w, spw)
            return out.reshape(R, K, 2)
        pred = preds[:, 0] if preds.ndim == 2 else preds
        return logistic_gradient(pred, labels.to(torch.float32), weights,
                                 spw)

    def pred_transform(self, margin):
        return sigmoid(margin)

    def prob_to_margin(self, prob):
        p = torch.clamp(prob, 1e-7, 1 - 1e-7)
        return log_f32(p / (1 - p))

    def margin_to_prob(self, margin):
        return sigmoid(margin)

    def default_metric(self):
        return "logloss"


@register_objective("binary:logistic")
class BinaryLogistic(_LogisticBase):
    def task_is_classification(self):
        return True


@register_objective("reg:logistic")
class RegLogistic(_LogisticBase):
    def default_metric(self):
        return "rmse"


@register_objective("binary:logitraw")
class LogitRaw(_LogisticBase):
    def task_is_classification(self):
        return True

    def pred_transform(self, margin):
        return margin

    def default_metric(self):
        return "auc"


@register_objective("binary:hinge")
class Hinge(_Elementwise):
    def task_is_classification(self):
        return True

    def _grad(self, pred, y):
        yy = 2.0 * y - 1.0  # {0, 1} -> {-1, 1}
        active = yy * pred < 1.0
        return (torch.where(active, -yy, torch.zeros_like(yy)),
                torch.where(active, torch.ones_like(yy),
                            torch.full_like(yy, 1e-16)))

    def pred_transform(self, margin):
        return (margin > 0).to(torch.float32)

    def default_metric(self):
        return "error"


class _ExpFamily(_Elementwise):
    """Log-link count and positive objectives: the margin is log(mu)."""

    def pred_transform(self, margin):
        return exp_f32(margin)

    def prob_to_margin(self, prob):
        return log_f32(torch.clamp(prob, min=1e-16))

    def margin_to_prob(self, margin):
        return exp_f32(margin)


@register_objective("count:poisson")
class Poisson(_ExpFamily):
    def _grad(self, pred, y):
        # the hessian's max_delta_step defaults to 0.7 here
        # (regression_obj.cu PoissonRegression); the tree's stays its own
        mds = float(self.params.get("max_delta_step", 0.7)) or 0.7
        mu = exp_f32(pred)
        # exp(max_delta_step) in XLA's f32, a constant taken on the host
        cap = float(exp_f32(torch.tensor(mds, dtype=torch.float32)))
        return mu - y, mu * cap

    def default_metric(self):
        return "poisson-nloglik"


@register_objective("reg:gamma")
class Gamma(_ExpFamily):
    def _grad(self, pred, y):
        mu = exp_f32(pred)
        return 1.0 - y / mu, y / mu

    def default_metric(self):
        return "gamma-nloglik"


@register_objective("reg:tweedie")
class Tweedie(_ExpFamily):
    def _grad(self, pred, y):
        rho = float(self.params.get("tweedie_variance_power", 1.5))
        a = y * exp_f32((1 - rho) * pred)
        b = exp_f32((2 - rho) * pred)
        return -a + b, -(1 - rho) * a + (2 - rho) * b

    def default_metric(self):
        rho = float(self.params.get("tweedie_variance_power", 1.5))
        return f"tweedie-nloglik@{rho}"


def _alpha_list(a):
    """A number, a list, or the string of a list ("[0.1, 0.9]")."""
    if isinstance(a, str):
        a = [float(v) for v in a.strip("[]() ").replace(",", " ").split()]
    if not isinstance(a, (list, tuple)):
        a = [a]
    return [float(x) for x in a]


class _MultiAlpha(ObjFunction):
    """Shared base of quantile and expectile: one output column per alpha
    (quantile_obj.cu, regression_obj.cu ExpectileRegression Targets())."""

    _alpha_param = "quantile_alpha"

    def _alphas(self):
        return _alpha_list(self.params.get(self._alpha_param, 0.5))

    def _alpha_tensor(self, like):
        return torch.tensor(self._alphas(), dtype=torch.float32,
                            device=like.device)

    def n_groups(self) -> int:
        return len(self._alphas())

    def default_metric(self):
        a = self._alphas()
        return self._metric_base if len(a) > 1 \
            else f"{self._metric_base}@{a[0]}"


@register_objective("reg:expectileerror")
class Expectile(_MultiAlpha):
    """Asymmetric squared loss: weight 1 - alpha over the label, alpha under
    it; grad = w * diff and hess = w, without the analytic factor 2, as the
    reference's kernel (regression_obj.cu:464-466)."""

    _alpha_param = "expectile_alpha"
    _metric_base = "expectile"

    def _alphas(self):
        # quantile_alpha is an alias where expectile_alpha is not given
        if self._alpha_param not in self.params \
                and "quantile_alpha" in self.params:
            return _alpha_list(self.params["quantile_alpha"])
        return super()._alphas()

    def get_gradient(self, preds, labels, weights, iteration: int = 0):
        alphas = self._alpha_tensor(preds)
        diff = preds - labels.to(torch.float32)[:, None]  # (R, Q)
        w = torch.where(diff >= 0, 1.0 - alphas[None, :], alphas[None, :])
        return _pack(w * diff, w, weights)

    def init_estimation(self, labels, weights):
        w = torch.ones_like(labels) if weights is None else weights
        mean = sum_f32(labels * w) / torch.clamp(sum_f32(w), min=1e-6)
        return mean.expand(len(self._alphas())).to(torch.float32)


@register_objective("reg:quantileerror")
class QuantileError(_MultiAlpha):
    """Pinball loss over one or many alphas (all levels one multi-output
    model, quantile_obj.cu); the exact per-leaf quantile by the adaptive
    refit."""

    _metric_base = "quantile"

    def get_gradient(self, preds, labels, weights, iteration: int = 0):
        alphas = self._alpha_tensor(preds)
        y = labels.to(torch.float32)[:, None]
        # dL/dpred: 1 - alpha over the label, -alpha under it
        g = torch.where(preds >= y, 1.0 - alphas[None, :], -alphas[None, :])
        return _pack(g, torch.ones_like(g), weights)

    def init_estimation(self, labels, weights):
        return quantile_f32(labels, self._alpha_tensor(labels))

    def adaptive_leaf(self):
        return True

    def adaptive_alpha(self, k: int = 0) -> float:
        return self._alphas()[k]
