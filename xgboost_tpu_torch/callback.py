"""Training callbacks (port of TrainingCallback, CallbackContainer,
EarlyStopping and EvaluationMonitor from xgboost_tpu/callback.py;
reference: python-package/xgboost/callback.py)."""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence

_EvalsLog = Dict[str, Dict[str, List[float]]]


class TrainingCallback:
    """(reference: callback.py:51)"""

    def before_training(self, model):
        return model

    def after_training(self, model):
        return model

    def before_iteration(self, model, epoch: int, evals_log: _EvalsLog) -> bool:
        return False

    def after_iteration(self, model, epoch: int, evals_log: _EvalsLog) -> bool:
        """Return True to stop training."""
        return False


class CallbackContainer:
    """Runs a list of callbacks (reference: callback.py:149)."""

    def __init__(self, callbacks: Sequence[TrainingCallback]):
        self.callbacks = list(callbacks)
        self.history: _EvalsLog = collections.OrderedDict()

    def before_training(self, model):
        for cb in self.callbacks:
            model = cb.before_training(model)
        return model

    def after_training(self, model):
        for cb in self.callbacks:
            model = cb.after_training(model)
        return model

    def before_iteration(self, model, epoch, dtrain, evals) -> bool:
        return any(cb.before_iteration(model, epoch, self.history)
                   for cb in self.callbacks)

    def update_history(self, eval_str: str) -> None:
        # parse "[i]\tname-metric:v\t..." into history
        for p in eval_str.strip().split("\t")[1:]:
            key, v = p.rsplit(":", 1)
            name, metric = key.split("-", 1)
            self.history.setdefault(name, collections.OrderedDict()) \
                .setdefault(metric, []).append(float(v))

    def after_iteration(self, model, epoch, dtrain, evals) -> bool:
        if evals:
            self.update_history(model.eval_set(evals, epoch))
        return any(cb.after_iteration(model, epoch, self.history)
                   for cb in self.callbacks)


class EarlyStopping(TrainingCallback):
    """(reference: callback.py:311) — stop when the watched metric stops
    improving for ``rounds`` rounds."""

    _MAXIMIZE_METRICS = ("auc", "aucpr", "map", "ndcg", "pre")

    def __init__(self, rounds: int, metric_name: Optional[str] = None,
                 data_name: Optional[str] = None,
                 maximize: Optional[bool] = None):
        self.rounds = rounds
        self.metric_name = metric_name
        self.data_name = data_name
        self.maximize = maximize
        self.current_rounds = 0
        self.best_scores: List[float] = []

    def _is_maximize(self, metric: str) -> bool:
        if self.maximize is not None:
            return self.maximize
        return metric.split("@")[0] in self._MAXIMIZE_METRICS

    def after_iteration(self, model, epoch, evals_log) -> bool:
        if not evals_log:
            return False
        log = evals_log[self.data_name or list(evals_log.keys())[-1]]
        metric = self.metric_name or list(log.keys())[-1]
        score = log[metric][-1]
        if not self.best_scores:
            improved = True
        elif self._is_maximize(metric):
            improved = score > self.best_scores[-1]
        else:
            improved = score < self.best_scores[-1]
        if improved:
            self.best_scores.append(score)
            self.current_rounds = 0
            model.best_iteration = epoch
            model.best_score = score
            model.set_attr(best_iteration=str(epoch), best_score=str(score))
        else:
            self.current_rounds += 1
        return self.current_rounds >= self.rounds


class EvaluationMonitor(TrainingCallback):
    """Log eval results every ``period`` rounds (reference: callback.py:511);
    ``logger`` receives each line (default: print)."""

    def __init__(self, period: int = 1,
                 logger: Optional[Callable[[str], None]] = None):
        self.period = max(period, 1)
        self.logger = logger or print
        self._latest: Optional[str] = None

    def after_iteration(self, model, epoch, evals_log) -> bool:
        if not evals_log:
            return False
        msg = f"[{epoch}]"
        for data, metrics in evals_log.items():
            for metric, hist in metrics.items():
                msg += f"\t{data}-{metric}:{hist[-1]:.5f}"
        if epoch % self.period:
            self._latest = msg  # flushed after training
        else:
            self.logger(msg)
            self._latest = None
        return False

    def after_training(self, model):
        if self._latest is not None:
            self.logger(self._latest)
            self._latest = None
        return model
