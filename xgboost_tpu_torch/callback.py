"""Training callbacks (port of xgboost_tpu/callback.py; reference:
python-package/xgboost/callback.py).

``TrainingCallback`` subclasses get before/after-iteration hooks with an
``evals_log`` history; ``CallbackContainer`` drives them from ``train()``
and ``cv()``.  Under ``cv()`` a score is the folds' ``(mean, std)``.
"""
from __future__ import annotations

import collections
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

_Score = Union[float, Tuple[float, float]]
_EvalsLog = Dict[str, Dict[str, List[_Score]]]


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

    # a stateful callback returns its state, JSON-serialisable, and takes
    # it back, so that a resumed run decides as an uninterrupted one would
    def state_dict(self) -> Optional[dict]:
        return None

    def load_state(self, state: dict) -> None:
        pass


class CallbackContainer:
    """Runs a list of callbacks (reference: callback.py:149).  ``metric``:
    a custom metric, passed to ``eval_set``; ``is_cv``: driven by ``cv()``,
    which fills the history with the folds' ``(mean, std)`` itself."""

    def __init__(self, callbacks: Sequence[TrainingCallback], metric=None,
                 is_cv: bool = False):
        self.callbacks = list(callbacks)
        self.metric = metric
        self.is_cv = is_cv
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
            self.update_history(model.eval_set(evals, epoch,
                                               feval=self.metric))
        return any(cb.after_iteration(model, epoch, self.history)
                   for cb in self.callbacks)


class LearningRateScheduler(TrainingCallback):
    """Sets ``eta`` before each round (reference: callback.py:272):
    ``learning_rates`` is a function of the round or a sequence a round."""

    def __init__(self, learning_rates: Union[Callable[[int], float],
                                             Sequence[float]]):
        if callable(learning_rates):
            self.fn = learning_rates
        else:
            rates = list(learning_rates)
            self.fn = lambda epoch: rates[epoch]

    def before_iteration(self, model, epoch, evals_log) -> bool:
        model.set_param("eta", self.fn(epoch))
        return False


class EarlyStopping(TrainingCallback):
    """(reference: callback.py:311) Stop when the watched metric has not
    improved by more than ``min_delta`` for ``rounds`` rounds; under cv
    the watched score is the folds' mean.  ``save_best``: end training
    with the rounds up to the best one (not under cv)."""

    _MAXIMIZE_METRICS = ("auc", "aucpr", "map", "ndcg", "pre")

    def __init__(self, rounds: int, metric_name: Optional[str] = None,
                 data_name: Optional[str] = None,
                 maximize: Optional[bool] = None, save_best: bool = False,
                 min_delta: float = 0.0):
        self.rounds = rounds
        self.metric_name = metric_name
        self.data_name = data_name
        self.maximize = maximize
        self.save_best = save_best
        self.min_delta = min_delta
        self.current_rounds = 0
        self.best_scores: List[float] = []

    def _is_maximize(self, metric: str) -> bool:
        if self.maximize is not None:
            return self.maximize
        return metric.split("@")[0].split(":")[0] in self._MAXIMIZE_METRICS

    def after_iteration(self, model, epoch, evals_log) -> bool:
        if not evals_log:
            return False
        log = evals_log[self.data_name or list(evals_log.keys())[-1]]
        metric = self.metric_name or list(log.keys())[-1]
        score = log[metric][-1]
        if isinstance(score, (tuple, list)):  # cv's (mean, std)
            score = score[0]
        if not self.best_scores:
            improved = True
        elif self._is_maximize(metric):
            improved = score > self.best_scores[-1] + self.min_delta
        else:
            improved = score < self.best_scores[-1] - self.min_delta
        if improved:
            self.best_scores.append(score)
            self.current_rounds = 0
            model.best_iteration = epoch
            model.best_score = score
            model.set_attr(best_iteration=str(epoch), best_score=str(score))
        else:
            self.current_rounds += 1
        return self.current_rounds >= self.rounds

    def after_training(self, model):
        if self.save_best and model.best_iteration is not None \
                and not getattr(model, "_is_cv", False):
            model = model[: model.best_iteration + 1]
        return model

    def state_dict(self) -> dict:
        return {"best_scores": list(self.best_scores),
                "current_rounds": int(self.current_rounds)}

    def load_state(self, state: dict) -> None:
        self.best_scores = [float(s) for s in state.get("best_scores", [])]
        self.current_rounds = int(state.get("current_rounds", 0))


class EvaluationMonitor(TrainingCallback):
    """Log eval results every ``period`` rounds (reference: callback.py:511);
    ``rank``: across ranks only that rank prints (the reference's
    ``printer_rank``); ``show_stdv``: a cv score as ``mean+std``;
    ``logger`` receives each line (default: print)."""

    def __init__(self, rank: int = 0, period: int = 1,
                 show_stdv: bool = False,
                 logger: Optional[Callable[[str], None]] = None):
        self.printer_rank = int(rank)
        self.period = max(period, 1)
        self.show_stdv = show_stdv
        self.logger = logger or print
        self._latest: Optional[str] = None

    def _fmt_metric(self, data: str, metric: str, score: _Score) -> str:
        if isinstance(score, (tuple, list)) and len(score) == 2:
            if self.show_stdv:
                return f"\t{data}-{metric}:{score[0]:.5f}+{score[1]:.5f}"
            score = score[0]
        return f"\t{data}-{metric}:{score:.5f}"

    def after_iteration(self, model, epoch, evals_log) -> bool:
        if not evals_log:
            return False
        from . import collective

        if collective.get_rank() != self.printer_rank:
            return False
        msg = f"[{epoch}]"
        for data, metrics in evals_log.items():
            for metric, hist in metrics.items():
                msg += self._fmt_metric(data, metric, hist[-1])
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


class TrainingCheckPoint(TrainingCallback):
    """Save the model every ``interval`` rounds into ``directory``, as
    ``<name>_<round>.json`` or, with ``as_pickle``, ``.pkl`` (reference:
    callback.py:586)."""

    def __init__(self, directory: Union[str, os.PathLike], name: str = "model",
                 as_pickle: bool = False, interval: int = 100):
        self.dir = os.fspath(directory)
        self.name = name
        self.interval = max(interval, 1)
        self.as_pickle = as_pickle
        os.makedirs(self.dir, exist_ok=True)

    def after_iteration(self, model, epoch, evals_log) -> bool:
        if epoch % self.interval == 0:
            path = os.path.join(self.dir, f"{self.name}_{epoch}")
            if self.as_pickle:
                with open(path + ".pkl", "wb") as fh:
                    pickle.dump(model, fh)
            else:
                model.save_model(path + ".json")
        return False
