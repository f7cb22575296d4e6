"""train() loop (port of xgboost_tpu/training.py:train without the
elastic, resume and external-memory branches; reference
python-package/xgboost/training.py:53)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

from .callback import (CallbackContainer, EarlyStopping, EvaluationMonitor,
                       TrainingCallback)
from .core import Booster
from .data.dmatrix import DMatrix

__all__ = ["train"]


def train(
    params: Dict[str, Any],
    dtrain: DMatrix,
    num_boost_round: int = 10,
    *,
    evals: Optional[Sequence[Tuple[DMatrix, str]]] = None,
    maximize: Optional[bool] = None,
    early_stopping_rounds: Optional[int] = None,
    evals_result: Optional[dict] = None,
    verbose_eval: Union[bool, int, None] = True,
    callbacks: Optional[Sequence[TrainingCallback]] = None,
    device=None,
) -> Booster:
    """Boost ``num_boost_round`` trees on ``dtrain``.  ``device`` as for
    :class:`Booster`: ``None`` runs on ``cuda``."""
    callbacks = list(callbacks) if callbacks else []
    evals = list(evals) if evals else []
    if early_stopping_rounds is not None:
        if not evals:
            raise ValueError(
                "Must have at least 1 validation dataset for early stopping.")
        callbacks.append(EarlyStopping(rounds=early_stopping_rounds,
                                       maximize=maximize))
    if verbose_eval:
        period = 1 if verbose_eval is True else int(verbose_eval)
        callbacks.append(EvaluationMonitor(period=period))
    cbs = CallbackContainer(callbacks)
    bst = cbs.before_training(Booster(params, cache=[dtrain], device=device))
    for i in range(num_boost_round):
        if cbs.before_iteration(bst, i, dtrain, evals):
            break
        bst.update(dtrain, i)
        if cbs.after_iteration(bst, i, dtrain, evals):
            break
    bst = cbs.after_training(bst)
    if evals_result is not None:
        evals_result.update(cbs.history)
    return bst
