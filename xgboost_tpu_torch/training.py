"""train() loop (port of xgboost_tpu/training.py:train without the
elastic, resume and external-memory branches; reference
python-package/xgboost/training.py:53).  It continues a model
(``xgb_model``), takes a custom objective (``obj``) and a custom metric
(``custom_metric``)."""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

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
    obj: Optional[Callable] = None,
    maximize: Optional[bool] = None,
    early_stopping_rounds: Optional[int] = None,
    evals_result: Optional[dict] = None,
    verbose_eval: Union[bool, int, None] = True,
    xgb_model: Optional[Union[str, os.PathLike, bytes, bytearray,
                              Booster]] = None,
    callbacks: Optional[Sequence[TrainingCallback]] = None,
    custom_metric: Optional[Callable] = None,
    device=None,
) -> Booster:
    """Boost ``num_boost_round`` rounds on ``dtrain``.  ``device`` as for
    :class:`Booster`: ``None`` runs on ``cuda`` (a ``Booster`` given as
    ``xgb_model`` keeps its own).  ``obj``: a custom objective, ``obj(margin,
    dtrain) -> (grad, hess)``; ``custom_metric``: ``custom_metric(margin,
    dmat) -> (name, value)``, logged beside the built-in metrics.
    ``xgb_model``: a model file's path or bytes, or a ``Booster``, to
    continue: its rounds are counted first, so round i of the continuation
    draws the seeds of round i of an uninterrupted run."""
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
    cbs = CallbackContainer(callbacks, metric=custom_metric)
    if isinstance(xgb_model, Booster):
        bst = xgb_model.copy()
        bst.set_param(params)
    elif xgb_model is not None:
        bst = Booster(params, device=device)
        bst.load_model(xgb_model)
        bst.set_param(params)
    else:
        bst = Booster(params, cache=[dtrain], device=device)
    bst = cbs.before_training(bst)
    start = bst.num_boosted_rounds()
    for i in range(start, start + num_boost_round):
        if cbs.before_iteration(bst, i, dtrain, evals):
            break
        bst.update(dtrain, i, fobj=obj)
        if cbs.after_iteration(bst, i, dtrain, evals):
            break
    bst = cbs.after_training(bst)
    if evals_result is not None:
        evals_result.update(cbs.history)
    return bst
