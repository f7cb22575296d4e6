"""train() and cv() (port of xgboost_tpu/training.py without the
elastic and resume branches of train; across ranks, train runs in each
worker inside a ``collective.CommunicatorContext``, an ``ExtMemConfig``
builds the rank's pages there, and ``EvaluationMonitor`` prints on rank 0;
reference
python-package/xgboost/training.py:53, :435).  train continues a model
(``xgb_model``), takes a custom objective (``obj``) and a custom metric
(``custom_metric``); cv builds the reference's folds (plain, stratified or
given) and updates one booster a fold, in fold order."""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .callback import (CallbackContainer, EarlyStopping, EvaluationMonitor,
                       TrainingCallback)
from .core import Booster
from .data.dmatrix import DMatrix

__all__ = ["train", "cv"]


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
    draws the seeds of round i of an uninterrupted run.  Under
    ``process_type="update"`` the rounds are the model's own, from 0.
    ``dtrain`` may be an ``ExtMemConfig``: the rank's pages are built from
    it on the booster's device, and its evals are used where ``evals`` is
    empty."""
    from .data.extmem import ExtMemConfig

    callbacks = list(callbacks) if callbacks else []
    evals = list(evals) if evals else []
    if isinstance(dtrain, ExtMemConfig):
        # this rank's pages (reference training.py:187-199); the config's
        # evals apply where the call gives none
        dtrain, extmem_evals = dtrain.build(
            device=device if device is not None else params.get("device"))
        if not evals:
            evals = extmem_evals
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
    end = start + num_boost_round
    if bst.process_type == "update":
        # the rounds index the model's existing rounds, from the first
        # (reference training.py:304-315)
        start, end = 0, num_boost_round
    for i in range(start, end):
        if cbs.before_iteration(bst, i, dtrain, evals):
            break
        bst.update(dtrain, i, fobj=obj)
        if cbs.after_iteration(bst, i, dtrain, evals):
            break
    bst = cbs.after_training(bst)
    if evals_result is not None:
        evals_result.update(cbs.history)
    return bst


class CVPack:
    """One fold: its train and test matrices and their booster (reference
    training.py:212)."""

    def __init__(self, dtrain: DMatrix, dtest: DMatrix, params, device=None):
        self.dtrain = dtrain
        self.dtest = dtest
        self.watchlist = [(dtrain, "train"), (dtest, "test")]
        self.bst = Booster(params, cache=[dtrain, dtest], device=device)

    def update(self, iteration: int, fobj) -> None:
        self.bst.update(self.dtrain, iteration, fobj)

    def eval(self, iteration: int, feval) -> str:
        return self.bst.eval_set(self.watchlist, iteration, feval)


def _make_folds(dall: DMatrix, nfold: int, params, seed: int, shuffle: bool,
                stratified: bool, folds, device=None) -> List[CVPack]:
    """The reference's folds (training.py:365), drawn from
    ``np.random.default_rng(seed)`` in its order, so the index sets are
    the reference's: a row's fold is its position in the (shuffled, or
    label-sorted where stratified) order modulo ``nfold``; ``folds``, a
    sequence of (train index, test index) pairs, overrides."""
    R = dall.num_row()
    rng = np.random.default_rng(seed)
    if folds is not None:
        splits = [(np.asarray(tr), np.asarray(te)) for tr, te in folds]
    else:
        idx = np.arange(R)
        label = dall.get_label()
        if stratified:
            if shuffle:
                # random within equal-label blocks, stratified across folds
                order = np.lexsort((rng.random(R), label))
            else:
                order = np.argsort(label, kind="stable")
            fold_of = np.empty(R, np.int64)
            fold_of[order] = np.arange(R) % nfold
        else:
            if shuffle:
                idx = rng.permutation(R)
            fold_of = np.empty(R, np.int64)
            fold_of[idx] = np.arange(R) % nfold
        splits = [(np.nonzero(fold_of != k)[0], np.nonzero(fold_of == k)[0])
                  for k in range(nfold)]
    return [CVPack(dall.slice(tr), dall.slice(te), params, device)
            for tr, te in splits]


class _PackedBooster:
    """The folds' boosters as one model for the callbacks (reference
    training.py, _PackedBooster): attributes and parameters go to every
    fold; ``save_best`` does not slice it."""

    _is_cv = True

    def __init__(self, packs: List[CVPack]):
        self.packs = packs
        self.best_iteration: Optional[int] = None
        self.best_score: Optional[float] = None

    def set_attr(self, **kw) -> None:
        for p in self.packs:
            p.bst.set_attr(**kw)

    def set_param(self, params, value=None) -> None:
        for p in self.packs:
            p.bst.set_param(params, value)


def cv(
    params: Dict[str, Any],
    dtrain: DMatrix,
    num_boost_round: int = 10,
    nfold: int = 3,
    *,
    stratified: bool = False,
    folds=None,
    metrics: Sequence[str] = (),
    obj: Optional[Callable] = None,
    maximize: Optional[bool] = None,
    early_stopping_rounds: Optional[int] = None,
    as_pandas: bool = True,
    verbose_eval: Union[bool, int, None] = None,
    show_stdv: bool = True,
    seed: int = 0,
    callbacks: Optional[Sequence[TrainingCallback]] = None,
    shuffle: bool = True,
    custom_metric: Optional[Callable] = None,
    device=None,
):
    """K-fold cross-validation (reference training.py:435): for each round,
    each fold's booster takes one update and evaluates its train and test
    rows, in fold order; returns ``{"<data>-<metric>-mean": [...],
    "...-std": [...]}`` a round, as a pandas frame with ``as_pandas``
    where pandas imports.  ``device`` as for :func:`train`: every fold's
    booster runs there, its slices on ``dtrain``'s device.  Callbacks see
    each score as the folds' ``(mean, std)``."""
    params = dict(params)
    if metrics:
        metrics = list(metrics)
        params["eval_metric"] = metrics if len(metrics) > 1 else metrics[0]
    packs = _make_folds(dtrain, nfold, params, seed, shuffle, stratified,
                        folds, device)
    callbacks = list(callbacks) if callbacks else []
    if early_stopping_rounds is not None:
        callbacks.append(EarlyStopping(rounds=early_stopping_rounds,
                                       maximize=maximize))
    if verbose_eval:
        callbacks.append(EvaluationMonitor(
            period=1 if verbose_eval is True else int(verbose_eval),
            show_stdv=show_stdv))
    cbs = CallbackContainer(callbacks, is_cv=True)
    agg = cbs.before_training(_PackedBooster(packs))
    results: Dict[str, List[float]] = {}
    for i in range(num_boost_round):
        if cbs.before_iteration(agg, i, dtrain, []):
            break
        fold_metrics: Dict[str, List[float]] = {}
        for p in packs:
            p.update(i, obj)
            for part in p.eval(i, custom_metric).strip().split("\t")[1:]:
                key, v = part.rsplit(":", 1)
                fold_metrics.setdefault(key, []).append(float(v))
        for key, vals in fold_metrics.items():
            mean, std = float(np.mean(vals)), float(np.std(vals))
            results.setdefault(f"{key}-mean", []).append(mean)
            results.setdefault(f"{key}-std", []).append(std)
            data, metric = key.split("-", 1)
            cbs.history.setdefault(data, {}).setdefault(metric, []).append(
                (mean, std))
        if any(cb.after_iteration(agg, i, cbs.history)
               for cb in cbs.callbacks):
            break
    cbs.after_training(agg)
    if as_pandas:
        try:
            import pandas as pd
        except ImportError:
            return results
        return pd.DataFrame.from_dict(results)
    return results
