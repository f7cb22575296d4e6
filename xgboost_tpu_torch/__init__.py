"""xgboost_tpu_torch: the PyTorch/CUDA port of xgboost_tpu.

A second package beside the JAX reference (``xgboost_tpu/``), with the same
module layout and names.  It runs on an NVIDIA GPU unless the caller passes
``device="cpu"`` (the reference's ``gpu``, ``tpu`` and ``cuda[:N]`` all name
the card); the per-level gradient histogram runs as a hand-written CUDA
kernel (csrc/hist.cu, or csrc/hist_q.cu under ``deterministic_histogram=1``),
and so do the split scan (csrc/split_scan.cu), the logistic gradient
(csrc/sigmoid.cu) and the top-k LambdaMART gradients (csrc/lambdarank.cu).

The port covers dense and scipy sparse data, pandas frames and Arrow
tables, with numeric and categorical features, query groups and survival
bounds, in memory or out of core (``DataIter``, ``ExtMemQuantileDMatrix``,
``SparsePageDMatrix``: pages kept on the host and streamed to the card at
every tree level); ``hist`` trees grown depthwise
or best-first with constraints, sampling and a leaf budget, multi-output
and vector-leaf trees, ``num_parallel_tree`` forests; every regression,
binary, count, survival, ranking and multiclass objective of the reference
with its metrics, and custom objectives and metrics; and the public surface
around them: ``train`` and ``cv`` with the reference's callbacks, the
``Booster`` (model files, ``save_config``/``load_config``, ``serialize``
and pickling, round slicing, ``get_score``, ``inplace_predict``), the
scikit-learn estimators and the plotting functions, both imported on first
use.
"""
from __future__ import annotations

from .callback import (EarlyStopping, EvaluationMonitor, LearningRateScheduler,
                       TrainingCallback, TrainingCheckPoint)
from .config import config_context, get_config, set_config
from .core import Booster
from .data.dmatrix import DMatrix, MetaInfo, QuantileDMatrix
from .data.ellpack import EllpackPage
from .data.extmem import (DataIter, ExtMemConfig, ExtMemQuantileDMatrix,
                          SparsePageDMatrix)
from .data.quantile import HistogramCuts
from .training import cv, train

__all__ = [
    "Booster",
    "DMatrix",
    "QuantileDMatrix",
    "DataIter",
    "ExtMemQuantileDMatrix",
    "SparsePageDMatrix",
    "ExtMemConfig",
    "HistogramCuts",
    "EllpackPage",
    "MetaInfo",
    "train",
    "cv",
    "config_context",
    "set_config",
    "get_config",
    "TrainingCallback",
    "EarlyStopping",
    "EvaluationMonitor",
    "LearningRateScheduler",
    "TrainingCheckPoint",
    "plot_importance",
    "plot_tree",
    "to_graphviz",
    "XGBModel",
    "XGBClassifier",
    "XGBRegressor",
    "XGBRanker",
    "XGBRFClassifier",
    "XGBRFRegressor",
]


def __getattr__(name):  # the estimators and plotting, on first use
    if name in ("XGBModel", "XGBClassifier", "XGBRegressor", "XGBRanker",
                "XGBRFClassifier", "XGBRFRegressor"):
        from . import sklearn as _sk

        return getattr(_sk, name)
    if name in ("plot_importance", "plot_tree", "to_graphviz"):
        from . import plotting as _pl

        return getattr(_pl, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
