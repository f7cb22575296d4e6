"""xgboost_tpu_torch: the PyTorch/CUDA port of xgboost_tpu.

A second package beside the JAX reference (``xgboost_tpu/``), with the same
module layout and names.  It runs on an NVIDIA GPU unless the caller passes
``device="cpu"``; the per-level gradient histogram runs as a hand-written
CUDA kernel (csrc/hist.cu, or csrc/hist_q.cu under
``deterministic_histogram=1``).  The port covers dense data, ``hist``
trees grown depthwise with constraints, column sampling and a leaf budget,
``reg:squarederror`` and ``binary:logistic``, and the reference's JSON/UBJ
model format.
"""
from __future__ import annotations

from .callback import EarlyStopping, EvaluationMonitor, TrainingCallback
from .core import Booster
from .data.dmatrix import DMatrix
from .training import train

__all__ = ["Booster", "DMatrix", "train", "TrainingCallback", "EarlyStopping",
           "EvaluationMonitor"]
