"""xgboost_tpu_torch: the PyTorch/CUDA port of xgboost_tpu.

A second package beside the JAX reference (``xgboost_tpu/``), with the same
module layout and names.  It runs on an NVIDIA GPU unless the caller passes
``device="cpu"``; the per-level gradient histogram runs as a hand-written
CUDA kernel (csrc/hist.cu, or csrc/hist_q.cu under
``deterministic_histogram=1``), and so does the split scan
(csrc/split_scan.cu).  The port covers dense and scipy sparse data
with numeric and categorical features (numpy codes with
``feature_types``, or a pandas frame's category columns), ``hist`` trees
grown depthwise or best-first (``grow_policy="lossguide"``) with
constraints, weighted column sampling, row subsampling and a leaf budget,
one-hot and partition categorical splits, ``reg:squarederror``,
``binary:logistic``, ``multi:softprob``/``multi:softmax`` and custom
objectives, ``num_parallel_tree`` forests, continued training, leaf-id
prediction, and the reference's JSON/UBJ model format.
"""
from __future__ import annotations

from .callback import EarlyStopping, EvaluationMonitor, TrainingCallback
from .core import Booster
from .data.dmatrix import DMatrix
from .training import train

__all__ = ["Booster", "DMatrix", "train", "TrainingCallback", "EarlyStopping",
           "EvaluationMonitor"]
