"""Dense in-memory DMatrix (port of the dense path of
xgboost_tpu/data/dmatrix.py).

Holds the raw matrix (f32, NaN = missing) as a tensor on its device, the
labels and metadata on the host, and lazily builds the binned EllpackPage on
the first training touch.  Cuts come from the device sketch for a matrix
on the card and from the exact host grid for one on the CPU, as the
reference chooses per backend; bins are computed on the device.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .ellpack import EllpackPage, build_ellpack
from .quantile import sketch_dense


def _normalize_dense(arr: np.ndarray, missing: float) -> np.ndarray:
    """1-D promotion + custom-missing -> NaN."""
    if arr.ndim == 1:
        arr = arr[:, None]
    if not (missing is None or np.isnan(missing)):
        arr = np.where(arr == missing, np.float32(np.nan), arr)
    return arr


class DMatrix:
    """In-memory dense data matrix (reference: data.h:549).

    ``device``: where the matrix is staged; ``None`` means ``cuda``.
    ``feature_weights``: (F,) non-negative weights of the column sampler's
    draws (colsample_*), as in the reference.
    """

    def __init__(
        self,
        data: Any,
        label: Any = None,
        *,
        weight: Any = None,
        base_margin: Any = None,
        missing: float = np.nan,
        feature_names: Optional[Sequence[str]] = None,
        feature_types: Optional[Sequence[str]] = None,
        feature_weights: Any = None,
        enable_categorical: bool = False,
        device=None,
    ) -> None:
        if enable_categorical or (feature_types and "c" in feature_types):
            raise NotImplementedError(
                "categorical data is not supported by xgboost_tpu_torch yet")
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        if hasattr(data, "tocsr"):
            raise NotImplementedError(
                "sparse input is not supported by xgboost_tpu_torch yet")
        self._host = _normalize_dense(np.asarray(data, dtype=np.float32),
                                      missing)
        self.device = resolve_device(device)
        self.X = torch.from_numpy(self._host).to(self.device)
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.base_margin: Optional[np.ndarray] = None
        if label is not None:
            self.set_label(label)
        if weight is not None:
            self.set_weight(weight)
        if base_margin is not None:
            self.set_base_margin(base_margin)
        self.feature_names: Optional[List[str]] = (
            list(feature_names) if feature_names else None)
        self.feature_types: Optional[List[str]] = (
            list(feature_types) if feature_types else None)
        # per-feature column-sampling weights (f32, as the reference keeps
        # them); validated where the column sampler reads them
        self.feature_weights: Optional[np.ndarray] = (
            None if feature_weights is None
            else np.asarray(feature_weights, np.float32))
        self._ellpack: Optional[EllpackPage] = None
        self._max_bin_built: Optional[int] = None

    def _rows(self, arr: Any, name: str) -> np.ndarray:
        a = np.asarray(arr, dtype=np.float32)
        if a.shape[0] != self.num_row():
            raise ValueError(f"{name} has {a.shape[0]} rows, expected "
                             f"{self.num_row()}")
        return a

    def set_label(self, label: Any) -> None:
        self.label = self._rows(label, "label").reshape(-1)

    def set_weight(self, weight: Any) -> None:
        self.weight = self._rows(weight, "weight").reshape(-1)

    def set_base_margin(self, margin: Any) -> None:
        self.base_margin = self._rows(margin, "base_margin")

    def num_row(self) -> int:
        return self._host.shape[0]

    def num_col(self) -> int:
        return self._host.shape[1]

    def get_label(self) -> np.ndarray:
        return (self.label if self.label is not None
                else np.zeros(self.num_row(), np.float32))

    def get_weight(self) -> Optional[np.ndarray]:
        return self.weight

    def ensure_ellpack(self, max_bin: int = 256,
                       row_align: int = 1024) -> EllpackPage:
        """Sketch and bin once per ``max_bin``."""
        if self._ellpack is None or self._max_bin_built != max_bin:
            cuts = sketch_dense(self.X, max_bin)
            self._ellpack = build_ellpack(self.X, cuts, row_align=row_align)
            self._max_bin_built = max_bin
        return self._ellpack
