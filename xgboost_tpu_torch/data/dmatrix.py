"""In-memory DMatrix (port of the dense and CSR paths of
xgboost_tpu/data/dmatrix.py, categorical columns included).

Holds the raw matrix (f32, NaN = missing) as a tensor on its device, the
labels and metadata on the host, and lazily builds the binned EllpackPage on
the first training touch.  Cuts come from the device sketch for a matrix
on the card and from the exact host grid for one on the CPU, as the
reference chooses per backend; bins are computed on the device.

A scipy sparse matrix (CSR, CSC, anything with ``tocsr``) stays CSR on the
host: an implicit zero is missing, as in the reference; its cuts come from
the host sketch of the stored entries on either device, its bins are
computed on the device from the entries, and its rows are made dense only
for prediction.

Categorical features (feature type ``'c'``) hold integer category codes:
from numpy with ``feature_types``, or from a pandas frame's ``category``
columns, whose category values are kept (``cat_categories``) so that a
frame coded another way is recoded at prediction.  The frame is read
through its own methods: this module never imports pandas.  A pyarrow
Table or RecordBatch (``data/arrow.py``) and a polars frame come in the
same way: nulls become NaN, dictionary and categorical columns their codes.

``QuantileDMatrix`` bins at construction; ``ref=`` takes another matrix's
cuts, so that validation rows land in the training bins.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .arrow import arrow_to_columnar, is_arrow
from .ellpack import EllpackPage, build_ellpack, build_ellpack_csr
from .quantile import HistogramCuts, WeightedSketch, sketch_csr, sketch_dense


@dataclasses.dataclass
class MetaInfo:
    """Labels and the other per-row and per-feature metadata (reference
    dmatrix.py:24, data.h:65-116)."""

    num_row: int = 0
    num_col: int = 0
    label: Optional[np.ndarray] = None
    weight: Optional[np.ndarray] = None
    base_margin: Optional[np.ndarray] = None
    group_ptr: Optional[np.ndarray] = None
    label_lower_bound: Optional[np.ndarray] = None
    label_upper_bound: Optional[np.ndarray] = None
    feature_names: Optional[List[str]] = None
    feature_types: Optional[List[str]] = None
    feature_weights: Optional[np.ndarray] = None

    def validate(self) -> None:
        for name in ("label", "weight", "base_margin"):
            arr = getattr(self, name)
            if arr is not None and arr.shape[0] != self.num_row:
                raise ValueError(f"{name} has {arr.shape[0]} rows, "
                                 f"expected {self.num_row}")
        if self.group_ptr is not None and self.group_ptr[-1] != self.num_row:
            raise ValueError("group sizes must sum to num_row")


def _normalize_dense(arr: np.ndarray, missing: float,
                     feature_types: Optional[Sequence[str]] = None
                     ) -> np.ndarray:
    """1-D promotion + custom-missing -> NaN.  The sentinel applies to the
    numeric columns only: categorical columns hold codes, and a sentinel of
    0.0 must not wipe out category 0."""
    if arr.ndim == 1:
        arr = arr[:, None]
    if not (missing is None or np.isnan(missing)):
        hit = arr == missing
        if feature_types is not None:
            hit = hit & np.asarray([t != "c" for t in feature_types],
                                   bool)[None, :]
        arr = np.where(hit, np.float32(np.nan), arr)
    return arr


def categories_by_name(cat_categories: Optional[dict],
                       feature_names: Optional[Sequence[str]],
                       ) -> Optional[Dict[str, list]]:
    """``{feature index -> category values}`` keyed by feature name (the
    index as a string where unnamed): the form of every ``get_categories``
    (reference: src/data/cat_container.h)."""
    if not cat_categories:
        return None
    names = feature_names
    return {
        (names[fi] if names and fi < len(names) else str(fi)): list(vals)
        for fi, vals in sorted(cat_categories.items())
    }


def recode_dense(X: np.ndarray, train_cats: Optional[dict],
                 data_cats: Optional[dict]) -> np.ndarray:
    """Remap the categorical codes of a dense matrix from ``data_cats`` (the
    frame it was built from) onto ``train_cats`` (the training frame's
    category -> code mapping; reference: encoder/ordinal.h Recode).  ``X``
    comes back untouched when the orderings agree; a category never seen
    in training raises."""
    if not train_cats or not data_cats or train_cats == {
            int(k): list(v) for k, v in data_cats.items()}:
        return X
    X = np.array(X, copy=True)
    for f, train_vals in train_cats.items():
        new_vals = data_cats.get(f)
        if new_vals is None or list(new_vals) == list(train_vals):
            continue
        lookup = {v: i for i, v in enumerate(train_vals)}
        codes = X[:, f]
        remapped = np.full_like(codes, np.nan)
        for new_code, v in enumerate(new_vals):
            hit = codes == new_code
            if v in lookup:
                remapped[hit] = lookup[v]
            elif hit.any():
                raise ValueError(
                    f"feature {f} has category {v!r} not seen in "
                    "training (encoder recode)")
        X[:, f] = remapped
    return X


def _from_frame(df):
    """A pandas frame -> (f32 matrix, names, types, {feature -> category
    values}): ``category`` columns become their codes (NaN for pandas' -1)
    and type ``'c'``, float columns ``'q'``, other columns ``'int'``."""
    names = [str(c) for c in df.columns]
    types: List[str] = []
    cols = []
    cats: Dict[int, list] = {}
    for fi, c in enumerate(df.columns):
        col = df[c]
        if str(col.dtype) == "category":
            codes = col.cat.codes.to_numpy().astype(np.float32)
            codes[codes < 0] = np.nan
            cols.append(codes)
            types.append("c")
            cats[fi] = [v.item() if hasattr(v, "item") else v
                        for v in col.cat.categories.tolist()]
        else:
            cols.append(col.to_numpy().astype(np.float32))
            types.append("q" if col.dtype.kind == "f" else "int")
    arr = (np.stack(cols, axis=1) if cols
           else np.zeros((len(df), 0), np.float32))
    return arr, names, types, cats


def _from_polars(df):
    """A polars frame -> (f32 matrix, names, types, {feature -> category
    values}) as ``_from_frame`` (reference dmatrix.py:166-189):
    Categorical and Enum columns become their physical codes, type
    ``'c'``; every other column is cast to f32, type ``'q'``; nulls NaN."""
    import polars as pl

    names = [str(c) for c in df.columns]
    types: List[str] = []
    cols = []
    cats: Dict[int, list] = {}
    for fi, c in enumerate(df.columns):
        s = df[c]
        if s.dtype in (pl.Categorical, pl.Enum):
            cats[fi] = [str(v) for v in s.cat.get_categories().to_list()]
            cols.append(s.to_physical().cast(pl.Float32).to_numpy().copy())
            types.append("c")
        else:
            cols.append(s.cast(pl.Float32).to_numpy().copy())
            types.append("q")
    arr = (np.stack(cols, axis=1) if cols
           else np.zeros((len(df), 0), np.float32))
    return arr, names, types, cats


class DMatrix:
    """In-memory data matrix, dense or sparse (reference: data.h:549).

    ``device``: where the matrix is staged; ``None`` means ``cuda``.
    ``missing`` applies to dense input; sparse input's missing values are
    its implicit zeros (and stored NaN).
    ``group`` (sizes of consecutive query groups) or ``qid`` (a query id a
    row; a group wherever it changes): the ranking objectives' query
    groups, kept as ``group_ptr`` (G + 1,) int64, whose last entry must be
    the row count; ``group_version`` counts the changes.
    ``label_lower_bound``, ``label_upper_bound``: (R,) f32 survival bounds
    (``survival:aft``; an infinite upper bound is right-censored), also
    settable as attributes, as the reference's info.
    ``feature_weights``: (F,) non-negative weights of the column sampler's
    draws (colsample_*), as in the reference.  ``feature_types``: ``'q'``
    numeric, ``'c'`` categorical (codes 0, 1, ...); a pandas frame brings
    its own.  ``enable_categorical`` is accepted, as the reference accepts
    it: the feature types alone decide which features are categorical.
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
        label_lower_bound: Any = None,
        label_upper_bound: Any = None,
        group: Any = None,
        qid: Any = None,
        enable_categorical: bool = False,
        device=None,
    ) -> None:
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        # {feature index -> category values} of a frame's category columns
        self.cat_categories: Optional[Dict[int, list]] = None
        self.device = resolve_device(device)
        # (indptr, indices, values) of sparse input, else None
        self._csr: Optional[tuple] = None
        self._host: Optional[np.ndarray] = None
        self.X: Optional[torch.Tensor] = None  # the dense matrix on device
        if hasattr(data, "tocsr"):  # scipy sparse
            csr = data.tocsr()
            self._csr = (np.asarray(csr.indptr), np.asarray(csr.indices),
                         np.asarray(csr.data, dtype=np.float32))
            self._shape = tuple(csr.shape)
        else:
            frame = None
            if is_arrow(data):
                frame = arrow_to_columnar(data)
            elif type(data).__module__.split(".")[0] == "polars":
                frame = _from_polars(data)
            elif hasattr(data, "iloc") and hasattr(data, "columns"):
                frame = _from_frame(data)  # pandas
            if frame is not None:
                data, auto_names, auto_types, cats = frame
                feature_names = feature_names or auto_names
                feature_types = feature_types or auto_types
                self.cat_categories = cats or None
            self._host = _normalize_dense(np.asarray(data, dtype=np.float32),
                                          missing, feature_types)
            self._shape = self._host.shape
            self.X = torch.from_numpy(self._host).to(self.device)
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.base_margin: Optional[np.ndarray] = None
        self.label_lower_bound: Optional[np.ndarray] = None
        self.label_upper_bound: Optional[np.ndarray] = None
        self.group_ptr: Optional[np.ndarray] = None
        self.group_version = 0
        if label_lower_bound is not None:
            self.label_lower_bound = self._rows(label_lower_bound,
                                                "label_lower_bound")
        if label_upper_bound is not None:
            self.label_upper_bound = self._rows(label_upper_bound,
                                                "label_upper_bound")
        if label is not None:
            self.set_label(label)
        if weight is not None:
            self.set_weight(weight)
        if base_margin is not None:
            self.set_base_margin(base_margin)
        if group is not None:
            self.set_group(group)
        if qid is not None:
            self.set_qid(qid)
        if self.group_ptr is not None and self.group_ptr[-1] != self.num_row():
            raise ValueError("group sizes must sum to num_row")
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
        self._weighted_sketch: Optional[WeightedSketch] = None

    def _rows(self, arr: Any, name: str) -> np.ndarray:
        a = np.asarray(arr, dtype=np.float32)
        if a.shape[0] != self.num_row():
            raise ValueError(f"{name} has {a.shape[0]} rows, expected "
                             f"{self.num_row()}")
        return a

    def set_label(self, label: Any) -> None:
        """(R,) labels, or (R, K) for K targets (reference dmatrix.py:341):
        a single column is taken back to (R,)."""
        lab = self._rows(label, "label").reshape(self.num_row(), -1)
        self.label = lab[:, 0] if lab.shape[1] == 1 else lab

    def set_weight(self, weight: Any) -> None:
        """(R,) row weights; with query groups also (G,) group weights,
        which the ranking metrics read and the objectives ignore."""
        w = np.asarray(weight, dtype=np.float32).reshape(-1)
        if self.group_ptr is None or len(w) != len(self.group_ptr) - 1:
            w = self._rows(w, "weight")
        self.weight = w

    def set_group(self, group: Any) -> None:
        """Query groups from their sizes (reference dmatrix.py:357)."""
        g = np.asarray(group, dtype=np.int64)
        self.group_ptr = np.concatenate([[0], np.cumsum(g)]).astype(np.int64)
        self.group_version += 1

    def set_qid(self, qid: Any) -> None:
        """Query groups from a query id a row: a new group wherever the id
        changes (reference dmatrix.py:362)."""
        q = np.asarray(qid)
        if len(q) == 0:
            return
        change = np.nonzero(np.diff(q) != 0)[0] + 1
        self.group_ptr = np.concatenate([[0], change, [len(q)]]).astype(
            np.int64)
        self.group_version += 1

    def set_base_margin(self, margin: Any) -> None:
        self.base_margin = self._rows(margin, "base_margin")

    def host_dense(self) -> np.ndarray:
        """The (R, F) f32 host copy, NaN = missing (made anew from sparse
        input at each call, reference dmatrix.py:414 host_dense_rows)."""
        if self._csr is None:
            return self._host
        indptr, indices, values = self._csr
        out = np.full(self._shape, np.nan, dtype=np.float32)
        rows = np.repeat(np.arange(self._shape[0]), np.diff(indptr))
        out[rows, indices] = values
        return out

    def num_row(self) -> int:
        return self._shape[0]

    def num_col(self) -> int:
        return self._shape[1]

    def get_label(self) -> np.ndarray:
        return (self.label if self.label is not None
                else np.zeros(self.num_row(), np.float32))

    def get_weight(self) -> Optional[np.ndarray]:
        return self.weight

    @property
    def info(self) -> MetaInfo:
        """The matrix's metadata as the reference's ``MetaInfo``."""
        return MetaInfo(
            num_row=self.num_row(), num_col=self.num_col(), label=self.label,
            weight=self.weight, base_margin=self.base_margin,
            group_ptr=self.group_ptr,
            label_lower_bound=self.label_lower_bound,
            label_upper_bound=self.label_upper_bound,
            feature_names=self.feature_names,
            feature_types=self.feature_types,
            feature_weights=self.feature_weights)

    def get_categories(self) -> Optional[Dict[str, list]]:
        """The frame's category values per categorical feature, keyed by
        feature name (or index), None for numeric or numpy input."""
        return categories_by_name(self.cat_categories, self.feature_names)

    def cat_mask(self) -> Optional[np.ndarray]:
        """(F,) bool: which features are categorical; None when none is."""
        ft = self.feature_types
        if not ft or "c" not in ft:
            return None
        return np.asarray([t == "c" for t in ft], dtype=bool)

    def slice(self, rindex: Sequence[int]) -> "DMatrix":
        """The rows ``rindex`` as a DMatrix on the same device (reference
        dmatrix.py:500, XGDMatrixSliceDMatrix; cv's folds): labels,
        weights, base margin, survival bounds, query groups re-derived from
        the rows' query ids, the feature weights, names and types, and the
        frame's categories, so that the slice recodes as its source does.
        A weight a query group stays with its group."""
        idx = np.asarray(rindex, dtype=np.int64)
        if self._csr is None:
            data = self._host[idx]
        else:
            import scipy.sparse as sp

            indptr, indices, values = self._csr
            data = sp.csr_matrix((values, indices, indptr),
                                 shape=self._shape)[idx]
        out = DMatrix(data, device=self.device)
        out.cat_categories = self.cat_categories
        for name in ("label", "base_margin", "label_lower_bound",
                     "label_upper_bound"):
            v = getattr(self, name)
            if v is not None:
                setattr(out, name, v[idx])
        if self.group_ptr is not None:
            qid = np.repeat(np.arange(len(self.group_ptr) - 1),
                            np.diff(self.group_ptr))[idx]
            out.set_qid(qid)
        w = self.weight
        if w is not None and len(w) != self.num_row():
            # a weight a group: each new group takes its source group's
            out.weight = w[qid[out.group_ptr[:-1]]] if len(qid) else w[:0]
        elif w is not None:
            out.weight = w[idx]
        out.feature_weights = self.feature_weights
        out.feature_names = self.feature_names
        out.feature_types = self.feature_types
        return out

    def weighted_sketch(self) -> WeightedSketch:
        """tree_method="approx"'s host sketch of this matrix, each
        column's sort found once; the rounds weight it anew."""
        if self._weighted_sketch is None:
            self._weighted_sketch = WeightedSketch(self.host_dense(),
                                                   self.cat_mask())
        return self._weighted_sketch

    def ensure_ellpack(self, max_bin: int = 256, row_align: int = 1024,
                       ref: Optional["DMatrix"] = None) -> EllpackPage:
        """Sketch and bin once per ``max_bin``.  ``ref``: a matrix whose
        page is built lends its cuts (GetCutsFromRef, reference
        dmatrix.py:464-465), so that these rows land in its bins."""
        if self._ellpack is None or self._max_bin_built != max_bin:
            cuts: Optional[HistogramCuts] = None
            if ref is not None and ref._ellpack is not None:
                cuts = ref._ellpack.cuts
            if self._csr is None:
                if cuts is None:
                    cuts = sketch_dense(self.X, max_bin,
                                        cat_mask=self.cat_mask())
                self._ellpack = build_ellpack(self.X, cuts,
                                              row_align=row_align)
            else:
                F = self.num_col()
                if cuts is None:
                    cuts = sketch_csr(*self._csr, F, max_bin,
                                      cat_mask=self.cat_mask())
                self._ellpack = build_ellpack_csr(
                    *self._csr, F, cuts, row_align=row_align,
                    device=self.device)
            self._max_bin_built = max_bin
        return self._ellpack


class QuantileDMatrix(DMatrix):
    """A DMatrix binned at construction (reference dmatrix.py:532,
    iterative_dmatrix.h:34); ``ref=`` bins it on another matrix's cuts."""

    def __init__(self, data: Any, label: Any = None, *, max_bin: int = 256,
                 ref: Optional[DMatrix] = None, **kwargs: Any) -> None:
        super().__init__(data, label, **kwargs)
        self.max_bin = max_bin
        self.ensure_ellpack(max_bin=max_bin, ref=ref)
