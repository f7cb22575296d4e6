"""Arrow columnar input (port of xgboost_tpu/data/arrow.py; reference
src/data/adapter.h:437 ColumnarAdapter, python-package data.py arrow
dispatch): a pyarrow Table or RecordBatch -> a column-major f32 matrix.

- numeric columns are copied to f32, nulls -> NaN (the missing value);
- dictionary-encoded columns are categorical: their physical codes feed
  the trees (feature type ``'c'``) and their dictionary values stay on the
  DMatrix (``cat_categories``), so that a table coded another way is
  recoded at prediction.

pyarrow is imported inside the functions that need it: a module of the
port imports no frame library when it is imported.
"""
from __future__ import annotations

from typing import Any

import numpy as np


def is_arrow(data: Any) -> bool:
    """True for a pyarrow Table or RecordBatch (without importing
    pyarrow)."""
    return type(data).__module__.split(".")[0] == "pyarrow" and hasattr(
        data, "schema")


def arrow_to_columnar(data: Any):
    """A Table or RecordBatch -> (f32 matrix, names, types, {feature ->
    category values}), the form of ``dmatrix._from_frame``: integer
    columns are typed ``'int'``, floating ones ``'q'``, dictionary ones
    ``'c'``."""
    import pyarrow as pa

    names = [str(c) for c in data.schema.names]
    types = []
    cols = []
    cats = {}
    for fi, name in enumerate(data.schema.names):
        col = data.column(name)
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        if pa.types.is_dictionary(col.type):
            cats[fi] = [v.as_py() for v in col.dictionary]
            codes = col.indices.to_numpy(zero_copy_only=False).astype(
                np.float32)
            if col.null_count:
                codes[np.asarray(col.is_null())] = np.nan
            cols.append(codes)
            types.append("c")
        else:
            vals = col.to_numpy(zero_copy_only=False).astype(np.float32)
            if col.null_count:
                vals[np.asarray(col.is_null())] = np.nan
            cols.append(vals)
            types.append("q" if pa.types.is_floating(col.type) else "int")
    arr = (np.stack(cols, axis=1) if cols
           else np.zeros((data.num_rows, 0), np.float32))
    return arr, names, types, cats


def ipc_batch_to_dense(payload) -> np.ndarray:
    """Arrow IPC stream bytes -> (R, F) f32 matrix (reference arrow.py:78):
    f32 columns without nulls are read as views of the received buffer,
    other numeric columns copied with nulls as NaN; a dictionary column
    raises (send the training codes instead)."""
    import pyarrow as pa

    with pa.ipc.open_stream(pa.py_buffer(payload)) as reader:
        table = reader.read_all()
    batch = table.combine_chunks()
    cols = []
    for ci in range(batch.num_columns):
        col = batch.column(ci)
        if isinstance(col, pa.ChunkedArray):
            col = (col.combine_chunks() if col.num_chunks != 1
                   else col.chunk(0))
        if pa.types.is_dictionary(col.type):
            raise ValueError(
                "dictionary-encoded columns are not accepted on the IPC "
                "request path: recode to the training category codes and "
                "send the numeric codes (Booster.get_categories gives the "
                "training dictionaries)")
        if pa.types.is_float32(col.type) and col.null_count == 0:
            cols.append(col.to_numpy(zero_copy_only=True))
        else:
            vals = col.to_numpy(zero_copy_only=False).astype(np.float32)
            if col.null_count:
                vals[np.asarray(col.is_null())] = np.nan
            cols.append(vals)
    if not cols:
        return np.zeros((batch.num_rows, 0), np.float32)
    return np.stack(cols, axis=1)
