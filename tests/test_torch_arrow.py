"""Arrow columnar input of the port (xgboost_tpu_torch/data/arrow.py),
mirroring tests/test_arrow.py and held against xgboost_tpu: a pyarrow
Table or RecordBatch becomes the reference's f32 matrix (nulls NaN,
dictionary columns categorical codes), names, types and categories, and a
model trained from it predicts as from numpy.  Skips without pyarrow."""
import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

import xgboost_tpu as xtb  # noqa: E402
import xgboost_tpu_torch as xtt  # noqa: E402
from xgboost_tpu_torch.data.arrow import (ipc_batch_to_dense,  # noqa: E402
                                          is_arrow)


def _both(table, **kw):
    return xtb.DMatrix(table, **kw), xtt.DMatrix(table, device="cpu", **kw)


def _same(ref, got):
    np.testing.assert_array_equal(got.host_dense(), ref.host_dense())
    assert got.feature_names == ref.feature_names
    assert got.feature_types == ref.feature_types
    assert got.get_categories() == ref.get_categories()


def test_is_arrow_detects_without_import():
    t = pa.table({"a": [1.0, 2.0]})
    assert is_arrow(t)
    assert is_arrow(t.to_batches()[0])
    assert not is_arrow(np.zeros((2, 2)))
    assert not is_arrow([[1.0, 2.0]])


def test_table_nulls_become_nan():
    t = pa.table({
        "x": pa.array([1.0, None, 3.0], pa.float64()),
        "y": pa.array([None, 5, 6], pa.int64()),
    })
    ref, got = _both(t)
    _same(ref, got)
    X = got.host_dense()
    assert X.dtype == np.float32 and X.shape == (3, 2)
    assert np.isnan(X[1, 0]) and np.isnan(X[0, 1])
    assert got.feature_types == ["q", "int"]


def test_record_batch_and_chunked_table_agree():
    data = {"a": [0.5, 1.5, 2.5, 3.5], "b": [1, 2, 3, 4]}
    table = pa.concat_tables(
        [pa.table({k: v[:2] for k, v in data.items()}),
         pa.table({k: v[2:] for k, v in data.items()})])
    batch = pa.table(data).to_batches()[0]
    np.testing.assert_array_equal(
        xtt.DMatrix(table, device="cpu").host_dense(),
        xtt.DMatrix(batch, device="cpu").host_dense())
    _same(*_both(batch))


def test_dictionary_column_is_categorical():
    cat = pa.array(["lo", "hi", "lo", None, "mid"]).dictionary_encode()
    t = pa.table({"level": cat, "v": [1.0, 2.0, 3.0, 4.0, 5.0]})
    ref, got = _both(t)
    _same(ref, got)
    assert got.feature_types == ["c", "q"]
    assert got.get_categories() == {"level": ["lo", "hi", "mid"]}
    assert np.isnan(got.host_dense()[3, 0])


def test_custom_missing_applies_to_numeric_only():
    cat = pa.array(["a", "b", "a"]).dictionary_encode()
    t = pa.table({"c": cat, "v": [-1.0, 2.0, -1.0]})
    ref, got = _both(t, missing=-1.0)
    _same(ref, got)
    np.testing.assert_array_equal(got.host_dense()[:, 0], [0.0, 1.0, 0.0])


def test_train_predict_roundtrip_from_arrow():
    rng = np.random.default_rng(7)
    Xn = rng.normal(size=(128, 3)).astype(np.float32)
    y = (Xn[:, 0] > 0).astype(np.float32)
    t = pa.table({f"f{i}": Xn[:, i] for i in range(3)})
    params = {"objective": "binary:logistic", "max_depth": 3,
              "deterministic_histogram": 1}
    bst = xtt.train(params, xtt.DMatrix(t, label=y, device="cpu"), 3,
                    verbose_eval=False, device="cpu")
    np.testing.assert_array_equal(
        bst.predict(xtt.DMatrix(t, device="cpu")),
        bst.predict(xtt.DMatrix(Xn, device="cpu")))
    want = xtb.train(params, xtb.DMatrix(t, label=y), 3, verbose_eval=False)
    assert bytes(bst.save_raw("json")) == bytes(want.save_raw("json"))


def test_categorical_table_trains_as_the_reference():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=400)
    words = np.array(["a", "b", "c", "d"])[codes]
    v = rng.normal(size=400)
    y = ((codes % 2 == 1) ^ (v > 0.5)).astype(np.float32)
    t = pa.table({"w": pa.array(words).dictionary_encode(), "v": v})
    params = {"objective": "binary:logistic", "max_depth": 3,
              "deterministic_histogram": 1, "max_cat_to_onehot": 1}
    got = xtt.train(params, xtt.DMatrix(t, label=y, device="cpu"), 3,
                    verbose_eval=False, device="cpu")
    want = xtb.train(params, xtb.DMatrix(t, label=y), 3, verbose_eval=False)
    assert bytes(got.save_raw("json")) == bytes(want.save_raw("json"))
    assert got.get_categories() == want.get_categories()


def test_ipc_batch_to_dense():
    from xgboost_tpu.data.arrow import ipc_batch_to_dense as ref_ipc

    t = pa.table({"a": pa.array([1.0, 2.0, 3.0], pa.float32()),
                  "b": pa.array([1, None, 3], pa.int32())})
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    payload = sink.getvalue().to_pybytes()
    np.testing.assert_array_equal(ipc_batch_to_dense(payload),
                                  ref_ipc(payload))
    d = pa.table({"c": pa.array(["x", "y", "x"]).dictionary_encode()})
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, d.schema) as w:
        w.write_table(d)
    with pytest.raises(ValueError, match="dictionary"):
        ipc_batch_to_dense(sink.getvalue().to_pybytes())
