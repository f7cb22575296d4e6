"""Port parity for sparse input: a scipy CSR or CSC matrix, whose implicit
zeros are missing, is sketched from its stored entries and binned into the
dense layout the histogram kernels take.  Cuts and bins are bitwise the
reference's (``sketch_csr``, ``build_ellpack_csr``), the deterministic
model JSON trained on CSR byte-identical to the reference's, and
prediction on CSR equal to prediction on its dense NaN form."""
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu.data.ellpack import build_ellpack_csr as ref_bins
from xgboost_tpu.data.quantile import sketch_csr as ref_sketch
from xgboost_tpu_torch.data.ellpack import build_ellpack_csr
from xgboost_tpu_torch.data.quantile import sketch_csr


def _sparse(R=1500, F=12, density=0.3, seed=0):
    """Stored values N(0, 1) at ``density``, one column with nothing
    stored, ten empty rows, a few stored NaN and explicit zeros."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(R, F)).astype(np.float32)
    D[rng.random((R, F)) > density] = 0.0
    D[:, 5] = 0.0
    D[10:20] = 0.0
    m = sp.csr_matrix(D)
    m.eliminate_zeros()
    nan_at = rng.choice(m.nnz, 20, replace=False)
    m.data[nan_at] = np.nan
    # explicit zeros: stored, so present (not missing)
    zero_at = rng.choice(m.nnz, 30, replace=False)
    m.data[zero_at] = 0.0
    dense = m.toarray()
    missing = np.ones_like(dense, bool)
    rows = np.repeat(np.arange(R), np.diff(m.indptr))
    missing[rows, m.indices] = False
    dense[missing] = np.nan
    return m, dense


def _arrays(m):
    return m.indptr, m.indices, m.data.astype(np.float32)


@pytest.mark.parametrize("max_bin", [16, 256])
@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_cuts_and_bins_are_the_references(fmt, max_bin):
    m, _ = _sparse()
    m = m.tocsc() if fmt == "csc" else m
    csr = m.tocsr()
    F = csr.shape[1]
    want = ref_sketch(*_arrays(csr), F, max_bin)
    got = sketch_csr(*_arrays(csr), F, max_bin)
    np.testing.assert_array_equal(got.cut_ptrs, want.cut_ptrs)
    np.testing.assert_array_equal(got.cut_values.view(np.uint32),
                                  want.cut_values.view(np.uint32))
    np.testing.assert_array_equal(got.min_vals.view(np.uint32),
                                  want.min_vals.view(np.uint32))
    assert got.feature_cuts(5).size == 1  # nothing stored: one bin
    ew = ref_bins(*_arrays(csr), F, want)
    eg = build_ellpack_csr(*_arrays(csr), F, got)
    assert eg.bins.shape == tuple(ew.bins.shape)
    assert str(eg.bins.dtype).split(".")[-1] == str(ew.bins.dtype)
    np.testing.assert_array_equal(eg.bins.numpy().astype(np.int64),
                                  np.asarray(ew.bins).astype(np.int64))
    B = want.max_n_bins
    assert (eg.bins[10:20] == B).all()  # empty rows: every entry absent
    # the DMatrix takes either format to the same page
    ell = xtt.DMatrix(m, device="cpu").ensure_ellpack(max_bin)
    assert torch.equal(ell.bins, eg.bins)


def test_categorical_cuts_are_the_references():
    m, _ = _sparse(F=6, density=0.5, seed=3)
    codes = np.random.default_rng(4).integers(0, 9, m.nnz)
    cat = m.indices == 2
    m.data[cat] = codes[cat]
    mask = np.arange(6) == 2
    want = ref_sketch(*_arrays(m), 6, 32, cat_mask=mask)
    got = sketch_csr(*_arrays(m), 6, 32, cat_mask=mask)
    np.testing.assert_array_equal(got.cut_ptrs, want.cut_ptrs)
    np.testing.assert_array_equal(got.cut_values.view(np.uint32),
                                  want.cut_values.view(np.uint32))


@pytest.mark.parametrize("objective", ["binary:logistic", "multi:softprob"])
def test_deterministic_json_from_csr_is_the_references(objective):
    m, dense = _sparse()
    z = np.nan_to_num(dense[:, 0]) - np.nan_to_num(dense[:, 1])
    params = {"objective": objective, "max_depth": 4, "max_bin": 32,
              "eta": 0.3, "deterministic_histogram": 1}
    if objective == "multi:softprob":
        params["num_class"] = 3
        y = np.digitize(z, [-0.3, 0.3]).astype(np.float32)
    else:
        y = (z > 0).astype(np.float32)
    ref = xtb.train(params, xtb.DMatrix(m, label=y), 3, verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(m, label=y, device="cpu"), 3,
                    verbose_eval=False, device="cpu")
    assert json.dumps(got.save_raw_dict()) == json.dumps(ref.save_raw_dict())
    # a CSR evaluation set: the metric sees the CSR rows' predictions
    log: dict = {}
    d = xtt.DMatrix(m, label=y, device="cpu")
    xtt.train(params, d, 2, evals=[(d, "train")], evals_result=log,
              verbose_eval=False, device="cpu")
    assert np.isfinite(list(log["train"].values())[0]).all()


def test_prediction_on_csr_is_the_dense_nan_form():
    m, dense = _sparse(seed=1)
    y = (np.nan_to_num(dense[:, 3]) > 0).astype(np.float32)
    bst = xtt.train({"objective": "binary:logistic", "max_depth": 5,
                     "max_bin": 64}, xtt.DMatrix(m, label=y, device="cpu"),
                    4, verbose_eval=False, device="cpu")
    want = bst.predict(xtt.DMatrix(dense, device="cpu"))
    for fmt in (m, m.tocsc(), m.tocoo()):
        d = xtt.DMatrix(fmt, device="cpu")
        assert (d.num_row(), d.num_col()) == dense.shape
        np.testing.assert_array_equal(d.host_dense(), dense)
        np.testing.assert_array_equal(bst.predict(d), want)
    np.testing.assert_array_equal(
        bst.predict(xtt.DMatrix(m, device="cpu"), pred_leaf=True),
        bst.predict(xtt.DMatrix(dense, device="cpu"), pred_leaf=True))
