"""Port parity: quantile cuts and Ellpack bins of xgboost_tpu_torch held
bitwise against xgboost_tpu on the same numpy input."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xgboost_tpu.data.ellpack import build_ellpack as ref_build_ellpack
from xgboost_tpu.data.quantile import sketch_dense as ref_sketch_dense
from xgboost_tpu_torch.data.dmatrix import DMatrix
from xgboost_tpu_torch.data.ellpack import _bin_dtype, build_ellpack
from xgboost_tpu_torch.data.quantile import sketch_dense


def _data(R=1500, F=6, seed=0, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[:, 1] = np.round(X[:, 1] * 3)  # few distinct values
    X[:, 2] = 7.0  # constant column
    X[rng.random((R, F)) < nan_frac] = np.nan
    X[:, 3] = np.nan  # all-missing column
    return X


@pytest.mark.parametrize("max_bin", [2, 16, 64, 256])
def test_cuts_bitwise(max_bin):
    X = _data(seed=max_bin)
    ref = ref_sketch_dense(X, max_bin)
    got = sketch_dense(X, max_bin)
    np.testing.assert_array_equal(got.cut_ptrs, ref.cut_ptrs)
    np.testing.assert_array_equal(got.cut_values.view(np.uint32),
                                  ref.cut_values.view(np.uint32))
    np.testing.assert_array_equal(got.min_vals.view(np.uint32),
                                  ref.min_vals.view(np.uint32))


@pytest.mark.parametrize("max_bin,dtype", [(16, torch.uint8),
                                           (256, torch.int16)])
def test_bins_bitwise(max_bin, dtype):
    """NaN -> sentinel B, top-bin clamp, rows padded to 1024 with the
    sentinel; int16 at max_bin=256 (257 symbols)."""
    X = _data(R=1900, F=5, seed=7)
    # values above the last cut of a feature clamp into its top bin
    X[0, 0] = 1e6
    cuts = ref_sketch_dense(X[1:], max_bin)
    ref = ref_build_ellpack(jnp.asarray(X), cuts)
    got = build_ellpack(torch.from_numpy(X), sketch_dense(X[1:], max_bin))
    assert got.bins.dtype == dtype
    assert str(np.asarray(ref.bins).dtype) == str(dtype).split(".")[-1]
    np.testing.assert_array_equal(got.bins.numpy(), np.asarray(ref.bins))
    np.testing.assert_array_equal(got.cuts_pad.numpy(),
                                  np.asarray(ref.cuts_pad))
    np.testing.assert_array_equal(got.n_bins.numpy(), np.asarray(ref.n_bins))
    assert got.n_padded == 2048 and got.n_rows == 1900


@pytest.mark.parametrize("n,want", [(2, torch.uint8), (255, torch.uint8),
                                    (256, torch.int16), (257, torch.int16),
                                    (40000, torch.int32)])
def test_bin_dtype(n, want):
    assert _bin_dtype(n) == want


def test_dmatrix_missing_and_meta():
    X = np.array([[1.0, -999.0], [2.0, 3.0], [-999.0, 4.0]], np.float32)
    d = DMatrix(X, label=[0, 1, 0], weight=[1, 2, 3], base_margin=[0.5] * 3,
                missing=-999.0, device="cpu")
    assert torch.isnan(d.X[0, 1]) and torch.isnan(d.X[2, 0])
    assert not torch.isnan(d.X[1]).any()
    assert d.num_row() == 3 and d.num_col() == 2
    np.testing.assert_array_equal(d.get_weight(), [1, 2, 3])
    with pytest.raises(ValueError):
        d.set_label([0, 1])
    # a categorical column holds codes: a sentinel of 0.0 must not wipe out
    # its category 0, so the sentinel applies to numeric columns only
    dc = DMatrix(np.array([[0.0, 0.0], [1.0, 2.0]], np.float32),
                 feature_types=["q", "c"], missing=0.0, device="cpu")
    assert torch.isnan(dc.X[0, 0]) and dc.X[0, 1] == 0.0
    np.testing.assert_array_equal(dc.cat_mask(), [False, True])
    assert d.cat_mask() is None


@pytest.mark.parametrize("shape,max_bin", [((1 << 19 | 4096, 2), 16),
                                           ((200_000, 4), 256)])
def test_device_sketch_bitwise(monkeypatch, shape, max_bin):
    """The accelerator sketch (stride subsample above 2**19 rows, f32
    ranks) run on CPU tensors equals the reference's device branch, forced
    on the CPU backend as tests/test_basic.py forces it; both differ from
    the exact host grid at these sizes."""
    rng = np.random.default_rng(shape[1])
    X = rng.normal(size=shape).astype(np.float32)
    X[rng.random(shape) < 0.05] = np.nan
    monkeypatch.setenv("XTB_FORCE_DEVICE_SKETCH", "1")
    ref = ref_sketch_dense(X, max_bin, use_device=True)
    got = sketch_dense(torch.from_numpy(X), max_bin, use_device=True)
    np.testing.assert_array_equal(got.cut_ptrs, ref.cut_ptrs)
    np.testing.assert_array_equal(got.cut_values.view(np.uint32),
                                  ref.cut_values.view(np.uint32))
    np.testing.assert_array_equal(got.min_vals.view(np.uint32),
                                  ref.min_vals.view(np.uint32))
    host = sketch_dense(X, max_bin)
    assert not np.array_equal(host.cut_values, got.cut_values)
    # a CPU matrix keeps the host grid, as the reference's CPU backend does
    d = DMatrix(X[:4096], device="cpu")
    np.testing.assert_array_equal(
        d.ensure_ellpack(max_bin).cuts.cut_values,
        sketch_dense(X[:4096], max_bin, use_device=False).cut_values)
