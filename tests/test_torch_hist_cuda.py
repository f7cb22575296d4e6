"""The CUDA histogram kernel (K1, xgboost_tpu_torch/csrc/hist.cu) on the
card: held against the plain PyTorch version at rtol/atol 1e-4 (the same
f32 sums, added by atomics in no fixed order), and the trainer's launches
of it counted.  Every test here needs a CUDA device and skips without one;
the file imports neither JAX nor xgboost_tpu, so it runs on a machine that
has only PyTorch."""
import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xtt
from xgboost_tpu_torch.ops import hist_cuda

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernel runs only on a GPU")


def _mk(R, F, B, node0, span, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B + 1, size=(R, F))  # B = missing sentinel
    gpair = rng.normal(size=(R, 2)).astype(np.float32)
    pos = rng.integers(node0 - 1, node0 + span + 1, size=R).astype(np.int32)
    pos[-R // 16:] = -1  # pad rows
    return bins, gpair, pos


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
@pytest.mark.parametrize("node0,n_nodes,stride", [
    (0, 1, 1), (3, 4, 1), (1, 1, 2), (7, 4, 2), (31, 16, 2)])
def test_kernel_matches_plain(dtype, node0, n_nodes, stride):
    B = 250 if dtype == torch.uint8 else 256
    bins, gpair, pos = _mk(8192, 28, B, node0, stride * n_nodes, node0)
    args = (torch.from_numpy(bins).to(dtype).cuda(),
            torch.from_numpy(gpair).cuda(), torch.from_numpy(pos).cuda())
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=B, stride=stride)
    before = hist_cuda.launches
    got = hist_cuda.build_histogram(*args, **kw)
    torch.cuda.synchronize()
    assert hist_cuda.launches == before + 1
    want = hist_cuda.build_histogram_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@needs_cuda
def test_kernel_rejects_what_it_cannot_take():
    bins, gpair, pos = _mk(1024, 4, 16, 0, 1, 0)
    g, p = torch.from_numpy(gpair).cuda(), torch.from_numpy(pos).cuda()
    kw = dict(node0=0, n_nodes=1, n_bin=16)
    with pytest.raises(TypeError):
        hist_cuda.build_histogram_cuda(
            torch.from_numpy(bins).to(torch.float32).cuda(), g, p, **kw)
    with pytest.raises(ValueError):
        hist_cuda.build_histogram_cuda(
            torch.from_numpy(bins).to(torch.int16).cuda().t(), g, p, **kw)


@needs_cuda
def test_training_on_card_launches_kernel_and_matches_cpu():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(5000, 8)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) > 0).astype(np.float32)
    params = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 32}
    hist_cuda.launches = 0
    card = xtt.train(params, xtt.DMatrix(X, label=y), 4, verbose_eval=False)
    assert hist_cuda.launches == 4 * 3  # depths 0-2 build, depth 3 does not
    cpu = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), 4,
                    verbose_eval=False, device="cpu")
    for a, b in zip(card.trees, cpu.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
    np.testing.assert_allclose(card.predict(xtt.DMatrix(X)),
                               cpu.predict(xtt.DMatrix(X, device="cpu")),
                               atol=1e-4)
