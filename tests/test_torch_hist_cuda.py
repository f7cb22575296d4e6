"""The CUDA histogram kernels on the card: K1 (csrc/hist.cu) held against
its plain PyTorch version at rtol/atol 1e-4 (the same f32 sums, added by
atomics in no fixed order), K2 (csrc/hist_q.cu) held against its plain
version bitwise (exact int32 sums), both with nodes tiled over blocks at
N = 128, and the trainer's launches of each counted.  Every test here needs
a CUDA device and skips without one; the file imports neither JAX nor
xgboost_tpu, so it runs on a machine that has only PyTorch."""
import json

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xtt
from xgboost_tpu_torch.ops import hist_cuda
from xgboost_tpu_torch.ops.quantise import local_rho, quantise_gpair

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
    before = hist_cuda.launches["hist_f32"]
    got = hist_cuda.build_histogram(*args, **kw)
    torch.cuda.synchronize()
    assert hist_cuda.launches["hist_f32"] == before + 1
    want = hist_cuda.build_histogram_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _limbs(gpair):
    g = torch.from_numpy(gpair).cuda()
    return quantise_gpair(g, local_rho(g, torch.ones(len(g), dtype=torch.bool,
                                                     device="cuda")))


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
@pytest.mark.parametrize("node0,n_nodes,stride", [
    (0, 1, 1), (3, 4, 1), (1, 1, 2), (7, 4, 2), (31, 16, 2)])
def test_q_kernel_matches_plain_bitwise(dtype, node0, n_nodes, stride):
    B = 250 if dtype == torch.uint8 else 256
    bins, gpair, pos = _mk(8192, 28, B, node0, stride * n_nodes, node0)
    args = (torch.from_numpy(bins).to(dtype).cuda(), _limbs(gpair),
            torch.from_numpy(pos).cuda())
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=B, stride=stride)
    before = hist_cuda.launches["hist_q"]
    got = hist_cuda.build_histogram_q(*args, **kw)
    torch.cuda.synchronize()
    assert hist_cuda.launches["hist_q"] == before + 1
    want = hist_cuda.build_histogram_q_plain(*args, **kw)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


@needs_cuda
def test_node_tiled_levels_match_plain():
    """N = 128 nodes at 256 bins: over the shared-memory budget for one
    feature in K1 and K2, so the nodes are split over blocks."""
    bins, gpair, pos = _mk(65536, 28, 256, 255, 256, 3)
    b = torch.from_numpy(bins).to(torch.int16).cuda()
    p = torch.from_numpy(pos).cuda()
    kw = dict(node0=255, n_nodes=128, n_bin=256, stride=2)
    assert hist_cuda.choose_block(28, 128, 256, 2)[1] < 128
    g = torch.from_numpy(gpair).cuda()
    torch.testing.assert_close(hist_cuda.build_histogram_cuda(b, g, p, **kw),
                               hist_cuda.build_histogram_plain(b, g, p, **kw),
                               rtol=1e-4, atol=1e-4)
    gq = _limbs(gpair)
    assert torch.equal(hist_cuda.build_histogram_q_cuda(b, gq, p, **kw),
                       hist_cuda.build_histogram_q_plain(b, gq, p, **kw))


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
    hist_cuda.reset_launches()
    card = xtt.train(params, xtt.DMatrix(X, label=y), 4, verbose_eval=False)
    # depths 0-2 build, depth 3 does not
    assert hist_cuda.launches == {"hist_f32": 4 * 3, "hist_q": 0}
    cpu = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), 4,
                    verbose_eval=False, device="cpu")
    for a, b in zip(card.trees, cpu.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
    np.testing.assert_allclose(card.predict(xtt.DMatrix(X)),
                               cpu.predict(xtt.DMatrix(X, device="cpu")),
                               atol=1e-4)


def _data(R=20_000, F=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) * (X[:, 2] > 0)
         > 0).astype(np.float32)
    return X, y


@needs_cuda
@pytest.mark.parametrize("det", [0, 1])
def test_deep_trees_train_on_both_histograms(det):
    """max_depth = 10: the levels of 128 and 256 nodes run node-tiled."""
    X, y = _data()
    params = {"objective": "binary:logistic", "max_depth": 10,
              "max_bin": 256, "deterministic_histogram": det}
    hist_cuda.reset_launches()
    bst = xtt.train(params, xtt.DMatrix(X, label=y), 2, verbose_eval=False)
    name = "hist_q" if det else "hist_f32"
    assert hist_cuda.launches[name] == 2 * 10
    assert max(t.max_depth for t in bst.trees) >= 9
    pred = bst.predict(xtt.DMatrix(X))
    assert np.all(np.isfinite(pred))


@needs_cuda
def test_deterministic_training_launches_only_k2_and_repeats_bytes():
    X, y = _data(seed=1)
    params = {"objective": "binary:logistic", "max_depth": 6,
              "max_bin": 256, "deterministic_histogram": 1}
    models = []
    for _ in range(2):
        hist_cuda.reset_launches()
        bst = xtt.train(params, xtt.DMatrix(X, label=y), 3,
                        verbose_eval=False)
        assert hist_cuda.launches == {"hist_f32": 0, "hist_q": 3 * 6}
        models.append(json.dumps(bst.save_raw_dict()))
    assert models[0] == models[1]
