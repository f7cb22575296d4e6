"""Port parity: the per-level histogram.  The plain PyTorch version is held
against xgboost_tpu's XLA histogram and its Pallas kernel (in interpret
mode, as tests/test_hist_kernels.py runs it) at rtol/atol 1e-4: the same f32
sums in another order.  The CUDA kernel itself is tested on the card by
tests/test_torch_hist_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xgboost_tpu.ops.hist_pallas import build_histogram_pallas
from xgboost_tpu.ops.histogram import build_histogram as ref_build_histogram
from xgboost_tpu.ops.histogram import combine_sibling_hists as ref_combine
from xgboost_tpu.ops.histogram import node_sums as ref_node_sums
from xgboost_tpu_torch.ops import hist_cuda
from xgboost_tpu_torch.ops.histogram import (build_histogram,
                                             combine_sibling_hists, node_sums)


def _mk(R=1024, F=7, B=16, node0=3, span=8, seed=0, dtype=np.int16):
    """bins with the missing sentinel B, pad rows at pos -1, rows spread
    over node ids node0-1 .. node0+span (some outside the level)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B + 1, size=(R, F)).astype(dtype)
    gpair = rng.normal(size=(R, 2)).astype(np.float32)
    pos = rng.integers(node0 - 1, node0 + span + 1, size=R).astype(np.int32)
    pos[-100:] = -1
    return bins, gpair, pos


CASES = [  # (node0, n_nodes, stride)
    (3, 4, 1), (0, 1, 1), (7, 4, 2), (3, 2, 2)]


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("node0,n_nodes,stride", CASES)
def test_plain_matches_reference_xla(dtype, node0, n_nodes, stride):
    bins, gpair, pos = _mk(node0=node0, span=stride * n_nodes, dtype=dtype,
                           seed=node0 + stride)
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=16, stride=stride)
    ref = np.asarray(ref_build_histogram(
        jnp.asarray(bins), jnp.asarray(gpair), jnp.asarray(pos), **kw))
    got = build_histogram(torch.from_numpy(bins), torch.from_numpy(gpair),
                          torch.from_numpy(pos), **kw).numpy()
    assert got.shape == (n_nodes, 7, 16, 2)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("stride", [1, 2])
def test_plain_matches_reference_pallas_interpret(dtype, stride):
    bins, gpair, pos = _mk(dtype=dtype, span=4 * stride, seed=3)
    kw = dict(node0=3, n_nodes=4, n_bin=16, stride=stride)
    ref = np.asarray(build_histogram_pallas(
        jnp.asarray(bins), jnp.asarray(gpair), jnp.asarray(pos),
        interpret=True, **kw))
    got = build_histogram(torch.from_numpy(bins), torch.from_numpy(gpair),
                          torch.from_numpy(pos), **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_missing_and_pad_rows_add_nothing():
    bins, gpair, pos = _mk(seed=5)
    bins[:, :] = 16  # every value missing
    out = build_histogram(torch.from_numpy(bins), torch.from_numpy(gpair),
                          torch.from_numpy(pos), node0=3, n_nodes=4, n_bin=16)
    assert not out.any()
    bins, gpair, pos = _mk(seed=6)
    pos[:] = -1  # every row padding
    out = build_histogram(torch.from_numpy(bins), torch.from_numpy(gpair),
                          torch.from_numpy(pos), node0=0, n_nodes=1, n_bin=16)
    assert not out.any()


def test_combine_and_node_sums_match_reference():
    rng = np.random.default_rng(9)
    left = rng.normal(size=(4, 5, 16, 2)).astype(np.float32)
    parent = rng.normal(size=(4, 5, 16, 2)).astype(np.float32)
    alive = np.array([1, 1, 0, 0, 1, 0, 1, 1], bool)
    ref = np.asarray(ref_combine(jnp.asarray(left), jnp.asarray(parent),
                                 jnp.asarray(alive)))
    got = combine_sibling_hists(torch.from_numpy(left),
                                torch.from_numpy(parent),
                                torch.from_numpy(alive)).numpy()
    np.testing.assert_array_equal(got, ref)
    _, gpair, pos = _mk(seed=10)
    ref = np.asarray(ref_node_sums(jnp.asarray(gpair), jnp.asarray(pos),
                                   node0=3, n_nodes=4))
    got = node_sums(torch.from_numpy(gpair), torch.from_numpy(pos),
                    node0=3, n_nodes=4).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_dispatch_takes_plain_version_on_cpu():
    bins, gpair, pos = _mk(seed=11)
    args = (torch.from_numpy(bins), torch.from_numpy(gpair),
            torch.from_numpy(pos))
    kw = dict(node0=3, n_nodes=4, n_bin=16)
    before = dict(hist_cuda.launches)
    np.testing.assert_array_equal(hist_cuda.build_histogram(*args, **kw),
                                  hist_cuda.build_histogram_plain(*args, **kw))
    assert hist_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        hist_cuda.build_histogram_cuda(*args, **kw)


@pytest.mark.parametrize("n_nodes,want_fg", [(1, 28), (2, 28), (4, 14),
                                             (8, 10), (16, 6)])
def test_feature_group_fits_shared_memory(n_nodes, want_fg):
    """F=28, B=256, K1 (2 words a cell): FG from the 220 KB budget,
    balanced over the groups, all nodes in one block."""
    fg, nt = hist_cuda.choose_block(28, n_nodes, 256, 2)
    assert (fg, nt) == (want_fg, n_nodes)
    assert fg * n_nodes * 256 * 2 * 4 <= hist_cuda.SMEM_BUDGET


@pytest.mark.parametrize("words,n_nodes,want", [
    (2, 128, (1, 64)), (2, 256, (1, 86)), (6, 1, (28, 1)), (6, 16, (2, 16)),
    (6, 64, (1, 32)), (6, 128, (1, 32))])
def test_nodes_are_tiled_when_one_feature_does_not_fit(words, n_nodes, want):
    """Deep levels split their nodes over blocks instead of raising (K1 from
    N = 128 at 256 bins, K2 with 6 words a cell from N = 64); a block
    never exceeds the budget; only one (node, feature) pair over the
    budget raises."""
    fg, nt = hist_cuda.choose_block(28, n_nodes, 256, words)
    assert (fg, nt) == want
    assert fg * nt * 256 * words * 4 <= hist_cuda.SMEM_BUDGET
    limit = hist_cuda.SMEM_BUDGET // (words * 4)  # bins of one cell
    assert hist_cuda.choose_block(28, 128, limit, words) == (1, 1)
    with pytest.raises(ValueError):
        hist_cuda.choose_block(28, 1, limit + 1, words)
