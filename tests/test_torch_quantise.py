"""Port parity for deterministic_histogram=1: the fixed-point quantisation
(xgboost_tpu_torch/ops/quantise.py) and the plain version of the exact limb
histogram K2 held against xgboost_tpu's on the same numpy inputs.  Every
comparison is bitwise (tolerance 0): the limbs and their int32 sums are
integers, and dequantise is the same f32 ops in the same order."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xgboost_tpu.ops import quantise as ref
from xgboost_tpu.ops.hist_pallas import build_histogram_pallas_q
from xgboost_tpu.tree.grow import init_tree_state as ref_init_tree_state
from xgboost_tpu_torch.ops import hist_cuda
from xgboost_tpu_torch.ops import quantise as q
from xgboost_tpu_torch.tree.grow import init_tree_state


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _gpair(R, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(R, 2)).astype(np.float32)
    g[:, 1] = np.abs(g[:, 1])
    valid = rng.random(R) < 0.97
    return g, valid


def test_rho_and_limbs_bitwise():
    """100,000 x 2 gradients: a scale 1 ulp off would change ~15% of the
    limbs here."""
    g, valid = _gpair(100_000, 0)
    want_rho = ref.local_rho(jnp.asarray(g), jnp.asarray(valid))
    rho = q.local_rho(torch.from_numpy(g), torch.from_numpy(valid))
    np.testing.assert_array_equal(_bits(rho.numpy()), _bits(want_rho))
    want = np.asarray(ref.quantise_gpair(jnp.asarray(g), want_rho))
    got = q.quantise_gpair(torch.from_numpy(g), rho).numpy()
    assert got.dtype == np.int8 and got.shape == (100_000, 2, 3)
    np.testing.assert_array_equal(got, want)


def test_dequantise_and_node_sums_bitwise():
    rng = np.random.default_rng(1)
    limbs = rng.integers(-2**27, 2**27, size=(64, 5, 2, 3)).astype(np.int32)
    rho = np.float32([0.73, 1.9])
    np.testing.assert_array_equal(
        _bits(q.dequantise(torch.from_numpy(limbs), torch.from_numpy(rho))),
        _bits(ref.dequantise(jnp.asarray(limbs), jnp.asarray(rho))))
    g, valid = _gpair(5000, 2)
    gq = q.quantise_gpair(torch.from_numpy(g),
                          q.local_rho(torch.from_numpy(g),
                                      torch.from_numpy(valid)))
    pos = rng.integers(-1, 7, size=5000).astype(np.int32)
    want = ref.node_sums_q(jnp.asarray(gq.numpy()), jnp.asarray(pos),
                           jnp.int32(3), jnp.arange(4, dtype=jnp.int32))
    got = q.node_sums_q(gq, torch.from_numpy(pos), 3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantised_root_state_bitwise():
    g, valid = _gpair(3000, 3)
    rstate = ref_init_tree_state(jnp.asarray(g), jnp.asarray(valid),
                                 max_nodes=7)
    rgq, rrho, rstate = ref.prepare_quantised(jnp.asarray(g),
                                              jnp.asarray(valid), rstate)
    state = init_tree_state(torch.from_numpy(g), torch.from_numpy(valid),
                            max_nodes=7)
    gq, rho, state = q.prepare_quantised(torch.from_numpy(g),
                                         torch.from_numpy(valid), state)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(rgq))
    np.testing.assert_array_equal(_bits(rho.numpy()), _bits(rrho))
    np.testing.assert_array_equal(_bits(state.totals.numpy()),
                                  _bits(rstate.totals))


def _hist_inputs(R, F, B, node0, span, seed, dtype):
    """bins with the missing sentinel B, pad rows at pos -1 and rows on
    node ids outside the level."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B + 1, size=(R, F)).astype(dtype)
    g, valid = _gpair(R, seed)
    gq = np.array(ref.quantise_gpair(
        jnp.asarray(g), ref.local_rho(jnp.asarray(g), jnp.asarray(valid))))
    pos = rng.integers(node0 - 1, node0 + span + 1, size=R).astype(np.int32)
    pos[-R // 16:] = -1
    return bins, gq, pos


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32])
@pytest.mark.parametrize("node0,n_nodes,stride", [
    (0, 1, 1), (3, 4, 1), (7, 4, 2), (1, 1, 2)])
def test_limb_histogram_matches_reference_bitwise(dtype, node0, n_nodes,
                                                  stride):
    B = 16
    bins, gq, pos = _hist_inputs(3000, 5, B, node0, stride * n_nodes,
                                 node0 + stride, dtype)
    want = np.asarray(ref.hist_accumulate_q(
        jnp.asarray(bins), jnp.asarray(gq), jnp.asarray(pos),
        jnp.int32(node0), n_nodes, B, chunk=512, stride=stride))
    args = (torch.from_numpy(bins), torch.from_numpy(gq),
            torch.from_numpy(pos))
    got = q.hist_accumulate_q(*args, node0, n_nodes, B, stride=stride)
    assert got.dtype == torch.int32 and got.shape == (n_nodes, 5, B, 2, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.any()
    # the dispatcher takes the plain version for CPU tensors, no launch
    before = dict(hist_cuda.launches)
    np.testing.assert_array_equal(hist_cuda.build_histogram_q(
        *args, node0=node0, n_nodes=n_nodes, n_bin=B, stride=stride).numpy(),
        want)
    assert hist_cuda.launches == before


@pytest.mark.parametrize("node0,n_nodes,stride", [(0, 4, 1), (3, 2, 2)])
def test_limb_histogram_matches_pallas_interpret_bitwise(node0, n_nodes,
                                                         stride):
    """Against K2 itself, run as tests/test_quantised_hist.py runs it off
    the TPU (interpret mode, row_tile 512, feat_group 2)."""
    B = 16
    bins, gq, pos = _hist_inputs(2500, 5, B, node0, stride * n_nodes, 11,
                                 np.int32)
    want = np.asarray(build_histogram_pallas_q(
        jnp.asarray(bins), jnp.asarray(gq), jnp.asarray(pos), node0=node0,
        n_nodes=n_nodes, n_bin=B, stride=stride, interpret=True,
        row_tile=512, feat_group=2))
    got = q.hist_accumulate_q(torch.from_numpy(bins), torch.from_numpy(gq),
                              torch.from_numpy(pos), node0, n_nodes, B,
                              stride=stride)
    np.testing.assert_array_equal(got.numpy(), want)


def test_missing_and_pad_rows_add_nothing():
    bins, gq, pos = _hist_inputs(1024, 4, 16, 0, 1, 5, np.int16)
    bins[:] = 16  # every value missing
    assert not q.hist_accumulate_q(torch.from_numpy(bins),
                                   torch.from_numpy(gq),
                                   torch.from_numpy(pos), 0, 1, 16).any()
    bins, gq, pos = _hist_inputs(1024, 4, 16, 0, 1, 6, np.int16)
    pos[:] = -1  # every row padding
    assert not q.hist_accumulate_q(torch.from_numpy(bins),
                                   torch.from_numpy(gq),
                                   torch.from_numpy(pos), 0, 1, 16).any()


def test_row_budget():
    q.check_row_budget(q.MAX_ROWS)
    with pytest.raises(ValueError, match="deterministic_histogram"):
        q.check_row_budget(q.MAX_ROWS + 1)
    assert q.MAX_ROWS == ref.MAX_ROWS and q.QUANT_BITS == ref.QUANT_BITS
