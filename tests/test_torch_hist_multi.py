"""K1's class axis (csrc/hist_multi.cu): its index logic on the CPU.

The kernel runs only on the card (tests/test_torch_hist_cuda.py holds it
against the plain versions there).  Here its wrapper module's PyTorch
models of what it computes are held against the plain versions and the
reference: the lane -> (feature, class, channel) ownership map
(``class_axis_lanes``: no two lanes on one cell, the lanes of a warp on
distinct banks whatever bins they hold), the node bucketing (``bucket_level``:
count, scan and scatter), the items (``class_axis_items``) and the whole
walk (``class_axis_model``: each block's rows, item by item, summed with the
plain histogram and flushed lane by lane), which must give
build_histogram_multi_plain's and build_level_hist_multi_plain's histograms
at rtol/atol 1e-5 (the same f32 sums in another order) and the reference's
build_histogram_multi and build_level_hist_multi (XLA on the CPU) at 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_tpu.ops.histogram import build_histogram_multi as ref_multi
from xgboost_tpu.tree.grow_multi import build_level_hist_multi as ref_level
from xgboost_tpu_torch.ops import hist_cuda


def _card(limit):
    """A 132-SM card as max_clusters: one block an SM, two where the
    block's shared memory fits twice, clusters no larger than ``limit``."""
    def max_clusters(staged, smem, c):
        if c > limit:
            return 0
        per_sm = 2 if 2 * (smem + 1024) <= 228 * 1024 else 1
        return sum(g * per_sm // c for g in (18, 18, 16, 16, 16, 16, 16, 16))
    return max_clusters


@pytest.mark.parametrize("n_bin", [256, 4096])
@pytest.mark.parametrize("K", [1, 2, 3, 5, 7, 8, 11, 16])
def test_lanes_own_distinct_cells_on_distinct_banks(K, n_bin):
    """Every lane of an accumulating warp owns its own (feature, class,
    channel), idle lanes only past feats_per_warp features; a lane's cell
    of bin b sits at b * cell_row + lane, so lanes holding any bins fall
    on 32 distinct banks (cell_row a power of two).  At 4096 bins a warp
    takes one feature in rows of the next power of two above 2 KG."""
    plan = hist_cuda.plan_f32_multi(1 << 16, 28, 1, n_bin, K, _card(8))
    lanes = hist_cuda.class_axis_lanes(plan)
    owned = [own for own in lanes if own is not None]
    assert len(set(owned)) == len(owned) \
        == plan.feats_per_warp * 2 * plan.class_group
    assert all(own is None for own in lanes[len(owned):])
    assert {own[1] for own in owned} == set(range(plan.class_group))
    if n_bin == 4096:
        assert plan.feats_per_warp == 1
        assert plan.cell_row == 1 << (2 * plan.class_group - 1).bit_length()
    else:
        assert (plan.class_group, plan.cell_row) == (K, 32)
    rng = np.random.default_rng(K)
    for _ in range(50):
        b = rng.integers(0, n_bin, size=plan.feats_per_warp)
        banks = [(b[fsub] * plan.cell_row + lane) % 32
                 for lane, (fsub, _, _) in enumerate(owned)]
        assert len(set(banks)) == len(banks)


def _pos(rng, shape, node0, n_nodes, stride, skew=0.0):
    """pos over node ids node0 - 1 .. node0 + stride * n_nodes (some
    outside the level, some pad rows at -1), a share ``skew`` in the
    level's first node."""
    p = rng.integers(node0 - 1, node0 + stride * n_nodes + 1, size=shape)
    p[rng.random(shape) < skew] = node0
    p[rng.random(shape) < 0.05] = -1
    return p.astype(np.int32)


@pytest.mark.parametrize("node0,n_nodes,stride", [(1, 1, 2), (7, 8, 1),
                                                  (15, 8, 2)])
def test_bucket_level_lists_each_pair_once(node0, n_nodes, stride):
    """Each list's rows of node t are the rows whose pos is that node, in
    row order, at starts[l, t]; past a list's level rows, -1."""
    rng = np.random.default_rng(node0)
    L, R = 3, 700
    pos = torch.from_numpy(_pos(rng, (L, R), node0, n_nodes, stride))
    counts, starts, rows = hist_cuda.bucket_level(
        pos, node0=node0, n_nodes=n_nodes, stride=stride)
    assert counts.shape == starts.shape == (L, n_nodes)
    assert rows.shape == (L * R,)
    for l in range(L):
        n_in = 0
        for t in range(n_nodes):
            want = torch.nonzero(pos[l] == node0 + stride * t).flatten()
            at = int(starts[l, t])
            assert at == l * R + n_in
            assert torch.equal(rows[at:at + int(counts[l, t])], want)
            n_in += len(want)
        assert (rows[l * R + n_in:(l + 1) * R] == -1).all()


def test_items_take_each_nodes_share_of_k1s_block():
    """A (class group, node) pair's items cover its list in spans of
    cluster blocks of the node's share of K1's block (count * k1_rows /
    n_rows rows a block), at least four staged chunks and at most
    rows_per_block; the flat prefix runs class group by class group, node
    by node; empty nodes take none."""
    plan = hist_cuda.MultiPlan(64, 1, 1, 16, 32, 1000, 4, 2, 640, True, 1000)
    counts = torch.tensor([[5, 0, 9000, 100], [2000, 0, 17, 0],
                           [800, 0, 0, 3000]])
    rows = [[hist_cuda.class_axis_item_rows(plan, int(c), 10000)
             for c in row] for row in counts]
    assert rows == [[256, 256, 900, 256], [256, 256, 256, 256],
                    [256, 256, 256, 300]]
    items = hist_cuda.class_axis_items(counts, plan, 3, 10000)
    assert items.tolist() == [0, 1, 1, 6, 7, 11, 11, 12, 12, 14, 14, 14, 19]
    shared = hist_cuda.class_axis_items(
        counts[:1], plan._replace(class_group=3), 3, 10000, shared_pos=True)
    assert shared.tolist() == [0, 1, 1, 6, 7]
    whole = plan._replace(rows_per_block=100)
    assert hist_cuda.class_axis_item_rows(whole, 9000, 10000) == 100


LEVELS = [(0, 1, 1), (1, 1, 2), (3, 4, 1), (7, 4, 2), (31, 16, 2)]


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("K", [1, 3, 7])
@pytest.mark.parametrize("node0,n_nodes,stride", LEVELS)
def test_model_walk_is_the_plain_and_reference_histogram(node0, n_nodes,
                                                         stride, K, shared):
    """The kernel's walk, block by block and item by item (rows a block
    below K1's, so several items a node and ranks a cluster), unbucketed
    at the root and bucketed below it: the plain versions' histograms and
    the reference's."""
    rng = np.random.default_rng(node0 + 10 * K + shared)
    R, F, B = 1500, 9, 16
    shape = (R,) if shared else (K, R)
    bins = rng.integers(0, B + 1, size=(R, F)).astype(np.uint8)
    gpair = rng.normal(size=(R, K, 2)).astype(np.float32)
    pos = _pos(rng, shape, node0, n_nodes, stride, skew=0.5)
    plan = hist_cuda.plan_f32_multi(R, F, n_nodes, B, K, _card(4), stride,
                                    shared_pos=shared)
    assert plan.bucketed == (stride > 1 or n_nodes > 1)
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=B, stride=stride)
    tb, tg, tp = (torch.from_numpy(a) for a in (bins, gpair, pos))
    got = hist_cuda.class_axis_model(tb, tg, tp, plan, shared_pos=shared,
                                     **kw)
    if shared:
        plain = hist_cuda.build_level_hist_multi_plain(tb, tg, tp, **kw)
        ref = ref_level(jnp.asarray(bins), jnp.asarray(gpair),
                        jnp.asarray(pos), n_targets=K, **kw)
    else:
        plain = hist_cuda.build_histogram_multi_plain(tb, tg, tp, **kw)
        ref = ref_multi(jnp.asarray(bins), jnp.asarray(gpair),
                        jnp.asarray(pos), node0, n_nodes=n_nodes, n_bin=B,
                        stride=stride)
    assert got.shape == plain.shape
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("K", [17, 24, 33])
def test_model_walk_in_class_groups_with_empty_nodes(K, shared):
    """More classes than a warp's 16 (class groups, a ragged last one at
    17 and 33 under a shared pos; one class a block with a pos per class)
    at a 16-node level whose odd nodes are empty: the plain histograms."""
    rng = np.random.default_rng(K)
    R, F, B = 1200, 5, 16
    shape = (R,) if shared else (K, R)
    node = 2 * rng.integers(0, 8, size=shape)
    pos = (31 + 2 * node).astype(np.int32)
    pos[rng.random(shape) < 0.05] = -1
    bins = rng.integers(0, B + 1, size=(R, F)).astype(np.int16)
    gpair = rng.normal(size=(R, K, 2)).astype(np.float32)
    plan = hist_cuda.plan_f32_multi(R, F, 16, B, K, _card(2), 2,
                                    shared_pos=shared)
    assert plan.class_group == (-(-K // -(-K // 16)) if shared else 1)
    assert -(-K // plan.class_group) >= 2
    kw = dict(node0=31, n_nodes=16, n_bin=B, stride=2)
    tb, tg, tp = (torch.from_numpy(a) for a in (bins, gpair, pos))
    got = hist_cuda.class_axis_model(tb, tg, tp, plan, shared_pos=shared,
                                     **kw)
    plain = (hist_cuda.build_level_hist_multi_plain if shared
             else hist_cuda.build_histogram_multi_plain)(tb, tg, tp, **kw)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    odd = got[1::2] if shared else got[:, 1::2]
    assert not odd.any()

