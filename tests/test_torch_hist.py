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


def _choose_block_before(n_features, n_nodes, n_bin, words,
                         smem_budget=220 * 1024):
    """choose_block as node tiling first wrote it: K2's geometry, which this
    file pins, must not move when K1 gets its own planner."""
    cell = n_bin * words * 4
    if n_nodes * cell <= smem_budget:
        max_fg = smem_budget // (n_nodes * cell)
        n_groups = -(-n_features // max_fg)
        return -(-n_features // n_groups), n_nodes
    n_tiles = -(-n_nodes // (smem_budget // cell))
    return 1, -(-n_nodes // n_tiles)


def _card(limit):
    """A 132-SM card in GPCs of 16-18 SMs as max_clusters: two K1 blocks
    per SM while their shared memory fits twice, clusters no larger than
    ``limit``."""
    def max_clusters(staged, smem, c):
        if c > limit:
            return 0
        per_sm = 2 if 2 * (smem + hist_cuda.STAGE_BYTES + 1024) \
            <= 228 * 1024 else 1
        return sum(g * per_sm // c for g in (18, 18, 16, 16, 16, 16, 16, 16))
    return max_clusters


@pytest.mark.parametrize("n_features", [1, 3, 28, 129])
@pytest.mark.parametrize("n_bin", [16, 64, 256, 1024])
@pytest.mark.parametrize("depth", range(11))
def test_k1_plan_fits_and_splits_every_pair_once(depth, n_bin, n_features):
    """K1's planner at every level of a depth-``depth`` tree (all 2^d nodes
    at stride 1, and the 2^(d-1) left children that a level with
    subtraction builds at stride 2): the block fits the budget beside its row lists, C divides the row
    blocks, and the clusters' flush slices own every (node, feature) pair
    exactly once; K2's choose_block is unchanged."""
    levels = {(1 << depth, 1), (1 << max(0, depth - 1), 2 if depth else 1)}
    for n_nodes, stride in sorted(levels):
        assert hist_cuda.choose_block(n_features, n_nodes, n_bin, 6) == \
            _choose_block_before(n_features, n_nodes, n_bin, 6)
        assert hist_cuda.choose_block(n_features, n_nodes, n_bin, 2) == \
            _choose_block_before(n_features, n_nodes, n_bin, 2)
        for n_rows, limit in ((1 << 20, 8), (1000, 8), (1 << 20, 2)):
            plan = hist_cuda.plan_f32(n_rows, n_features, n_nodes, n_bin,
                                      _card(limit), stride)
            fg, nt = plan.feat_group, plan.node_tile
            # the staged loop exactly where the level skips rows
            assert plan.staged == (stride > 1 or nt < n_nodes)
            assert fg * nt * n_bin * 8 + hist_cuda.STAGE_BYTES \
                <= hist_cuda.SMEM_BUDGET
            assert plan.cluster in hist_cuda.CLUSTERS
            assert plan.cluster <= min(limit, fg * nt)
            assert plan.row_blocks % plan.cluster == 0
            owners = np.zeros((n_nodes, n_features), np.int64)
            for t0 in range(0, n_nodes, nt):
                for f0 in range(0, n_features, fg):
                    fg_b = min(fg, n_features - f0)  # ragged last group
                    nt_b = min(nt, n_nodes - t0)  # ragged last node tile
                    units = np.concatenate([
                        np.arange(r.start, r.stop) for r in
                        (hist_cuda.slice_units(fg_b * nt_b, plan.cluster, k)
                         for k in range(plan.cluster))])
                    np.add.at(owners, (t0 + units // fg_b, f0 + units % fg_b),
                              1)
            assert (owners == 1).all()


def test_k1_plan_fills_one_wave_and_raises_without_room():
    """At the main path's 16-node level (F = 28, B = 256, 1M rows) the plan
    takes 6 features and 16 nodes a block and the cluster size whose wave
    covers the most SMs (clusters of 2 fill all 132 SMs of GPCs of 16-18,
    clusters of 4 or 8 leave 4 idle), the largest such, and as many
    clusters per feature group as one wave holds; a card that holds no
    block raises rather than launching."""
    card = _card(8)
    smem = 6 * 16 * 256 * 8
    assert 2 * card(True, smem, 2) > 8 * card(True, smem, 8)
    plan = hist_cuda.plan_f32(1 << 20, 28, 16, 256, card, 2)
    assert plan == hist_cuda.Plan(6, 16, 2 * (66 // 5), 2,
                                     hist_cuda.THREADS, True)
    even = hist_cuda.plan_f32(1 << 20, 28, 16, 256,
                              lambda staged, smem, c: 128 // c, 2)  # a tie
    assert even.cluster == 8 and even.row_blocks == 8 * (16 // 5)
    root = hist_cuda.plan_f32(1 << 20, 28, 1, 256, card)
    assert (root.feat_group, root.staged) == (28, False)
    with pytest.raises(ValueError, match="holds no block"):
        hist_cuda.plan_f32(1 << 20, 28, 16, 256, lambda *a: 0, 2)


def _plan_f32_before(n_rows, n_features, n_nodes, n_bin, max_clusters,
                     stride=1):
    """plan_f32 as K1's redesign first wrote it: K1's plans must not move
    when K2 gets its planner."""
    budget = 220 * 1024 - 32 * 95 * 8
    fg, nt = _choose_block_before(n_features, n_nodes, n_bin, 2, budget)
    smem = fg * nt * n_bin * 8
    n_tiles = -(-n_nodes // nt)
    n_cols = -(-n_features // fg) * n_tiles
    staged = stride > 1 or n_tiles > 1
    wave = {c: c * max_clusters(staged, smem, c) for c in (8, 4, 2, 1)
            if c <= fg * nt}
    cluster = max(wave, key=lambda c: (wave[c], c))
    per_col = min(wave[cluster] // cluster // n_cols,
                  -(-n_rows // (cluster * 1024)))
    return (fg, nt, cluster * max(1, per_col), cluster, 1024, staged)


def _owners(plan, n_nodes, n_features):
    """How many flush slices of ``plan``'s clusters own each (node,
    feature) pair."""
    fg, nt = plan.feat_group, plan.node_tile
    owners = np.zeros((n_nodes, n_features), np.int64)
    for t0 in range(0, n_nodes, nt):
        for f0 in range(0, n_features, fg):
            fg_b = min(fg, n_features - f0)  # ragged last group
            nt_b = min(nt, n_nodes - t0)  # ragged last node tile
            units = np.concatenate([
                np.arange(r.start, r.stop) for r in
                (hist_cuda.slice_units(fg_b * nt_b, plan.cluster, k)
                 for k in range(plan.cluster))])
            np.add.at(owners, (t0 + units // fg_b, f0 + units % fg_b), 1)
    return owners


@pytest.mark.parametrize("n_features", [1, 3, 28, 129])
@pytest.mark.parametrize("n_bin", [16, 64, 256, 1024])
@pytest.mark.parametrize("depth", range(11))
def test_k2_plan_fits_and_splits_every_pair_once(depth, n_bin, n_features):
    """K2's planner at every level of a depth-``depth`` tree, as K1's test
    above: the block fits the budget beside its row lists with its 24-byte
    cells, C divides the row blocks, the staged loop exactly where the
    level skips rows, and every (node, feature) pair is flushed by exactly
    one slice; K1's plans and choose_block(..., 2) are what they were
    before."""
    levels = {(1 << depth, 1), (1 << max(0, depth - 1), 2 if depth else 1)}
    for n_nodes, stride in sorted(levels):
        assert hist_cuda.choose_block(n_features, n_nodes, n_bin, 2) == \
            _choose_block_before(n_features, n_nodes, n_bin, 2)
        for n_rows, limit in ((1 << 20, 8), (1000, 8), (1 << 20, 2)):
            assert tuple(hist_cuda.plan_f32(
                n_rows, n_features, n_nodes, n_bin, _card(limit),
                stride)) == _plan_f32_before(n_rows, n_features, n_nodes,
                                             n_bin, _card(limit), stride)
            plan = hist_cuda.plan_q(n_rows, n_features, n_nodes, n_bin, 6,
                                    _card(limit), stride)
            fg, nt = plan.feat_group, plan.node_tile
            assert fg * nt * n_bin * 24 + hist_cuda.STAGE_BYTES \
                <= hist_cuda.SMEM_BUDGET
            assert plan.staged == (stride > 1 or nt < n_nodes)
            assert plan.threads == hist_cuda.THREADS
            assert plan.cluster in hist_cuda.CLUSTERS
            assert plan.cluster <= min(limit, fg * nt)
            assert plan.row_blocks % plan.cluster == 0
            assert plan.row_blocks <= max(plan.cluster, -(-n_rows // (
                hist_cuda.THREADS)))
            assert (_owners(plan, n_nodes, n_features) == 1).all()


def test_k2_plan_at_the_main_levels():
    """F = 28, B = 256, 1M rows on a 132-SM card: the feature groups and
    node tiles K2 had before (28, 28, 14, 7, 4, 2 features at the six
    depth-6 levels; 32 of 128 nodes), now beside the row lists; one thread
    per row at the root, the staged loop below; clusters of 2 and one wave
    of row blocks where one block fits an SM; a card that holds no block
    raises rather than launching."""
    card = _card(8)
    want = {(1, 1): (28, 1, False), (1, 2): (28, 1, True),
            (2, 2): (14, 2, True), (4, 2): (7, 4, True),
            (8, 2): (4, 8, True), (16, 2): (2, 16, True),
            (128, 2): (1, 32, True)}
    for (n_nodes, stride), (fg, nt, staged) in want.items():
        plan = hist_cuda.plan_q(1 << 20, 28, n_nodes, 256, 6, card, stride)
        assert (plan.feat_group, plan.node_tile, plan.staged) == \
            (fg, nt, staged)
        assert (fg, nt) == _choose_block_before(28, n_nodes, 256, 6)
    root = hist_cuda.plan_q(1 << 20, 28, 1, 256, 6, card)
    assert root == hist_cuda.Plan(28, 1, 132, 2, hist_cuda.THREADS, False)
    sixteen = hist_cuda.plan_q(1 << 20, 28, 16, 256, 6, card, 2)
    assert (sixteen.cluster, sixteen.row_blocks) == (2, 2 * (66 // 14))
    with pytest.raises(ValueError, match="holds no block of hist_q"):
        hist_cuda.plan_q(1 << 20, 28, 16, 256, 6, lambda *a: 0, 2)


def _class_owners(plan, n_nodes, n_features, n_classes):
    """How many lanes of the class axis's blocks own each (class, node,
    feature, channel): block (feature group x, class group z) at node t
    (one node a block), accumulating warp u, lane -> (fsub, k, c) by
    class_axis_lanes."""
    owners = np.zeros((n_classes, n_nodes, n_features, 2), np.int64)
    lanes = [(lane, own) for lane, own in
             enumerate(hist_cuda.class_axis_lanes(plan)) if own is not None]
    assert len({own for _, own in lanes}) == len(lanes)
    fsub = np.array([own[0] for _, own in lanes])
    k = np.array([own[1] for _, own in lanes])
    ch = np.array([own[2] for _, own in lanes])
    n_fg = -(-n_features // plan.feat_group)
    n_cg = -(-n_classes // plan.class_group)
    x, z, u = np.meshgrid(np.arange(n_fg), np.arange(n_cg),
                          np.arange(plan.units), indexing="ij")
    f = (x[..., None] * plan.feat_group + u[..., None] * plan.feats_per_warp
         + fsub)
    kk = z[..., None] * plan.class_group + k
    keep = (f < n_features) & (k < plan.class_group) & (kk < n_classes)
    f, kk = f[keep], kk[keep]
    c = np.broadcast_to(ch, keep.shape)[keep]
    for t in range(0, n_nodes, plan.node_tile):
        np.add.at(owners, (kk, t, f, c), 1)
    return owners


@pytest.mark.parametrize("K", [1, 3, 7])
@pytest.mark.parametrize("n_features", [1, 3, 28, 54])
@pytest.mark.parametrize("n_bin", [16, 256, 1024])
@pytest.mark.parametrize("depth", range(11))
def test_class_axis_plan_owns_every_cell_once(depth, n_bin, n_features, K):
    """K1's class axis at every level of a depth-``depth`` tree, both
    layouts: every (class, node, feature, channel) cell is owned by
    exactly one lane of one block, each (unit, bin) row of a block's
    cells is flushed by exactly one block of its cluster, the lanes of a
    warp fall on distinct banks (bin rows of a power of two words), the
    block's cells and staged chunks fit the budget beside K1's row lists
    and a chunk at most three groups a staging thread,
    C divides the row blocks, the levels that skip rows are bucketed (one
    class a block with a pos per class, all K together otherwise), and
    a block sums no more rows of a cell than K1's plan (pinned to the
    frozen planner above) gives a block at the same level, nor, bucketed,
    more of a node's rows than K1's block finds in that node (above four
    staged chunks)."""
    levels = {(1 << depth, 1), (1 << max(0, depth - 1), 2 if depth else 1)}
    for n_nodes, stride in sorted(levels):
        for n_rows, limit in ((1 << 20, 8), (581_012, 2), (1000, 8)):
            k1 = _plan_f32_before(n_rows, n_features, n_nodes, n_bin,
                                  _card(limit), stride)
            for shared in (False, True):
                plan = hist_cuda.plan_f32_multi(
                    n_rows, n_features, n_nodes, n_bin, K, _card(limit),
                    stride, shared_pos=shared)
                assert plan.bucketed == (stride > 1 or n_nodes > 1)
                kg = 1 if plan.bucketed and not shared else K
                assert plan.class_group == kg and plan.node_tile == 1
                assert plan.feat_group % plan.feats_per_warp == 0
                assert 1 <= plan.units <= hist_cuda.MULTI_MAX_UNITS
                row = plan.cell_row
                assert plan.feats_per_warp * 2 * kg <= row <= 32
                assert row & (row - 1) == 0
                assert hist_cuda.multi_smem(
                    plan.units, n_bin, row, kg, plan.feats_per_warp, 2,
                    shared, plan.bucketed) \
                    <= hist_cuda.SMEM_BUDGET - hist_cuda.STAGE_BYTES
                assert plan.threads == hist_cuda.MULTI_THREADS
                assert hist_cuda.multi_roles(
                    plan.units, kg, plan.feats_per_warp, shared,
                    plan.bucketed) <= hist_cuda.MULTI_ROLES * (
                        plan.threads - 32 * plan.units)
                assert plan.cluster in hist_cuda.CLUSTERS
                assert plan.cluster <= limit
                assert plan.row_blocks % plan.cluster == 0
                k1_rows = -(-n_rows // k1[2])
                assert plan.rows_per_block <= k1_rows
                floor = 4 * hist_cuda.multi_chunk(shared, plan.bucketed)
                assert plan.k1_rows == k1_rows
                if plan.bucketed:  # a node's share of K1's block
                    for count in (0, 1, 100, n_rows // 7, n_rows):
                        rows = hist_cuda.class_axis_item_rows(
                            plan, count, n_rows, shared)
                        assert rows <= k1_rows
                        assert rows <= max(floor,
                                           -(-count * k1_rows // n_rows))
                assert (_class_owners(plan, n_nodes, n_features, K)
                        == 1).all()
                flushed = np.concatenate([
                    np.arange(r.start, r.stop) for r in
                    (hist_cuda.slice_units(plan.units * n_bin, plan.cluster,
                                           rank)
                     for rank in range(plan.cluster))])
                assert np.array_equal(flushed,
                                      np.arange(plan.units * n_bin))


def test_class_axis_plan_at_covertype_fits_the_card():
    """Covertype's K = 7, F = 54, B = 256 at 581,012 rows: every level of
    a depth-8 lockstep round fits the card's clusters, with at least one
    cluster of row blocks per (class, feature group, node tile)."""
    card = _card(8)
    for d in range(8):
        n_nodes, stride = (1, 1) if d == 0 else (1 << (d - 1), 2)
        plan = hist_cuda.plan_f32_multi(581_012, 54, n_nodes, 256, 7, card,
                                        stride)
        cols = -(-54 // plan.feat_group) * -(-n_nodes // plan.node_tile) * 7
        assert plan.row_blocks >= plan.cluster
        assert cols * plan.row_blocks // plan.cluster >= 1
        assert plan.feat_group * plan.node_tile * 256 * 8 \
            + hist_cuda.STAGE_BYTES <= hist_cuda.SMEM_BUDGET
        # at the root the seven classes share a block, two features a warp
        # in bin rows of 32 words: five warps of 32 KB cells beside the
        # staged chunks; below it a block takes one class, 16 features a
        # warp: four warps hold all 54
        want = (7, 2, 32, 5) if d == 0 else (1, 16, 32, 4)
        assert (plan.class_group, plan.feats_per_warp, plan.cell_row,
                plan.units) == want
        assert plan.feat_group >= 54 or d == 0
        assert hist_cuda.multi_smem(plan.units, 256, 32, plan.class_group,
                                    plan.feats_per_warp, 2, False,
                                    plan.bucketed) \
            <= hist_cuda.SMEM_BUDGET - hist_cuda.STAGE_BYTES


def test_class_axis_dispatch_takes_plain_versions_on_cpu():
    """On CPU tensors the class-axis dispatchers run the plain versions
    and launch nothing."""
    rng = np.random.default_rng(2)
    bins = torch.from_numpy(rng.integers(0, 17, size=(300, 4))).to(
        torch.uint8)
    g = torch.from_numpy(rng.normal(size=(300, 3, 2)).astype(np.float32))
    pos = torch.zeros(300, dtype=torch.int32)
    before = dict(hist_cuda.launches)
    a = hist_cuda.build_level_hist_multi(bins, g, pos, node0=0, n_nodes=1,
                                         n_bin=16)
    b = hist_cuda.build_histogram_multi(bins, g, pos.expand(3, 300), node0=0,
                                        n_nodes=1, n_bin=16)
    assert hist_cuda.launches == before
    torch.testing.assert_close(a.permute(3, 0, 1, 2, 4), b, rtol=1e-6,
                               atol=1e-6)
