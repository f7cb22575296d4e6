"""The CUDA histogram kernels on the card: K1 (csrc/hist.cu) held against
its plain PyTorch version at rtol/atol 1e-4 (the same f32 sums, added by
atomics in no fixed order) at the six levels of a depth-6 round, at other
widths and row counts, with each cluster size, and a refused cluster launch
raising; K2 (csrc/hist_q.cu) held against its plain version bitwise (exact
int32 sums) at the same levels, widths, row counts and cluster sizes, on
adversarial limbs, and a refused launch raising; both with nodes tiled over
blocks at N = 128, and the trainer's launches of each counted.  K3
(csrc/split_scan.cu) held against its plain version bitwise (the same
fixed summation order and arithmetic) at the six levels of a depth-6 round
and at the best-first grower's N = 2, unconstrained and monotone, with
ties, nodes without a candidate, dead slots and masked features, and a
refused K3 launch raising without leaving an error for the next kernel;
its categorical mode bitwise at the Criteo-shaped main path's levels (39
features, 26 categorical, 128 bins), one-hot and partition, monotone or
not, from the histogram or its limb form, and a categorical training on
the card writing the CPU's model JSON.
K3 also at widths past its chunks and levels, up to the widest it takes.
K1's class axis (csrc/hist_multi.cu) against K plain histograms at
rtol/atol 1e-4, in the lockstep layout (a pos per class, (K, N, F, B, 2))
and the vector-leaf layout (one pos, (N, F, B, K, 2)), at 1 to 16
classes, with each cluster size, in class groups, at a bucketed level
with empty nodes, a refused plan raising, and the lockstep and
vector-leaf trainers launching only it.
K4 (csrc/sigmoid.cu) held against its plain versions bitwise over the f32
range and its edges: the sigmoid, and the binary:logistic gradient pairs
with and without weights and scale_pos_weight.  K5 (csrc/lambdarank.cu)
held against its plain version bitwise at MSLR-like queries, queries of
thousands of docs and of one or two, tied, equal, NaN and signed-zero
scores, queries at and a doc above its shared-memory cap and both in
one launch, k above the query size, k = 1 and each normalisation off,
with the path (sorts in the kernel or in the wrapper) each took;
utils/libm's functions on the card the CPU's bits; ranking training on
the card writing the CPU's model JSON.  Multiclass, forest and
CSR training on the card writing the CPU's model JSON, with the kernels'
launches a level of each tree counted.  Every
test here needs a CUDA device and skips without one; the file imports
neither JAX nor xgboost_tpu, so it runs on a machine that has only
PyTorch."""
import json

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xtt
from xgboost_tpu_torch.ops import hist_cuda, split_cuda
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


# the six levels a depth-6 round builds, and a level built in full
K1_LEVELS = [(0, 1, 1), (1, 1, 2), (3, 2, 2), (7, 4, 2), (15, 8, 2),
             (31, 16, 2), (3, 4, 1)]


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
@pytest.mark.parametrize("node0,n_nodes,stride", K1_LEVELS)
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


def _k1(bins, gpair, pos, dtype=torch.int16):
    return (torch.from_numpy(bins).to(dtype).cuda(),
            torch.from_numpy(gpair).cuda(), torch.from_numpy(pos).cuda())


@needs_cuda
@pytest.mark.parametrize("n_features", [1, 3, 29])
@pytest.mark.parametrize("node0,n_nodes,stride", [(0, 1, 1), (7, 4, 2),
                                                  (31, 16, 2)])
def test_kernel_matches_plain_at_other_widths(n_features, node0, n_nodes,
                                              stride):
    """Feature groups that do not divide F (29 = 5 groups of 6 at 16
    nodes), and widths below a cluster's eight blocks (F = 1 and 3 at the
    root: fewer (node, feature) pairs than blocks to flush them)."""
    args = _k1(*_mk(8192, n_features, 256, node0, stride * n_nodes, 5))
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=256, stride=stride)
    torch.testing.assert_close(hist_cuda.build_histogram_cuda(*args, **kw),
                               hist_cuda.build_histogram_plain(*args, **kw),
                               rtol=1e-4, atol=1e-4)


@needs_cuda
@pytest.mark.parametrize("n_rows", [1, 37, 1000, 3001])
@pytest.mark.parametrize("node0,n_nodes,stride", [(0, 1, 1), (15, 8, 2)])
def test_kernel_matches_plain_below_one_tile(n_rows, node0, n_nodes, stride):
    """Fewer rows than one block stages at once (32 warps x 64 rows), and
    not a multiple of a warp's 64: most blocks of the grid get no row."""
    bins, gpair, pos = _mk(n_rows, 28, 256, node0, stride * n_nodes, 6)
    pos[-1] = node0  # keep a row in the level even at R = 1
    args = _k1(bins, gpair, pos)
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=256, stride=stride)
    torch.testing.assert_close(hist_cuda.build_histogram_cuda(*args, **kw),
                               hist_cuda.build_histogram_plain(*args, **kw),
                               rtol=1e-4, atol=1e-4)


@needs_cuda
@pytest.mark.parametrize("what", ["pad", "missing"])
def test_pad_rows_and_missing_bins_add_nothing(what):
    bins, gpair, pos = _mk(20_000, 28, 256, 7, 8, 7)
    if what == "pad":
        pos[:] = -1
    else:
        bins[:] = 256
    args = _k1(bins, gpair, pos)
    got = hist_cuda.build_histogram_cuda(*args, node0=7, n_nodes=4,
                                         n_bin=256, stride=2)
    assert got.shape == (4, 28, 256, 2) and not got.any()


@needs_cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("node0,n_nodes,stride", [(0, 1, 1), (31, 16, 2),
                                                  (255, 128, 2)])
def test_each_cluster_size_matches_plain(cluster, node0, n_nodes, stride):
    """K1 planned with each cluster size (the card's occupancy of every
    other C taken as 0) against the plain version, at the root (one thread
    per row), 16 nodes and a node-tiled level (staged)."""
    bins, gpair, pos = _mk(65536, 28, 256, node0, stride * n_nodes, cluster)
    args = _k1(bins, gpair, pos)
    card = hist_cuda.card_max_clusters(args[0].device, torch.int16)
    plan = hist_cuda.plan_f32(
        65536, 28, n_nodes, 256,
        lambda staged, smem, c: card(staged, smem, c) if c == cluster else 0,
        stride)
    assert plan.cluster == cluster and plan.row_blocks % cluster == 0
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=256, stride=stride)
    torch.testing.assert_close(hist_cuda.run_f32(*args, plan, **kw),
                               hist_cuda.build_histogram_plain(*args, **kw),
                               rtol=1e-4, atol=1e-4)


@needs_cuda
def test_refused_cluster_launch_raises():
    """A cluster that does not divide the row blocks is refused by the
    card; the wrapper raises and counts no launch."""
    args = _k1(*_mk(4096, 28, 256, 0, 1, 8))
    plan = hist_cuda.Plan(28, 1, 6, 4, hist_cuda.THREADS, False)
    before = hist_cuda.launches["hist_f32"]
    with pytest.raises(RuntimeError, match="launch failed"):
        hist_cuda.run_f32(*args, plan, node0=0, n_nodes=1, n_bin=256)
    assert hist_cuda.launches["hist_f32"] == before


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


def _q(bins, gpair, pos, dtype=torch.int16):
    return (torch.from_numpy(bins).to(dtype).cuda(), _limbs(gpair),
            torch.from_numpy(pos).cuda())


def _plan_q(args, n_nodes, stride, cluster):
    """K2's plan with cluster size ``cluster`` (the card's occupancy of
    every other C taken as 0)."""
    card = hist_cuda.card_max_clusters(args[0].device, args[0].dtype,
                                       "hist_q")
    R, F = args[0].shape
    plan = hist_cuda.plan_q(
        R, F, n_nodes, 256, 6,
        lambda staged, smem, c: card(staged, smem, c) if c == cluster else 0,
        stride)
    assert plan.cluster == cluster and plan.row_blocks % cluster == 0
    return plan


@needs_cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("node0,n_nodes,stride", [(0, 1, 1), (31, 16, 2),
                                                  (255, 128, 2)])
def test_q_each_cluster_size_matches_plain(cluster, node0, n_nodes, stride):
    """K2 planned with each cluster size against the plain version,
    bitwise, at the root (one thread per row), 16 nodes and a node-tiled
    level (staged)."""
    args = _q(*_mk(65536, 28, 256, node0, stride * n_nodes, cluster))
    plan = _plan_q(args, n_nodes, stride, cluster)
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=256, stride=stride)
    assert torch.equal(hist_cuda.run_q(*args, plan, **kw),
                       hist_cuda.build_histogram_q_plain(*args, **kw))


@needs_cuda
@pytest.mark.parametrize("n_features", [1, 3, 29])
@pytest.mark.parametrize("node0,n_nodes,stride", [(0, 1, 1), (7, 4, 2),
                                                  (31, 16, 2)])
def test_q_kernel_matches_plain_at_other_widths(n_features, node0, n_nodes,
                                                stride):
    """Feature groups that do not divide F, and widths below a cluster's
    blocks, bitwise."""
    args = _q(*_mk(8192, n_features, 256, node0, stride * n_nodes, 5))
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=256, stride=stride)
    assert torch.equal(hist_cuda.build_histogram_q_cuda(*args, **kw),
                       hist_cuda.build_histogram_q_plain(*args, **kw))


@needs_cuda
@pytest.mark.parametrize("n_rows", [1, 37, 1000, 3001])
@pytest.mark.parametrize("node0,n_nodes,stride", [(0, 1, 1), (15, 8, 2)])
def test_q_kernel_matches_plain_below_one_tile(n_rows, node0, n_nodes,
                                               stride):
    """Fewer rows than one block stages at once, bitwise."""
    bins, gpair, pos = _mk(n_rows, 28, 256, node0, stride * n_nodes, 6)
    pos[-1] = node0  # keep a row in the level even at R = 1
    args = _q(bins, gpair, pos)
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=256, stride=stride)
    assert torch.equal(hist_cuda.build_histogram_q_cuda(*args, **kw),
                       hist_cuda.build_histogram_q_plain(*args, **kw))


@needs_cuda
@pytest.mark.parametrize("limb", [-128, 127])
@pytest.mark.parametrize("node0,n_nodes,stride", [(0, 1, 1), (1, 1, 2),
                                                  (31, 16, 2)])
def test_q_adversarial_limbs_match_plain(limb, node0, n_nodes, stride):
    """Every row in bin 0 of every feature, in one node, with the same
    extreme limbs: one cell per feature takes every row, in every block,
    bitwise."""
    R = 65536
    bins = torch.zeros((R, 28), dtype=torch.int16, device="cuda")
    gq = torch.full((R, 2, 3), limb, dtype=torch.int8, device="cuda")
    pos = torch.full((R,), node0, dtype=torch.int32, device="cuda")
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=256, stride=stride)
    want = hist_cuda.build_histogram_q_plain(bins, gq, pos, **kw)
    assert int(want[0, 0, 0, 0, 0]) == R * limb
    assert torch.equal(hist_cuda.build_histogram_q_cuda(bins, gq, pos, **kw),
                       want)


@needs_cuda
def test_refused_q_launch_raises():
    """A cluster that does not divide the row blocks is refused by the
    card; the wrapper raises and counts no launch, and the runtime's
    error state is cleared, so the next launch runs."""
    args = _q(*_mk(4096, 28, 256, 0, 1, 8))
    kw = dict(node0=0, n_nodes=1, n_bin=256)
    before = hist_cuda.launches["hist_q"]
    plan = hist_cuda.Plan(28, 1, 6, 4, hist_cuda.THREADS, False)
    with pytest.raises(RuntimeError, match="launch failed"):
        hist_cuda.run_q(*args, plan, **kw)
    assert hist_cuda.launches["hist_q"] == before
    assert torch.equal(hist_cuda.run_q(*args, plan._replace(cluster=2), **kw),
                       hist_cuda.build_histogram_q_plain(*args, **kw))
    assert hist_cuda.launches["hist_q"] == before + 1


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
    # and one sigmoid for the base score, then one a round
    assert hist_cuda.launches == {"hist_f32": 4 * 3, "hist_q": 0,
                                  "split_scan": 4 * 3, "sigmoid": 1 + 4,
                                  "hist_f32_multi": 0, "lambdarank": 0,
                                  "treeshap": 0, "treeshap_interactions": 0}
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
    assert hist_cuda.launches["split_scan"] == 2 * 10
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
        assert hist_cuda.launches == {"hist_f32": 0, "hist_q": 3 * 6,
                                      "split_scan": 3 * 6, "sigmoid": 1 + 3,
                                      "hist_f32_multi": 0, "lambdarank": 0,
                                      "treeshap": 0,
                                      "treeshap_interactions": 0}
        models.append(json.dumps(bst.save_raw_dict()))
    assert models[0] == models[1]


# ---------------------------------------------------------------- K3
def _scan_case(N, F, B, seed, ties=False):
    """A level's split-scan inputs: histograms with missing values, n_bins
    below B, a dead slot, a node whose every bin fails min_child_weight,
    and (``ties``) repeated bins, so that equal gains compete."""
    from xgboost_tpu_torch.ops.split import SplitParams

    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, F, B, 2)).astype(np.float32)
    h[..., 1] = np.abs(h[..., 1]) * 2
    if ties:
        h[:, :, 1::2] = h[:, :, ::2][:, :, : B // 2]
        h[:, 1::2] = h[:, ::2][:, : F // 2]
    nb = rng.integers(2, B + 1, size=F).astype(np.int32)
    nb[0] = B
    for f in range(F):
        h[:, f, nb[f]:] = 0.0
    tot = h[:, 0].sum(1) + np.float32([0.5, 1.5]) * (rng.random((N, 1)) < 0.7)
    if N > 1:
        h[-1] = 0.0
        tot[-1] = 0.0  # a dead slot
    if N > 2:
        h[0, :, :, 1] = 1e-3  # no bin reaches min_child_weight
        tot[0, 1] = h[0, 0, :, 1].sum() + 1e-3
    fm = rng.random((N, F)) < 0.7
    bounds = np.stack([rng.normal(size=N) - 1.5, rng.normal(size=N) + 1.5],
                      1).astype(np.float32)
    mono = tuple(int(c) for c in rng.integers(-1, 2, size=F))
    T = torch.from_numpy
    return (T(h), T(tot.astype(np.float32)), T(nb), T(fm), T(bounds), mono,
            SplitParams)


# the six levels of a depth-6 round, and the best-first grower's two nodes
K3_SHAPES = [(1, 28, 256), (2, 28, 256), (4, 28, 256), (8, 28, 256),
             (16, 28, 256), (32, 28, 256), (2, 28, 64), (5, 3, 17)]
K3_PARAMS = [dict(min_child_weight=1.0, lambda_=1.0, alpha=0.0,
                  max_delta_step=0.0),
             dict(min_child_weight=0.5, lambda_=2.0, alpha=0.5,
                  max_delta_step=0.7)]


def _k3(h, tot, nb, p, mask=None, bounds=None):
    """K3 on the card copies of CPU inputs, in the mode the plain version
    takes for ``p``."""
    from xgboost_tpu_torch.ops.split import is_monotone, monotone_vec

    mono = monotone_vec(tuple(p.monotone), torch.device("cuda")) \
        if is_monotone(p) else None
    return split_cuda.split_scan_cuda(
        h.cuda(), tot.cuda(), nb.cuda(), p,
        None if mask is None else mask.cuda(),
        None if bounds is None else bounds.cuda(), mono)


@needs_cuda
@pytest.mark.parametrize("monotone", [False, True])
@pytest.mark.parametrize("pi", [0, 1])
@pytest.mark.parametrize("N,F,B", K3_SHAPES)
def test_split_scan_matches_plain_bitwise(N, F, B, pi, monotone):
    from xgboost_tpu_torch.ops.split import split_scan_plain

    h, tot, nb, fm, bounds, mono, SP = _scan_case(N, F, B, seed=N + B + pi,
                                                  ties=pi == 0)
    p = SP(eta=0.3, gamma=0.0, monotone=mono if monotone else None,
           **K3_PARAMS[pi])
    for mask in (None, fm, fm[:1]):
        want = split_scan_plain(h, tot, nb, p, mask, bounds)
        before = hist_cuda.launches["split_scan"]
        got = _k3(h, tot, nb, p, mask, bounds)
        torch.cuda.synchronize()
        assert hist_cuda.launches["split_scan"] == before + 1
        for name, a, b in zip(want._fields, got, want):
            a = a.cpu()
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (name, a, b)


@needs_cuda
@pytest.mark.parametrize("monotone", [False, True])
@pytest.mark.parametrize("B", [2, 16, 255, 257, 1024, 3500, 4100])
def test_split_scan_takes_every_width(B, monotone):
    """K3 bitwise at widths around its chunks and levels: one block of 16,
    the 256-bin chunks of the native chain, the third level of the blocked
    prefix past 256 bins and the fourth past 4096; the widest take fewer
    warps than features."""
    from xgboost_tpu_torch.ops.split import split_scan_plain

    h, tot, nb, fm, bounds, mono, SP = _scan_case(3, 9, B, seed=B)
    p = SP(eta=0.3, gamma=0.0, monotone=mono if monotone else None,
           **K3_PARAMS[0])
    want = split_scan_plain(h, tot, nb, p, fm, bounds)
    got = _k3(h, tot, nb, p, fm, bounds)
    for name, a, b in zip(want._fields, got, want):
        a = a.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (name, a, b)


@needs_cuda
def test_split_scan_rejects_what_it_cannot_take():
    h, tot, nb, fm, bounds, mono, SP = _scan_case(4, 5, 16, seed=0)
    p = SP(eta=0.3, gamma=0.0, min_child_weight=1.0, lambda_=1.0, alpha=0.0,
           max_delta_step=0.0)
    with pytest.raises(ValueError):
        split_cuda.split_scan_cuda(h, tot, nb, p)  # CPU tensors
    with pytest.raises(ValueError):
        split_cuda.split_scan_cuda(h.cuda(), tot[:2].cuda(), nb.cuda(), p)
    with pytest.raises(TypeError):
        split_cuda.split_scan_cuda(h.double().cuda(), tot.cuda(), nb.cuda(),
                                   p)
    with pytest.raises(ValueError):  # a constraint vector of another width
        split_cuda.split_scan_cuda(
            h.cuda(), tot.cuda(), nb.cuda(), p,
            mono=torch.ones(4, dtype=torch.int32, device="cuda"))


@needs_cuda
def test_refused_split_scan_launch_raises_and_clears_the_error():
    """A histogram of 32768 bins asks K3 for more shared memory than a
    block may have, even with one warp; the card refuses, the wrapper
    raises and counts no launch, and the runtime's error state is cleared,
    so the next K1 launch runs."""
    h, tot, nb, _, _, _, SP = _scan_case(1, 1, 32768, seed=4)
    p = SP(eta=0.3, gamma=0.0, min_child_weight=1.0, lambda_=1.0, alpha=0.0,
           max_delta_step=0.0)
    before = dict(hist_cuda.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        _k3(h, tot, nb, p)
    assert hist_cuda.launches == before
    args = _k1(*_mk(4096, 28, 256, 0, 1, 8))
    kw = dict(node0=0, n_nodes=1, n_bin=256)
    torch.testing.assert_close(hist_cuda.build_histogram_cuda(*args, **kw),
                               hist_cuda.build_histogram_plain(*args, **kw),
                               rtol=1e-4, atol=1e-4)
    assert hist_cuda.launches["hist_f32"] == before["hist_f32"] + 1


# ------------------------------------------------- K3, categorical mode
def _cat_scan_case(N, F, B, seed, n_cat):
    """Categorical split-scan inputs: the last ``n_cat`` of F features
    categorical with 2 to 100 categories (fewer than 4 for some, so both
    one-hot and partition splits occur), 10% empty categories, repeated
    bins (ties in G/H), missing mass, a node without a candidate; the
    histogram given as comb * scale, the limb form deterministic_histogram
    scans."""
    rng = np.random.default_rng(seed)
    comb = rng.integers(-4000, 4000, size=(N, F, B, 2)).astype(np.float32)
    comb[..., 1] = np.abs(comb[..., 1]) + 1
    comb[:, :, 1::4] = comb[:, :, ::4][:, :, :len(range(1, B, 4))]
    nb = rng.integers(2, B + 1, size=F).astype(np.int32)
    nb[F - n_cat:] = rng.integers(2, min(B, 100) + 1, size=n_cat)
    nb[F - 1] = min(3, B)
    for f in range(F):
        comb[:, f, nb[f]:] = 0.0
    comb[rng.random((N, F, B)) < 0.1] = 0.0
    cm = np.zeros(F, bool)
    cm[F - n_cat:] = True
    scale = torch.tensor([3e-4, 1e-4], dtype=torch.float32)
    if N > 2:
        comb[0, :, :, 1] = np.minimum(comb[0, :, :, 1], 1.0)  # no bin
        # reaches min_child_weight
    comb = torch.from_numpy(comb)
    h = comb * scale
    tot = (h[:, 0].sum(1) * 1.05).float()
    fm = torch.from_numpy(rng.random((N, F)) < 0.8)
    bounds = torch.from_numpy(np.stack(
        [rng.normal(size=N) - 1.5, rng.normal(size=N) + 1.5],
        1).astype(np.float32))
    mono = tuple(int(c) for c in rng.integers(-1, 2, size=F))
    return (h, tot, torch.from_numpy(nb), torch.from_numpy(cm), fm, bounds,
            mono, (comb, scale))


# the depth-8 levels of the Criteo-shaped main path (39 features, 26 of
# them categorical, 128 bins), the best-first grower's two nodes, small and
# wide odd shapes, and the widest the scan took with 8 warps a block
K3_CAT_SHAPES = [(1, 39, 128, 26), (8, 39, 128, 26), (64, 39, 128, 26),
                 (2, 39, 128, 26), (3, 5, 17, 3), (2, 3, 300, 2),
                 (2, 3, 1450, 2)]


@needs_cuda
@pytest.mark.parametrize("limbs", [False, True])
@pytest.mark.parametrize("monotone", [False, True])
@pytest.mark.parametrize("onehot", [4, 128])
@pytest.mark.parametrize("N,F,B,n_cat", K3_CAT_SHAPES)
def test_categorical_split_scan_matches_plain_bitwise(N, F, B, n_cat, onehot,
                                                      monotone, limbs):
    """K3's categorical mode against split_scan_plain, every output
    bitwise (cat_set included), one launch counted per call."""
    from xgboost_tpu_torch.ops.split import (SplitParams, is_monotone,
                                             monotone_vec, split_scan_plain)

    h, tot, nb, cm, fm, bounds, mono, dq = _cat_scan_case(
        N, F, B, N + B + onehot, n_cat)
    p = SplitParams(eta=0.3, gamma=0.0, min_child_weight=0.5, lambda_=1.0,
                    alpha=0.0, max_delta_step=0.0,
                    monotone=mono if monotone else None,
                    max_cat_to_onehot=onehot)
    dev = torch.device("cuda")
    mvec = monotone_vec(mono, dev) if is_monotone(p) else None
    for mask in (None, fm):
        want = split_scan_plain(h, tot, nb, p, mask, bounds, cm,
                                dq if limbs else None)
        before = hist_cuda.launches["split_scan"]
        got = split_cuda.split_scan_cuda(
            h.cuda(), tot.cuda(), nb.cuda(), p,
            None if mask is None else mask.cuda(), bounds.cuda(), mvec,
            cm.cuda(), tuple(t.cuda() for t in dq) if limbs else None)
        torch.cuda.synchronize()
        assert hist_cuda.launches["split_scan"] == before + 1
        assert len(got) == 7
        for name, a, b in zip(want._fields, got, want):
            a = a.cpu()
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (name, a, b)


@needs_cuda
def test_refused_categorical_scan_raises():
    """16384 bins ask the categorical mode for more shared memory than a
    block may have, even with one warp: the wrapper raises and counts no
    launch."""
    h, tot, nb, cm, _, _, _, _ = _cat_scan_case(1, 2, 16384, 0, 1)
    from xgboost_tpu_torch.ops.split import SplitParams

    p = SplitParams(eta=0.3, gamma=0.0, min_child_weight=1.0, lambda_=1.0,
                    alpha=0.0, max_delta_step=0.0)
    before = dict(hist_cuda.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        split_cuda.split_scan_cuda(h.cuda(), tot.cuda(), nb.cuda(), p,
                                   cat_mask=cm.cuda())
    assert hist_cuda.launches == before
    with pytest.raises(ValueError):  # the limb form without a cat mask
        split_cuda.split_scan_cuda(h.cuda(), tot.cuda(), nb.cuda(), p,
                                   dq=(h.cuda(), torch.ones(2,
                                                            device="cuda")))


def _criteo_small(R=4000, seed=0):
    """The Criteo-shaped generator (scripts/bench_ladder.py:616-631) at a
    small row count."""
    rng = np.random.default_rng(seed)
    X = np.empty((R, 39), np.float32)
    X[:, :13] = rng.normal(size=(R, 13))
    X[:, :13][rng.random((R, 13)) < 0.2] = np.nan
    X[:, 13:] = np.minimum(rng.geometric(0.08, size=(R, 26)) - 1, 99)
    lin = (np.nan_to_num(X[:, 0]) * 1.2 - np.nan_to_num(X[:, 1])
           + 0.5 * np.nan_to_num(X[:, 2]) * np.nan_to_num(X[:, 3])
           + 0.3 * (X[:, 13] == 0))
    y = (lin + rng.normal(scale=0.5, size=R) > 0).astype(np.float32)
    return X, y, ["q"] * 13 + ["c"] * 26


@needs_cuda
@pytest.mark.parametrize("onehot", [4, 128])
def test_categorical_training_card_is_the_cpus(onehot):
    """deterministic_histogram=1 with categorical features: the card's
    model JSON is the CPU's byte for byte, K2 and K3 launched once per
    level."""
    X, y, ft = _criteo_small()
    params = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 128,
              "eta": 0.3, "deterministic_histogram": 1,
              "max_cat_to_onehot": onehot}
    hist_cuda.reset_launches()
    got = xtt.train(params, xtt.DMatrix(X, label=y, feature_types=ft), 3,
                    verbose_eval=False)
    assert hist_cuda.launches["hist_q"] == hist_cuda.launches[
        "split_scan"] == 3 * 4
    want = xtt.train(params, xtt.DMatrix(X, label=y, feature_types=ft,
                                         device="cpu"), 3,
                     verbose_eval=False, device="cpu")
    assert json.dumps(got.save_raw_dict()) == json.dumps(want.save_raw_dict())
    assert any(t.categories for t in got.trees)


# ---------------------------------------------------------------- K4
def _sigmoid_inputs(n=1 << 16, seed=0):
    """Margins across the f32 range the exponential handles, and its edges:
    zeros, tiny values, the clamps at -104 and 88.8, overflow, infinities
    and NaN."""
    rng = np.random.default_rng(seed)
    edges = np.float32([0.0, -0.0, 1e-30, -1e-30, 1e-8, -1e-8, 15.0, -15.0,
                        17.0, -17.0, 87.0, -87.0, 88.37, -88.37, 88.7, -88.7,
                        88.8, -88.8, 89.0, -89.0, 103.0, -103.0, 104.0,
                        -104.0, 105.0, -105.0, 1e4, -1e4, np.inf, -np.inf,
                        np.nan])
    x = np.concatenate([rng.normal(size=n) * 4, rng.uniform(-120, 120, n),
                        edges]).astype(np.float32)
    return torch.from_numpy(x)


@needs_cuda
@pytest.mark.parametrize("n", [1, 33, 1 << 16])
def test_sigmoid_matches_plain_bitwise(n):
    from xgboost_tpu_torch.ops.sigmoid_cuda import sigmoid_cuda
    from xgboost_tpu_torch.utils.fp import sigmoid_f32

    x = _sigmoid_inputs(n)
    before = hist_cuda.launches["sigmoid"]
    got = sigmoid_cuda(x.cuda()).cpu()
    assert hist_cuda.launches["sigmoid"] == before + 1
    want = sigmoid_f32(x)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


@needs_cuda
def test_sigmoid_rejects_what_it_cannot_take():
    from xgboost_tpu_torch.ops.sigmoid_cuda import sigmoid_cuda

    with pytest.raises(TypeError):
        sigmoid_cuda(torch.zeros(4, dtype=torch.float64, device="cuda"))
    before = hist_cuda.launches["sigmoid"]
    assert sigmoid_cuda(torch.zeros(0, device="cuda")).shape == (0,)
    assert hist_cuda.launches["sigmoid"] == before  # nothing to launch


@needs_cuda
@pytest.mark.parametrize("spw", [1.0, 2.5])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,offset", [(1, 0), (33, 0), (1 << 16, 0),
                                      (1 << 16, 1)])
def test_logistic_gradient_matches_plain_bitwise(n, offset, weighted, spw):
    """K4's gradient entry against logistic_gradient_plain, bitwise, over
    margins at the f32 range's edges, labels 0, 1 and between, weights
    with subnormal products; ``offset`` 1 gives inputs that are not
    16-byte aligned (the scalar path).  One launch counted per call."""
    from xgboost_tpu_torch.ops.sigmoid_cuda import (logistic_gradient_cuda,
                                                    logistic_gradient_plain)

    x = _sigmoid_inputs(n)[offset:]
    rng = np.random.default_rng(n)
    y = torch.from_numpy((rng.random(x.numel()) < 0.4).astype(np.float32))
    y[:3] = torch.tensor([0.5, 1e-40, 2.0])
    w = torch.from_numpy(rng.random(x.numel()).astype(np.float32) + 0.01)
    w[:2] = torch.tensor([1e-39, 3e38])
    wt = w if weighted else None
    want = logistic_gradient_plain(x, y, wt, spw)
    before = hist_cuda.launches["sigmoid"]
    got = logistic_gradient_cuda(x.cuda(), y.cuda(),
                                 None if wt is None else wt.cuda(), spw).cpu()
    assert hist_cuda.launches["sigmoid"] == before + 1
    assert got.shape == want.shape == (x.numel(), 1, 2)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


@needs_cuda
def test_logistic_gradient_rejects_what_it_cannot_take():
    from xgboost_tpu_torch.ops.sigmoid_cuda import logistic_gradient_cuda

    x = torch.zeros(8, device="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        logistic_gradient_cuda(x.cpu(), x.cpu())
    with pytest.raises(TypeError):
        logistic_gradient_cuda(x.double(), x)
    with pytest.raises(ValueError):
        logistic_gradient_cuda(x, x[:4])


# ------------------------------------------- multiclass, forests, CSR
def _small_multiclass(R=3000, F=10, K=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    z = np.nan_to_num(X[:, 0]) - 0.5 * np.nan_to_num(X[:, 1])
    y = np.digitize(z, np.quantile(z, np.linspace(0, 1, K + 1)[1:-1]))
    return X, y.astype(np.float32), rng.uniform(0.5, 2.0, R).astype(
        np.float32)


@needs_cuda
@pytest.mark.parametrize("sampled", [False, True])
def test_multiclass_training_card_is_the_cpus(sampled):
    """multi:softprob under deterministic_histogram=1: K2 and K3 launched
    once a level of each class tree, no K4, and the CPU's model JSON."""
    X, y, w = _small_multiclass()
    params = {"objective": "multi:softprob", "num_class": 3, "max_depth": 4,
              "max_bin": 64, "deterministic_histogram": 1}
    dm = {}
    if sampled:
        params.update(subsample=0.8, colsample_bynode=0.8, seed=4)
        dm["weight"] = w
    hist_cuda.reset_launches()
    got = xtt.train(params, xtt.DMatrix(X, label=y, **dm), 3,
                    verbose_eval=False)
    assert hist_cuda.launches == {"hist_f32": 0, "hist_q": 3 * 3 * 4,
                                  "split_scan": 3 * 3 * 4, "sigmoid": 0,
                                  "hist_f32_multi": 0, "lambdarank": 0,
                                  "treeshap": 0, "treeshap_interactions": 0}
    want = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu", **dm), 3,
                     verbose_eval=False, device="cpu")
    assert json.dumps(got.save_raw_dict()) == json.dumps(want.save_raw_dict())
    prob = got.predict(xtt.DMatrix(X))
    assert prob.shape == (len(X), 3)
    np.testing.assert_allclose(prob.sum(axis=1), 1.0, atol=1e-6)


@needs_cuda
def test_forest_training_card_is_the_cpus():
    """num_parallel_tree=3 with row and column sampling: K2 and K3 once a
    level of each of the 3 trees a round, and the CPU's model JSON."""
    X, y, _ = _small_multiclass()
    y = (y > 0).astype(np.float32)
    params = {"objective": "binary:logistic", "num_parallel_tree": 3,
              "subsample": 0.8, "colsample_bynode": 0.8, "eta": 1.0,
              "max_depth": 4, "max_bin": 64, "deterministic_histogram": 1,
              "seed": 6}
    hist_cuda.reset_launches()
    got = xtt.train(params, xtt.DMatrix(X, label=y), 2, verbose_eval=False)
    assert hist_cuda.launches["hist_q"] == hist_cuda.launches[
        "split_scan"] == 2 * 3 * 4
    want = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), 2,
                     verbose_eval=False, device="cpu")
    assert json.dumps(got.save_raw_dict()) == json.dumps(want.save_raw_dict())
    assert got.num_boosted_rounds() == 2 and len(got.trees) == 6


@needs_cuda
def test_csr_bins_and_training_card_are_the_cpus():
    """CSR input: the bins computed on the card from the stored entries
    equal the CPU's, and the deterministic model JSON is the CPU's."""
    import scipy.sparse as sp

    X, y, _ = _small_multiclass(F=40)
    y = (y > 0).astype(np.float32)
    X[np.random.default_rng(1).random(X.shape) < 0.8] = 0.0
    m = sp.csr_matrix(np.nan_to_num(X))
    d_card, d_cpu = xtt.DMatrix(m, label=y), xtt.DMatrix(m, label=y,
                                                         device="cpu")
    assert torch.equal(d_card.ensure_ellpack(64).bins.cpu(),
                       d_cpu.ensure_ellpack(64).bins)
    params = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 64,
              "deterministic_histogram": 1}
    got = xtt.train(params, d_card, 3, verbose_eval=False)
    want = xtt.train(params, d_cpu, 3, verbose_eval=False, device="cpu")
    assert json.dumps(got.save_raw_dict()) == json.dumps(want.save_raw_dict())
    np.testing.assert_array_equal(got.predict(xtt.DMatrix(m)),
                                  want.predict(xtt.DMatrix(m, device="cpu")))


# ------------------------------------------------------- K1's class axis
def _class_case(R, F, B, K, node0, span, seed, shared):
    rng = np.random.default_rng(seed)
    bins = torch.from_numpy(rng.integers(0, B + 1, size=(R, F))).to(
        torch.int16).cuda()
    gpair = torch.from_numpy(rng.normal(size=(R, K, 2)).astype(
        np.float32)).cuda()
    shape = (R,) if shared else (K, R)
    p = rng.integers(node0 - 1, node0 + span + 1, size=shape)
    p[..., -R // 16:] = -1
    return bins, gpair, torch.from_numpy(p.astype(np.int32)).cuda()


def _class_plain(bins, gpair, pos, shared, **kw):
    if shared:
        return hist_cuda.build_level_hist_multi_plain(bins, gpair, pos, **kw)
    return hist_cuda.build_histogram_multi_plain(bins, gpair, pos, **kw)


@needs_cuda
@pytest.mark.parametrize("F", [1, 29])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("K", [1, 2, 3, 7, 8, 16])
@pytest.mark.parametrize("node0,n_nodes,stride", [(0, 1, 1), (1, 1, 2),
                                                  (15, 8, 2), (3, 4, 1),
                                                  (255, 128, 2)])
def test_class_axis_matches_plain(node0, n_nodes, stride, K, shared, F):
    """K histograms in one call against the plain versions: the lockstep
    layout (pos (K, R), hist (K, N, F, B, 2)) and the vector-leaf layout
    (one pos, hist (N, F, B, K, 2)), unbucketed at the root and bucketed
    by node below it, at one feature and at 29 (a ragged feature group
    and warp); one launch counted, none of the single kernel."""
    bins, gpair, pos = _class_case(16384, F, 256, K, node0,
                                   stride * n_nodes, node0 + K, shared)
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=256, stride=stride)
    hist_cuda.reset_launches()
    fn = (hist_cuda.build_level_hist_multi if shared
          else hist_cuda.build_histogram_multi)
    got = fn(bins, gpair, pos, **kw)
    assert hist_cuda.launches["hist_f32_multi"] == 1
    assert hist_cuda.launches["hist_f32"] == 0
    torch.testing.assert_close(got, _class_plain(bins, gpair, pos, shared,
                                                 **kw), rtol=1e-4, atol=1e-4)


@needs_cuda
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("node0,n_nodes,stride", [(0, 1, 1), (31, 16, 2)])
def test_class_axis_with_fewer_classes_a_block(node0, n_nodes, stride,
                                               shared):
    """K = 17 and 33, more than a warp's 16: class groups (9 and a ragged
    8; three of 11), or one class a block where a pos per class is
    bucketed: the same histograms."""
    kw = dict(node0=node0, n_nodes=n_nodes, n_bin=256, stride=stride)
    for K in (17, 33):
        bins, gpair, pos = _class_case(20000, 29, 256, K, node0,
                                       stride * n_nodes, 5, shared)
        plan = hist_cuda.planned_multi(bins, K, n_nodes, 256, stride, shared)
        assert plan.class_group < K
        got = hist_cuda.run_f32_multi(bins, gpair, pos, plan,
                                      shared_pos=shared, **kw)
        torch.testing.assert_close(got, _class_plain(bins, gpair, pos, shared,
                                                     **kw),
                                   rtol=1e-4, atol=1e-4)


@needs_cuda
@pytest.mark.parametrize("shared", [False, True])
def test_class_axis_bucketed_level_with_empty_nodes(shared):
    """A bucketed 64-node level whose rows sit in every third node only
    (the rest empty, as are some classes' nodes), most of them in one
    node, with uint8 and int32 bins: the plain versions' histograms."""
    rng = np.random.default_rng(7)
    R, F, K = 30000, 6, 5
    shape = (R,) if shared else (K, R)
    node = rng.choice(np.arange(0, 64, 3), size=shape)
    node[rng.random(shape) < 0.6] = 3
    p = 63 + 2 * node
    p[rng.random(shape) < 0.05] = -1
    pos = torch.from_numpy(p.astype(np.int32)).cuda()
    gpair = torch.from_numpy(rng.normal(size=(R, K, 2)).astype(
        np.float32)).cuda()
    kw = dict(node0=63, n_nodes=64, n_bin=64, stride=2)
    for dtype in (torch.uint8, torch.int32):
        bins = torch.from_numpy(rng.integers(0, 65, size=(R, F))).to(
            dtype).cuda()
        fn = (hist_cuda.build_level_hist_multi if shared
              else hist_cuda.build_histogram_multi)
        got = fn(bins, gpair, pos, **kw)
        want = _class_plain(bins, gpair, pos, shared, **kw)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        empty = (want.abs().sum(dim=(1, 2, 4)) if shared
                 else want.abs().sum(dim=(0, 2, 3, 4)))
        assert (empty == 0).sum() >= 40


@needs_cuda
def test_class_axis_refuses_a_plan_it_cannot_take():
    """A plan the kernel refuses raises: row blocks not a multiple of the
    cluster, an unbucketed plan for a level of many nodes, several classes
    a block where a pos per class is bucketed."""
    bins, gpair, pos = _class_case(4096, 8, 64, 3, 3, 8, 0, False)
    plan = hist_cuda.planned_multi(bins, 3, 4, 64, 2, False)
    kw = dict(node0=3, n_nodes=4, n_bin=64, stride=2)
    with pytest.raises(RuntimeError, match="launch failed"):
        hist_cuda.run_f32_multi(bins, gpair, pos, plan._replace(
            cluster=2, row_blocks=3), **kw)
    with pytest.raises(ValueError, match="unbucketed"):
        hist_cuda.run_f32_multi(bins, gpair, pos,
                                plan._replace(bucketed=False), **kw)
    with pytest.raises(ValueError, match="one class a block"):
        hist_cuda.run_f32_multi(bins, gpair, pos,
                                plan._replace(class_group=3), **kw)


@needs_cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("shared", [False, True])
def test_class_axis_each_cluster_size(cluster, shared):
    bins, gpair, pos = _class_case(65536, 28, 256, 5, 31, 32, cluster, shared)
    card = hist_cuda.card_max_clusters(bins.device, torch.int16)
    plan = hist_cuda.plan_f32_multi(
        65536, 28, 16, 256, 5,
        lambda staged, smem, c: card(staged, smem, c) if c == cluster else 0,
        2)
    assert plan.cluster == cluster
    kw = dict(node0=31, n_nodes=16, n_bin=256, stride=2)
    got = hist_cuda.run_f32_multi(bins, gpair, pos, plan, shared_pos=shared,
                                  **kw)
    torch.testing.assert_close(got, _class_plain(bins, gpair, pos, shared,
                                                 **kw), rtol=1e-4, atol=1e-4)


@needs_cuda
def test_class_axis_refuses_what_it_cannot_take():
    bins, gpair, pos = _class_case(4096, 8, 64, 3, 0, 1, 0, False)
    kw = dict(node0=0, n_nodes=1, n_bin=64)
    with pytest.raises(ValueError, match="pos must be"):
        hist_cuda.build_histogram_multi(bins, gpair, pos[0], **kw)
    with pytest.raises(ValueError):
        hist_cuda.build_level_hist_multi(bins, gpair, pos, **kw)
    with pytest.raises(TypeError):
        hist_cuda.build_histogram_multi(bins, gpair.double(), pos, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        hist_cuda.build_histogram_multi(bins, gpair, pos.t().contiguous().t(),
                                        **kw)


@needs_cuda
def test_lockstep_and_vector_training_launch_the_class_axis():
    """_lockstep=1: one class-axis launch and one K3 launch a level for
    the K class trees, no single K1; multi_output_tree the same for its
    one tree; both grow the CPU's trees at depth 3."""
    X, y, _ = _small_multiclass()
    for extra in ({"_lockstep": 1}, {"multi_strategy": "multi_output_tree"}):
        params = {"objective": "multi:softprob", "num_class": 3,
                  "max_depth": 3, "max_bin": 64, **extra}
        hist_cuda.reset_launches()
        got = xtt.train(params, xtt.DMatrix(X, label=y), 3,
                        verbose_eval=False)
        assert hist_cuda.launches == {"hist_f32": 0, "hist_q": 0,
                                      "split_scan": 0 if "multi_strategy"
                                      in extra else 3 * 3,
                                      "sigmoid": 0, "hist_f32_multi": 3 * 3,
                                      "lambdarank": 0, "treeshap": 0,
                                      "treeshap_interactions": 0}
        want = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), 3,
                         verbose_eval=False, device="cpu")
        for a, b in zip(got.trees, want.trees):
            np.testing.assert_array_equal(a.split_indices, b.split_indices)
        np.testing.assert_allclose(got.predict(xtt.DMatrix(X)),
                                   want.predict(xtt.DMatrix(X, device="cpu")),
                                   atol=1e-4)


# ------------------------------------- the rest of the pointwise objectives
def _pointwise_targets(R=20_000, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, 8)).astype(np.float32)
    z = X[:, :3] @ np.array([1.0, -0.5, 0.3], np.float32)
    zs = (z - z.mean()) / z.std()
    mu = np.exp(0.3 * zs)
    t = np.exp(zs / 2 + 0.3 * rng.normal(size=R)).astype(np.float32)
    k = rng.integers(0, 4, R)
    lo, hi = t.copy(), t.copy()
    hi[k == 2] = np.inf
    lo[k == 3], hi[k == 3] = 0.7 * t[k == 3], 1.5 * t[k == 3]
    return X, dict(cont=z.astype(np.float32),
                   count=rng.poisson(mu).astype(np.float32),
                   pos=rng.gamma(2.0, mu / 2.0).astype(np.float32),
                   binary=(z > 0).astype(np.float32), time=t,
                   bounds=(lo, hi),
                   cox=np.where(k == 2, -t, t).astype(np.float32))


@needs_cuda
@pytest.mark.parametrize("objective,extra,target", [
    ("reg:absoluteerror", {}, "cont"),
    ("reg:quantileerror", {"quantile_alpha": [0.1, 0.5, 0.9]}, "cont"),
    ("reg:pseudohubererror", {"huber_slope": 2.0}, "cont"),
    ("reg:squaredlogerror", {}, "pos"),
    ("count:poisson", {}, "count"),
    ("reg:gamma", {}, "pos"),
    ("reg:tweedie", {}, "pos"),
    ("reg:logistic", {}, "binary"),
    ("binary:logitraw", {}, "binary"),
    ("binary:hinge", {}, "binary"),
    ("reg:expectileerror", {"expectile_alpha": [0.2, 0.8]}, "cont"),
    ("survival:aft", {}, "time"),
    ("survival:aft", {"aft_loss_distribution": "extreme"}, "time"),
    ("survival:cox", {}, "cox"),
])
def test_pointwise_objective_card_json_is_the_cpus(objective, extra, target):
    """deterministic_histogram=1: the card's model JSON is the CPU's, the
    refit's leaves and the survival gradients included."""
    X, T = _pointwise_targets()
    dm = {}
    if objective == "survival:aft":
        dm = dict(label_lower_bound=T["bounds"][0],
                  label_upper_bound=T["bounds"][1])
    params = {"objective": objective, "max_depth": 4, "max_bin": 64,
              "deterministic_histogram": 1, **extra}
    hist_cuda.reset_launches()
    card = xtt.train(params, xtt.DMatrix(X, label=T[target], **dm), 4,
                     verbose_eval=False)
    K = len(extra.get("quantile_alpha", extra.get("expectile_alpha", [0])))
    assert hist_cuda.launches["hist_q"] == 4 * 4 * K
    logistic = objective in ("reg:logistic", "binary:logitraw")
    assert hist_cuda.launches["sigmoid"] == (1 + 4 if logistic else 0)
    cpu = xtt.train(params, xtt.DMatrix(X, label=T[target], device="cpu",
                                        **dm), 4, verbose_eval=False,
                    device="cpu")
    assert json.dumps(card.save_raw_dict()) == json.dumps(cpu.save_raw_dict())


# K5: (name, group sizes, scores, k, ndcg weight, score norm, group norm)
K5_CASES = [
    ("mslr", [40, 199, 77, 120, 163, 58, 91, 40] * 40, "normal", 32, True,
     True, True),
    ("big_groups", [5000, 3000, 12], "normal", 32, True, True, True),
    ("sizes_1_2", [1, 2, 1, 2, 5, 1] * 50, "normal", 32, True, True, True),
    ("tied", [60, 45, 80] * 20, "tied", 32, True, True, True),
    ("all_equal", [60, 45, 80] * 20, "zero", 32, True, True, True),
    ("k_above_n", [5, 9, 3, 30] * 20, "normal", 64, True, True, True),
    ("no_score_norm", [40, 70] * 20, "normal", 32, True, False, True),
    ("no_group_norm", [40, 70] * 20, "normal", 32, True, True, False),
    ("pairwise", [40, 70, 2] * 20, "normal", 32, False, True, True),
    ("nan_scores", [40, 199, 77, 120] * 10, "nan", 32, True, True, True),
    ("signed_zero", [60, 45, 80] * 20, "signed_zero", 32, True, True, True),
    ("at_cap", [256, 40, 256, 120] * 5, "normal", 32, True, True, True),
    ("above_cap", [257, 40] * 5, "normal", 32, True, True, True),
    ("mixed", [40, 199, 77] * 10 + [300] + [120, 60] * 10, "normal", 32,
     True, True, True),
    ("k_1", [40, 199, 77, 120, 163, 58, 91, 40] * 10, "normal", 1, True,
     True, True),
]


def _k5_scores(kind, R, rng):
    s = rng.normal(size=R).astype(np.float32)
    if kind == "tied":
        s = np.round(2 * s).astype(np.float32)
        s[::7] = -0.0
    elif kind == "zero":
        s[:] = 0.0
    elif kind == "nan":
        s[::11] = np.nan
    elif kind == "signed_zero":  # every score +0.0 or -0.0: one tie a group
        s = np.where(rng.random(R) < 0.5, -0.0, 0.0).astype(np.float32)
    return s


@needs_cuda
@pytest.mark.parametrize("case", K5_CASES, ids=[c[0] for c in K5_CASES])
def test_lambdarank_kernel_is_its_plain_version(case):
    """K5 (csrc/lambdarank.cu) bitwise its plain version, rows past the
    last group (0, 0), one launch counted, the sorts in the kernel exactly
    where every group fits a bundle (at most CAP docs).  With NaN scores
    the plain version runs on the card too: NaNs made by arithmetic carry
    the card's one NaN, the CPU's others."""
    from xgboost_tpu_torch.ops import lambdarank_cuda as lr

    _, sizes, scores, k, nd, sn, gn = case
    rng = np.random.default_rng(len(sizes))
    gp = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    R = int(gp[-1]) + 37
    s = _k5_scores(scores, R, rng)
    y = rng.integers(0, 5, R).astype(np.float32)
    layout = lr.GroupLayout(gp, "cuda")
    s_card, y_card = torch.from_numpy(s).cuda(), torch.from_numpy(y).cuda()
    hist_cuda.reset_launches()
    got = lr.lambdarank_topk(s_card, y_card, layout, k, nd, sn, gn)
    torch.cuda.synchronize()
    assert hist_cuda.launches["lambdarank"] == 1
    assert layout.sorts_in_kernel == (max(sizes) <= lr.CAP)
    want = lr.lambdarank_topk_plain(torch.from_numpy(s), torch.from_numpy(y),
                                    lr.GroupLayout(gp, "cpu"), k, nd, sn, gn)
    got = got.cpu()
    if scores == "nan":
        want_card = lr.lambdarank_topk_plain(s_card, y_card, layout, k, nd,
                                             sn, gn).cpu()
        assert torch.equal(got.view(torch.int32), want_card.view(torch.int32))
        nan = torch.isnan(want)
        assert nan.any() and torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32),
                           want[~nan].view(torch.int32))
    else:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not got[int(gp[-1]):].any()


@needs_cuda
@pytest.mark.parametrize("docs,groups,max_n", [
    ("docs", 1, 40), (100, "groups", 40), (300, 1, "cap")])
def test_lambdarank_entry_refuses_bundles_beyond_its_geometry(docs, groups,
                                                              max_n):
    """K5's bundles are the library's own (CAP, BUNDLE_DOCS,
    BUNDLE_GROUPS), and its entry refuses, before any launch, a bundle of
    more docs or more groups than a block takes, or a larger group."""
    from xgboost_tpu_torch.ops import lambdarank_cuda as lr

    lib = hist_cuda.load_library("lambdarank")
    assert lr._geometry(lib) == (lr.CAP, lr.BUNDLE_DOCS, lr.BUNDLE_GROUPS)
    docs = lr.BUNDLE_DOCS + 1 if docs == "docs" else docs
    groups = lr.BUNDLE_GROUPS + 1 if groups == "groups" else groups
    max_n = lr.CAP + 1 if max_n == "cap" else max_n
    rc = lib.xtb_lambdarank(None, None, None, None, None, 1, docs, groups,
                            max_n, None, 0, None, None, None, 0, None, 32,
                            1, 1, 1, None, None)
    assert rc == 1  # cudaErrorInvalidValue


@needs_cuda
@pytest.mark.parametrize("name", ["expf", "exp2f", "log2f"])
def test_libm_card_is_the_cpus(name):
    """utils/libm on the card: the CPU's bits over sampled f32 inputs."""
    from xgboost_tpu_torch.utils import libm

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 2**32, 1 << 20, dtype=np.uint64)
                         .astype(np.uint32).view(np.float32))
    fn = getattr(libm, name)
    got, want = fn(x.cuda()).cpu(), fn(x)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


@needs_cuda
@pytest.mark.parametrize("objective,extra", [
    ("rank:ndcg", {}), ("rank:pairwise", {}), ("rank:map", {}),
    ("rank:ndcg", {"lambdarank_pair_method": "mean"}),
])
def test_ranking_card_json_is_the_cpus(objective, extra):
    """deterministic_histogram=1: the card's ranking model JSON is the
    CPU's; K5 launched once a round and once for the base score (top-k),
    never with the mean method."""
    rng = np.random.default_rng(9)
    sizes = rng.integers(5, 80, 40)
    R = int(sizes.sum())
    X = rng.normal(size=(R, 6)).astype(np.float32)
    y = np.clip(np.round(X[:, 0] + rng.normal(size=R)), 0, 4).astype(
        np.float32)
    params = {"objective": objective, "max_depth": 4, "max_bin": 64,
              "deterministic_histogram": 1, **extra}
    hist_cuda.reset_launches()
    card = xtt.train(params, xtt.DMatrix(X, label=y, group=sizes), 4,
                     verbose_eval=False)
    assert hist_cuda.launches["lambdarank"] == (0 if extra else 1 + 4)
    cpu = xtt.train(params, xtt.DMatrix(X, label=y, group=sizes,
                                        device="cpu"), 4, verbose_eval=False,
                    device="cpu")
    assert json.dumps(card.save_raw_dict()) == json.dumps(cpu.save_raw_dict())
