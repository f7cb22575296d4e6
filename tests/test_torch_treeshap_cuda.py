"""K6 (csrc/treeshap.cu) on the card: exact TreeSHAP values and interaction
terms held against their plain PyTorch versions (interpret/device.py
bucket_phi_plain, bucket_interactions_plain) on the same card, on random
trees whose paths hold m = 1 to 12 unique features, at F = 28 and 256,
with NaN in the input; each block size K6 takes and its global-memory
tiles; a refused launch raising; the launch counts; and
``predict(pred_contribs=True)`` / ``pred_interactions=True`` on the card
against the CPU.  Tolerance: each term is the plain version's bit for bit
(both round every operation alone), only the f32 sums within a bucket are
taken in another order (index_add_'s atomics), so the f64 totals agree
within 1e-5 of the largest |value| plus 1e-6.

Every test needs a CUDA device and skips without one; run them on the card
with ``python -m pytest -q -p no:cacheprovider
tests/test_torch_treeshap_cuda.py``.  The file imports PyTorch and the
port only, so it runs on a machine that has no JAX."""
import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xtt
from xgboost_tpu_torch.interpret import device as dv
from xgboost_tpu_torch.models.tree import RegTree
from xgboost_tpu_torch.ops import hist_cuda, treeshap_cuda

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernel runs only on a GPU")


def random_tree(rng, depth: int, n_feat: int, split_p: float = 0.8,
                pool=None) -> RegTree:
    """A random numeric tree of at most ``depth`` levels whose covers add
    up; features drawn from ``pool`` (default all), so a path of d nodes
    holds up to min(d, len(pool)) unique features."""
    pool = np.arange(n_feat) if pool is None else np.asarray(pool)
    left, right, parent, feat, cond, dleft, cover = [], [], [], [], [], [], []

    def node(par, d, c):
        i = len(left)
        for col, val in ((left, -1), (right, -1), (parent, par),
                         (feat, 0), (cond, 0.0), (dleft, False),
                         (cover, c)):
            col.append(val)
        if d < depth and (d == 0 or rng.random() < split_p):
            feat[i] = int(rng.choice(pool))
            cond[i] = float(rng.normal())
            dleft[i] = bool(rng.random() < 0.5)
            frac = rng.uniform(0.1, 0.9)
            left[i] = node(i, d + 1, c * frac)
            right[i] = node(i, d + 1, c * (1 - frac))
        else:
            cond[i] = float(rng.normal() * 0.3)
        return i

    node(-1, 0, 1000.0)
    n = len(left)
    return RegTree(
        left_children=np.asarray(left, np.int32),
        right_children=np.asarray(right, np.int32),
        parents=np.asarray(parent, np.int32),
        split_indices=np.asarray(feat, np.int32),
        split_conditions=np.asarray(cond, np.float32),
        default_left=np.asarray(dleft, bool),
        base_weights=np.zeros(n, np.float32),
        loss_changes=np.zeros(n, np.float32),
        sum_hessian=np.asarray(cover, np.float32))


def random_ensemble(seed: int, n_feat: int, depths=(12, 8, 3)):
    """Trees of the given depths, the second drawing its features from
    four, so that its paths repeat features (m < D), with weights as DART
    gives them."""
    rng = np.random.default_rng(seed)
    trees = [random_tree(rng, d, n_feat, pool=[0, 1, 2, 3] if i == 1
                         else None) for i, d in enumerate(depths)]
    return trees, [1.0, 0.5, 1.5][:len(trees)]


def random_X(seed: int, R: int, F: int, nan: float = 0.1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < nan] = np.nan
    return X


def _close(got, want):
    tol = 1e-5 * float(want.abs().max()) + 1e-6
    err = float((got - want).abs().max())
    assert err <= tol, f"max |K6 - plain| {err:.3g} > {tol:.3g}"


@needs_cuda
@pytest.mark.parametrize("F", [28, 256])
def test_values_match_plain(F):
    trees, w = random_ensemble(2, F)
    tables = dv.path_tables(trees, w, F)
    assert {m for m, _ in tables.buckets} >= set(range(1, 13))
    X = torch.from_numpy(random_X(1, 700, F)).cuda()
    _close(treeshap_cuda.treeshap_cuda(X, tables),
           dv.shap_values_plain(X, tables))


@needs_cuda
@pytest.mark.parametrize("F", [28, 256])
def test_interactions_match_plain(F):
    trees, w = random_ensemble(2, F, depths=(12, 5))
    tables = dv.path_tables(trees, w, F)
    X = torch.from_numpy(random_X(3, 150, F)).cuda()
    _close(treeshap_cuda.treeshap_cuda(X, tables, interactions=True),
           dv.shap_interactions_plain(X, tables))


@needs_cuda
@pytest.mark.parametrize("rows", [128, 64, 32, 0])
@pytest.mark.parametrize("interactions", [False, True])
def test_each_block_size_and_global_tiles(rows, interactions):
    F = 10
    trees, w = random_ensemble(4, F, depths=(10, 4))
    tables = dv.path_tables(trees, w, F)
    X = torch.from_numpy(random_X(5, 300, F)).cuda()
    got = treeshap_cuda.treeshap_cuda(X, tables, interactions,
                                      rows_per_block=rows)
    want = (dv.shap_interactions_plain(X, tables) if interactions
            else dv.shap_values_plain(X, tables))
    _close(got, want)


@needs_cuda
def test_same_bits_run_to_run():
    trees, w = random_ensemble(6, 28)
    tables = dv.path_tables(trees, w, 28)
    X = torch.from_numpy(random_X(7, 2000, 28)).cuda()
    a = treeshap_cuda.treeshap_cuda(X, tables)
    b = treeshap_cuda.treeshap_cuda(X, tables)
    assert torch.equal(a, b)


@needs_cuda
def test_refused_launch_raises_and_counts_nothing():
    """A block of 1024 rows at F = 256 asks for more shared memory than a
    block may have; the card refuses, the wrapper raises."""
    trees, w = random_ensemble(8, 256, depths=(4,))
    tables = dv.path_tables(trees, w, 256)
    X = torch.from_numpy(random_X(9, 64, 256)).cuda()
    before = dict(hist_cuda.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        treeshap_cuda.treeshap_cuda(X, tables, rows_per_block=1024)
    assert hist_cuda.launches == before
    treeshap_cuda.treeshap_cuda(X, tables)  # the next launch runs
    assert hist_cuda.launches["treeshap"] == before["treeshap"] + 1


def _trained(device, params, rounds=4):
    X = random_X(10, 3000, 8, nan=0.05)
    y = ((np.nan_to_num(X[:, 0]) > 0).astype(np.float32)
         + (np.nan_to_num(X[:, 1]) > 0.5))  # three classes
    return xtt.train(dict(params, max_bin=64), xtt.DMatrix(
        X, label=y, device=device), rounds, verbose_eval=False,
        device=device), X


@needs_cuda
def test_predict_counts_one_launch_a_group_and_matches_the_cpu():
    params = {"objective": "multi:softprob", "num_class": 3, "max_depth": 5,
              "deterministic_histogram": 1}
    cpu, X = _trained("cpu", params)
    card = xtt.Booster(model_file=bytearray(cpu.save_raw("json")))
    hist_cuda.reset_launches()
    got = card.predict(xtt.DMatrix(X), pred_contribs=True)
    assert hist_cuda.launches["treeshap"] == 3
    want = cpu.predict(xtt.DMatrix(X, device="cpu"), pred_contribs=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    inter = card.predict(xtt.DMatrix(X), pred_interactions=True)
    assert hist_cuda.launches["treeshap_interactions"] == 3
    assert hist_cuda.launches["treeshap"] == 6  # each diagonal's values
    np.testing.assert_allclose(
        inter, cpu.predict(xtt.DMatrix(X, device="cpu"),
                           pred_interactions=True), rtol=1e-5, atol=1e-6)
    saabas = card.predict(xtt.DMatrix(X), pred_contribs=True,
                          approx_contribs=True)
    assert np.array_equal(saabas, cpu.predict(
        xtt.DMatrix(X, device="cpu"), pred_contribs=True,
        approx_contribs=True))
