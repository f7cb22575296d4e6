"""The port's interpretation layer on the CPU against xgboost_tpu's, on the
same models (trained by the reference or read from tests/data/models, and
loaded into the port through their JSON) and the same rows:

- the host walk (``shap_values_tree``, every row at once) against the
  reference's (which runs its native twin here) within 1e-12 relative,
  and against brute-force Shapley values within 1e-6;
- ``predict(pred_contribs=True)`` on the golden binary, multiclass and DART
  models and a DART model with dropped trees' weights, NaN in 15% of the
  cells, within the reference's own device tolerance (rtol 2e-4, atol
  2e-5, tests/test_shap.py), and local accuracy (rtol 1e-4, atol 1e-5);
- a lossguide model whose paths hold more than 8 unique features;
- ``approx_contribs=True`` (Saabas, on the booster's device) bitwise;
- ``pred_interactions=True`` on both sides of the 128-row dispatch within
  rtol 1e-4, atol 1e-5;
- the golden categorical model (host walk: exact, Saabas, interactions)
  and gblinear's contributions bitwise, gblinear's interactions raising;
- ``iteration_range``, a stump, an empty range (the bias alone), a
  vector-leaf model raising (the reference's numbers miss the margin
  there) and the matrix's base margin left out of the bias;
- the pieces of K6 the CPU can reach: its tables, its launch plan, its
  operation count, and ``treeshap_model`` (the kernel's loop order in
  PyTorch) against the plain version on random trees of m = 1 to 12."""
import itertools
import math
import os

import numpy as np
import pytest
import torch

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu.interpret import shap_values_tree as ref_shap_values_tree
from xgboost_tpu_torch.convert import booster_from_dict
from xgboost_tpu_torch.interpret import device as dv
from xgboost_tpu_torch.interpret import shap_values_tree
from xgboost_tpu_torch.ops import treeshap_cuda
from test_torch_treeshap_cuda import random_ensemble, random_X

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "data", "models")
DEVICE_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_shap.py:118
LOCAL_TOL = dict(rtol=1e-4, atol=1e-5)
INTER_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_oracle_parity.py:330


def _port(ref):
    return booster_from_dict(ref.save_raw_dict(), device="cpu")


def _both(X, **kw):
    return xtb.DMatrix(X, **kw), xtt.DMatrix(X, device="cpu", **kw)


def _data(R=300, F=6, seed=0, nan=0.15):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    y = (np.nan_to_num(X[:, 0]) * np.nan_to_num(X[:, 1])
         + 0.5 * np.nan_to_num(X[:, 2]) > 0).astype(np.float32)
    X[rng.random(X.shape) < nan] = np.nan
    return X, y


def _golden_X(seed=0):
    X = np.load(os.path.join(GOLD, "golden_X.npy")).astype(np.float32)[:300]
    X[np.random.default_rng(seed).random(X.shape) < 0.15] = np.nan
    return X


@pytest.fixture(scope="module")
def small():
    """tests/test_shap.py's model: 300 x 5 regression, depth 3, 3 rounds."""
    rng = np.random.default_rng(21)
    X = rng.normal(size=(300, 5)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] * X[:, 2]
         + 0.1 * rng.normal(size=300)).astype(np.float32)
    ref = xtb.train({"objective": "reg:squarederror", "max_depth": 3,
                     "base_score": 0.0}, xtb.DMatrix(X, label=y), 3,
                    verbose_eval=False)
    return ref, _port(ref), X


@pytest.fixture(scope="module")
def models():
    out = {name: (xtb.Booster(model_file=os.path.join(GOLD, name + ".json")),
                  xtt.Booster(model_file=os.path.join(GOLD, name + ".json"),
                              device="cpu"))
           for name in ("binary", "multiclass", "dart")}
    X, y = _data(seed=3)
    ref = xtb.train({"objective": "binary:logistic", "booster": "dart",
                     "rate_drop": 0.5, "max_depth": 3, "seed": 1},
                    xtb.DMatrix(X, label=y), 5, verbose_eval=False)
    assert len(set(ref.tree_weights)) > 1  # dropped trees were rescaled
    out["dart_dropped"] = (ref, _port(ref))
    return out


# ------------------------------------------------------------- host walk
@pytest.mark.parametrize("tree", range(3))
def test_host_walk_is_the_references(small, tree):
    ref, port, X = small
    rows = X.astype(np.float64)
    want = ref_shap_values_tree(ref.trees[tree], rows)
    got = shap_values_tree(port.trees[tree], rows)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def _expectation(tree, x, S):
    """E[f(x) | x_S] with path-dependent (cover-weighted) expectations
    (tests/test_shap.py)."""
    t_left, t_right = tree.left_children, tree.right_children
    feat, thr, dl = tree.split_indices, tree.split_conditions, \
        tree.default_left
    cover = np.maximum(tree.sum_hessian, 1e-16)

    def rec(n):
        if t_left[n] < 0:
            return tree.split_conditions[n]
        f = feat[n]
        if f in S:
            go_left = dl[n] if np.isnan(x[f]) else x[f] < thr[n]
            return rec(t_left[n] if go_left else t_right[n])
        l, r = t_left[n], t_right[n]
        w = cover[l] + cover[r]
        return (cover[l] * rec(l) + cover[r] * rec(r)) / w

    return rec(0)


def _brute_shapley(tree, x, n_features):
    used = sorted(set(tree.split_indices[tree.left_children >= 0].tolist()))
    phi = np.zeros(n_features + 1)
    M = len(used)
    for i in used:
        others = [f for f in used if f != i]
        for k in range(M):
            for S in itertools.combinations(others, k):
                w = (math.factorial(len(S)) * math.factorial(M - len(S) - 1)
                     / math.factorial(M))
                phi[i] += w * (_expectation(tree, x, set(S) | {i})
                               - _expectation(tree, x, set(S)))
    phi[n_features] = _expectation(tree, x, set())
    return phi


def test_host_walk_is_the_brute_force_shapley_values(small):
    _, port, X = small
    rows = X[:5].astype(np.float64)
    fast = shap_values_tree(port.trees[0], rows)
    for r in range(5):
        np.testing.assert_allclose(
            fast[r], _brute_shapley(port.trees[0], rows[r], X.shape[1]),
            rtol=1e-6, atol=1e-8)


# ------------------------------------------------------- exact on the tables
@pytest.mark.parametrize("name", ["binary", "multiclass", "dart",
                                  "dart_dropped"])
def test_contribs_match_the_reference(models, name):
    ref, port = models[name]
    X = _golden_X() if name != "dart_dropped" else _data(seed=4)[0]
    d, dp = _both(X)
    got = port.predict(dp, pred_contribs=True)
    want = ref.predict(d, pred_contribs=True)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, **DEVICE_TOL)
    margin = port.predict(dp, output_margin=True)
    np.testing.assert_allclose(got.sum(-1), margin, **LOCAL_TOL)


@pytest.mark.parametrize("name", ["binary", "multiclass", "dart",
                                  "dart_dropped"])
def test_saabas_is_the_references_bitwise(models, name):
    ref, port = models[name]
    X = _golden_X(1)
    d, dp = _both(X)
    got = port.predict(dp, pred_contribs=True, approx_contribs=True)
    assert np.array_equal(got, ref.predict(d, pred_contribs=True,
                                           approx_contribs=True))
    np.testing.assert_allclose(got.sum(-1), port.predict(
        dp, output_margin=True), **LOCAL_TOL)


@pytest.fixture(scope="module")
def lossguide():
    """A lossguide tree of up to 80 leaves on 14 features, a target that
    reads every feature: paths of 9 unique features (m > 8 needs F > 8)."""
    X, _ = _data(R=300, F=14, seed=5, nan=0.1)
    rng = np.random.default_rng(5)
    y = (np.nan_to_num(X) @ rng.normal(size=14)
         + np.nan_to_num(X[:, 0] * X[:, 1])).astype(np.float32)
    ref = xtb.train({"objective": "reg:squarederror", "eta": 0.5,
                     "grow_policy": "lossguide", "max_depth": 0,
                     "max_leaves": 80, "min_child_weight": 0},
                    xtb.DMatrix(X, label=y), 1, verbose_eval=False)
    return ref, _port(ref), X


def test_lossguide_paths_past_eight_features(lossguide):
    ref, port, X = lossguide
    tables = dv.path_tables(port.trees, [1.0] * len(port.trees), 14)
    assert max(m for m, _ in tables.buckets) > treeshap_cuda.SMALL_M
    d, dp = _both(X)
    np.testing.assert_allclose(port.predict(dp, pred_contribs=True),
                               ref.predict(d, pred_contribs=True),
                               **DEVICE_TOL)


# --------------------------------------------------------------- interactions
@pytest.mark.parametrize("rows", [100, 200])  # host walk / the tables
@pytest.mark.parametrize("name", ["binary", "multiclass", "dart_dropped"])
def test_interactions_match_the_reference(models, name, rows):
    ref, port = models[name]
    X = _golden_X(2)[:rows]
    d, dp = _both(X)
    got = port.predict(dp, pred_interactions=True)
    want = ref.predict(d, pred_interactions=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **INTER_TOL)
    np.testing.assert_allclose(got.sum(-1), port.predict(
        dp, pred_contribs=True), rtol=3e-4, atol=5e-5)


def test_lossguide_interactions_tables_against_the_host_walk(lossguide):
    """m > 8 interactions: the plain tables against the f64 host walk, both
    the port's (the reference's XLA programs take a minute to compile at
    this m)."""
    from xgboost_tpu_torch.interpret import predict_interactions

    _, port, X = lossguide
    dp = xtt.DMatrix(X[:150], device="cpu")
    trees = slice(0, len(port.trees))
    np.testing.assert_allclose(
        predict_interactions(port, dp, trees, use_device=True),
        predict_interactions(port, dp, trees, use_device=False), **INTER_TOL)


# ------------------------------------------------- categorical and gblinear
@pytest.mark.parametrize("kw", [dict(pred_contribs=True),
                                dict(pred_contribs=True,
                                     approx_contribs=True),
                                dict(pred_interactions=True)],
                         ids=["exact", "saabas", "interactions"])
def test_categorical_host_walk_is_the_references(kw):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    df = pd.read_parquet(os.path.join(GOLD, "categorical_X.parquet"))
    path = os.path.join(GOLD, "categorical.json")
    ref, port = xtb.Booster(model_file=path), xtt.Booster(model_file=path,
                                                           device="cpu")
    d = xtb.DMatrix(df, enable_categorical=True)
    dp = xtt.DMatrix(df, enable_categorical=True, device="cpu")
    got, want = port.predict(dp, **kw), ref.predict(d, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.sum(-1) if "pred_contribs" in kw
                               else got.sum((-2, -1)),
                               port.predict(dp, output_margin=True),
                               **LOCAL_TOL)


def test_gblinear_contributions_bitwise_and_no_interactions():
    path = os.path.join(GOLD, "gblinear.json")
    ref, port = xtb.Booster(model_file=path), xtt.Booster(model_file=path,
                                                           device="cpu")
    d, dp = _both(_golden_X(3))
    got = port.predict(dp, pred_contribs=True)
    assert np.array_equal(got, ref.predict(d, pred_contribs=True))
    np.testing.assert_allclose(got.sum(-1), port.predict(
        dp, output_margin=True), **LOCAL_TOL)
    with pytest.raises(ValueError, match="gblinear"):
        port.predict(dp, pred_interactions=True)


# ---------------------------------------------------------- ranges and edges
@pytest.mark.parametrize("rng_", [(1, 3), (0, 1), (2, 2)],
                         ids=["slice", "first", "empty"])
@pytest.mark.parametrize("kw", [dict(pred_contribs=True),
                                dict(pred_contribs=True,
                                     approx_contribs=True),
                                dict(pred_interactions=True)],
                         ids=["exact", "saabas", "interactions"])
def test_iteration_range(models, rng_, kw):
    ref, port = models["multiclass"]
    d, dp = _both(_golden_X(4)[:150])
    lo, hi = rng_
    got = port.predict(dp, iteration_range=(lo, hi), **kw)
    want = ref.predict(d, iteration_range=(lo, hi), **kw)
    np.testing.assert_allclose(got, want, **INTER_TOL)
    if lo == hi:  # no trees: the bias alone (the base score)
        base = np.asarray(port.base_score).reshape(-1)
        bias = got[..., -1] if "pred_contribs" in kw else got[..., -1, -1]
        assert np.array_equal(bias, np.broadcast_to(base, bias.shape))
        assert not (got[..., :-1] if "pred_contribs" in kw
                    else got[..., :-1, :]).any()


@pytest.mark.parametrize("kw", [dict(pred_contribs=True),
                                dict(pred_contribs=True,
                                     approx_contribs=True),
                                dict(pred_interactions=True)],
                         ids=["exact", "saabas", "interactions"])
def test_stump(kw):
    X, _ = _data(R=200, seed=6)
    y = np.random.default_rng(6).normal(size=200).astype(np.float32)
    ref = xtb.train({"objective": "reg:squarederror", "max_depth": 3,
                     "min_child_weight": 1e9}, xtb.DMatrix(X, label=y), 2,
                    verbose_eval=False)
    assert all(t.n_nodes == 1 for t in ref.trees)
    d, dp = _both(X)
    got = _port(ref).predict(dp, **kw)
    assert np.array_equal(got, ref.predict(d, **kw))


def test_vector_leaf_model_raises():
    """The reference explains a multi_output_tree model with numbers whose
    rows miss the margin (its host walk reads a vector leaf's
    split_conditions as the leaf value); the port refuses."""
    X, _ = _data(R=200, F=4, seed=7, nan=0.0)
    Y = np.stack([X[:, 0] + X[:, 1], X[:, 2] * X[:, 3]], 1)
    ref = xtb.train({"objective": "reg:squarederror", "num_target": 2,
                     "multi_strategy": "multi_output_tree", "max_depth": 3},
                    xtb.DMatrix(X, label=Y), 2, verbose_eval=False)
    d, dp = _both(X)
    miss = np.abs(ref.predict(d, pred_contribs=True).sum(-1)
                  - ref.predict(d, output_margin=True)).max()
    assert miss > 1e-2
    port = _port(ref)
    for kw in (dict(pred_contribs=True), dict(pred_interactions=True)):
        with pytest.raises(ValueError, match="vector-leaf"):
            port.predict(dp, **kw)


@pytest.mark.parametrize("kw", [dict(pred_contribs=True),
                                dict(pred_contribs=True,
                                     approx_contribs=True),
                                dict(pred_interactions=True)],
                         ids=["exact", "saabas", "interactions"])
def test_base_margin_is_not_added(models, kw):
    """As in the reference, a matrix's base margin enters neither the bias
    column nor any other: the contributions are those of the plain
    matrix."""
    ref, port = models["binary"]
    X = _golden_X(5)[:150]
    bm = np.linspace(-2, 2, len(X)).astype(np.float32)
    d, dp = _both(X, base_margin=bm)
    got = port.predict(dp, **kw)
    np.testing.assert_array_equal(got, port.predict(
        xtt.DMatrix(X, device="cpu"), **kw))
    np.testing.assert_allclose(got, ref.predict(d, **kw), **INTER_TOL)


# ------------------------------------------------- K6's pieces on the CPU
@pytest.mark.parametrize("interactions", [False, True])
@pytest.mark.parametrize("F", [5, 28])
def test_kernel_order_model_matches_plain(F, interactions):
    """``treeshap_model`` walks the packed tables in K6's order; its f32
    terms are the plain version's, its sums in path order."""
    trees, w = random_ensemble(2, F, depths=(12, 8, 3) if not interactions
                               else (9, 4))
    tables = dv.path_tables(trees, w, F)
    X = torch.from_numpy(random_X(3, 60, F))
    want = (dv.shap_interactions_plain(X, tables) if interactions
            else dv.shap_values_plain(X, tables))
    got = treeshap_cuda.treeshap_model(X, tables, interactions)
    tol = 1e-5 * float(want.abs().max()) + 1e-6
    assert float((got - want).abs().max()) <= tol
    if not interactions:  # index_add_ on the CPU adds in index order
        assert torch.equal(got, want)


def test_tables_values_agree_with_the_host_walk():
    """m = 1 to 12 on random trees: the plain tables against the f64 host
    walk (the two algorithms of path-dependent TreeSHAP)."""
    trees, w = random_ensemble(2, 28)
    tables = dv.path_tables(trees, w, 28)
    assert {m for m, _ in tables.buckets} >= set(range(1, 13))
    X = random_X(4, 40, 28)
    got = dv.shap_values_plain(torch.from_numpy(X), tables).numpy()
    want = sum(wt * shap_values_tree(t, X.astype(np.float64))
               for t, wt in zip(trees, w))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_packed_tables_and_plan():
    trees, w = random_ensemble(2, 28)
    tables = dv.path_tables(trees, w, 28)
    for inter in (False, True):
        pk = treeshap_cuda.pack_tables(tables, inter, "cpu")
        meta = pk.meta.numpy()
        shapes = [(m, D) for m, D in tables.buckets if not inter or m >= 2]
        assert [tuple(r[2:4]) for r in meta] == shapes
        assert (meta[1:, 0] == meta[:-1, 1]).all()  # paths follow on
        assert meta[-1, 1] == len(pk.v)
        assert meta[-1, 8] == len(pk.cells)
        assert len(pk.node_feat) == sum(
            (r[1] - r[0]) * r[3] for r in meta)
        assert pk.max_m == 12
    assert treeshap_cuda.plan(28, False) == (128, 129 * (29 * 12 + 28 * 4))
    assert treeshap_cuda.plan(256, False)[0] == 32
    assert treeshap_cuda.plan(28, True) == (0, 0)  # the global tiles
    nbytes, ops = treeshap_cuda.work(tables, 1000)
    assert nbytes == 1000 * (4 * 28 + 8 * 29)
    # a bucket of m = 1: per path one term of 2 (the weight) + 4 operations
    one = dict(tables.buckets)
    tables.buckets = {k: b for k, b in one.items() if k[0] == 1}
    P = sum(len(b["v"]) for b in tables.buckets.values())
    assert treeshap_cuda.work(tables, 1000)[1] == 1000 * P * 6
    assert ops > 1000 * P * 6


def test_cpu_tensor_takes_the_plain_version():
    """The dispatcher sends a CPU tensor to the plain version; the K6
    wrapper refuses one."""
    trees, w = random_ensemble(2, 6, depths=(5,))
    X = torch.from_numpy(random_X(5, 30, 6))
    tables = dv.path_tables(trees, w, 6)
    assert torch.equal(dv.shap_values_device(trees, w, X),
                       dv.shap_values_plain(X, tables))
    with pytest.raises(ValueError, match="CUDA"):
        treeshap_cuda.treeshap_cuda(X, tables)
