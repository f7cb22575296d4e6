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
    # no room in the table: every bucket's terms a row, the same bits
    assert torch.equal(treeshap_cuda.treeshap_model(
        X, tables, interactions, tab_bytes=0), got)


@pytest.mark.parametrize("m,interactions",
                         [(m, False) for m in (1, 2, 3, 5, 8, 9)]
                         + [(m, True) for m in (2, 3, 5, 8, 9)])
def test_prefix_shared_terms_are_the_plain_terms(m, interactions):
    """``path_terms`` (K6's order: each element's coefficients from the
    shared prefix of the elements before it) gives the plain version's
    terms bit for bit, at every mask of one path: the plain version over
    one path puts each term alone in its cell."""
    rng = np.random.default_rng(m)
    F = m + 2
    feats = rng.permutation(F)[:m].astype(np.int32)
    went_left = rng.random(m) < 0.5
    masks = np.arange(1 << m)
    bits = (masks[:, None] >> np.arange(m)) & 1 == 1  # the slots left
    X = np.zeros((len(masks), F), np.float32)
    # left (x < 0) or right (x >= 0) of the threshold 0, as the mask says
    X[:, feats] = np.where(bits != went_left[None], -1.0, 1.0)
    b = dict(node_feat=feats[None], node_thr=np.zeros((1, m), np.float32),
             node_dleft=rng.random((1, m)) < 0.5, node_dir=went_left[None],
             node_slot=np.arange(m, dtype=np.int32)[None],
             z=rng.uniform(0.05, 0.95, (1, m)).astype(np.float32),
             slot_feat=feats[None], v=rng.normal(size=1).astype(np.float32))
    args = [torch.from_numpy(np.ascontiguousarray(b[k])) for k in
            ("node_feat", "node_thr", "node_dleft", "node_dir", "node_slot",
             "z", "slot_feat", "v")]
    w = torch.from_numpy(dv.shapley_weights(m - 1 if interactions else m))
    Xt = torch.from_numpy(X)
    o = torch.from_numpy(~bits).float()
    terms = treeshap_cuda.path_terms(o, args[5][0], args[7][0], w,
                                     interactions)
    if not interactions:
        plain = dv.bucket_phi_plain(Xt, *args, w, m=m, n_feat=F)
        for i in range(m):
            assert torch.equal(plain[:, feats[i]], terms[:, i])
        return
    plain = dv.bucket_interactions_plain(Xt, *args, w, m=m, n_feat=F)
    for q, (s, j) in enumerate(zip(*np.triu_indices(m, 1))):
        assert torch.equal(plain[:, feats[s], feats[j]], terms[:, q])
        assert torch.equal(plain[:, feats[j], feats[s]], terms[:, q])


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
        n_tab = 0
        assert (meta[1:, 0] == meta[:-1, 1]).all()  # paths follow on
        assert meta[-1, 1] == len(pk.v)
        assert meta[-1, 8] == len(pk.cells)
        assert len(pk.node) == sum((r[1] - r[0]) * r[3] for r in meta)
        assert pk.max_m == 12
        F1 = 29
        union = np.flatnonzero(pk.out_u.numpy() >= 0)
        if inter:  # the union holds [a, b], a < b; [b, a] reads its sum
            union = union[union // F1 < union % F1]
        assert (pk.out_u.numpy()[union] == np.arange(pk.n_union)).all()
        for r, ((m, D), b) in zip(meta, ((k, b) for k, b in
                                          tables.buckets.items()
                                          if not inter or k[0] >= 2)):
            p0, p1, _, _, nb, _, _, c0, c1, pc0, tb = r
            # the node records: feature, slot and flags, the threshold
            word = pk.node[nb:nb + (p1 - p0) * D, 0].numpy()
            assert (word >> 10 == b["node_feat"].reshape(-1)).all()
            assert ((word >> 2) & 255 == b["node_slot"].reshape(-1)).all()
            assert ((word >> 1) & 1 == b["node_dir"].reshape(-1)).all()
            assert (word & 1 == b["node_dleft"].reshape(-1)).all()
            assert (pk.node[nb:nb + (p1 - p0) * D, 1].numpy().view(np.float32)
                    == b["node_thr"].reshape(-1)).all()
            # each path's cells through its bucket's list and the union
            sf = b["slot_feat"]
            if inter:  # one cell a pair: [f_s, f_j] and [f_j, f_s] alike
                s, j = np.triu_indices(m, 1)
                want = (np.minimum(sf[:, s], sf[:, j]) * F1
                        + np.maximum(sf[:, s], sf[:, j]))
                assert (pk.out_u.numpy()[want % F1 * F1 + want // F1]
                        == pk.out_u.numpy()[want]).all()
            else:
                want = sf
            local = pk.pcell[pc0:pc0 + want.size].numpy()
            assert local.max() < c1 - c0
            got = union[pk.cells.numpy()[c0 + local]]
            assert (got == want.reshape(-1)).all()
            assert c1 - c0 == len(np.unique(want))
            if m <= treeshap_cuda.SMALL_M:  # the tabulated terms a path
                nt = m * (m - 1) // 2 if inter else m
                assert tb == n_tab  # the tables follow on
                n_tab += (p1 - p0) * nt << m
            else:  # computed a row
                assert tb == -1
        # at 256 rows every small bucket is tabulated, at 255 none of m = 8
        assert treeshap_cuda.tab_floats(pk, 256) == n_tab
        assert [treeshap_cuda.tabulated(pk, i, 255) for i in range(len(meta))
                ] == [0 <= r[10] and r[2] < 8 for r in meta]
        # a budget of the first bucket's table alone: the rest a row
        first = int(meta[1, 10])  # the first bucket's floats
        small = treeshap_cuda.pack_tables(tables, inter, "cpu",
                                          tab_bytes=4 * first)
        assert small.tab_off == (0,) + (-1,) * (len(meta) - 1)
        assert treeshap_cuda.tab_floats(small, 1 << 20) == first
        assert pk.tile_max == max(meta[:, 8] - meta[:, 7])
        assert pk.n_union == len(np.unique(pk.cells.numpy()))
    # values: the union's f64 totals and X's rows and the bucket's sums in
    # f32; two rows a thread would leave an SM 8 warps (two blocks of 256
    # rows), so one: 128 rows a block
    pk = treeshap_cuda.pack_tables(tables, False, "cpu")
    assert (pk.tile_max, pk.n_union) == (28, 28)
    assert treeshap_cuda.plan(pk) == (128, 1,
                                      8 * 28 * 129 + 4 * 128 * (28 + 28))
    assert treeshap_cuda.plan(pk, 2) == (256, 2,
                                         8 * 28 * 257 + 4 * 256 * (28 + 28))
    # interactions: 359 pairs in one bucket, 376 in the union: a 32-row
    # block of one row a thread
    ipk = treeshap_cuda.pack_tables(tables, True, "cpu")
    assert (ipk.tile_max, ipk.n_union) == (359, 376)
    assert treeshap_cuda.plan(ipk) == (32, 1, 8 * 376 * 33 + 4 * 32 * 387)
    # two rows a thread where an SM holds 16 warps of such blocks, else one
    assert treeshap_cuda.warps_per_sm(128, 47152) == 16
    assert treeshap_cuda.warps_per_sm(128, 68712) == 12
    assert treeshap_cuda.warps_per_sm(128, 218544) == 4
    wide = dv.path_tables(*random_ensemble(2, 256), 256)
    assert treeshap_cuda.plan(
        treeshap_cuda.pack_tables(wide, False, "cpu"))[:2] == (32, 1)
    # at F = 256 the interactions' pairs fit no block: the global tiles
    assert treeshap_cuda.plan(
        treeshap_cuda.pack_tables(wide, True, "cpu")) == (0, 1, 0)
    nbytes, f32, f64 = treeshap_cuda.work(tables, 1000)
    assert nbytes > 1000 * (4 * 28 + 8 * 29)  # and the packed tables once
    vmeta = pk.meta.numpy()  # the values' flushes and the bias, in f64
    assert f64 == 1000 * (int((vmeta[:, 8] - vmeta[:, 7]).sum()) + 1)
    # a bucket of m = 1: per path 2 masks of 4 operations (the weight, the
    # term), and each row's add
    one = dict(tables.buckets)
    tables.buckets = {k: b for k, b in one.items() if k[0] == 1}
    P = sum(len(b["v"]) for b in tables.buckets.values())
    assert treeshap_cuda.work(tables, 1000)[1] == P * 2 * 4 + 1000 * P
    assert f32 > P * 2 * 4 + 1000 * P


@pytest.mark.parametrize("m", [1, 2, 5, 8])
def test_term_ops_count_the_shared_prefixes(m):
    """``term_ops``: each element's polynomial over the m-1 others, with
    the prefix of the elements before it built once (m = 5: 106 of the
    plain order's 130 operations; m = 8: 469 of 616), then its weight sum
    (2m - 1) and its term (3)."""
    poly = {1: 0, 2: 4, 5: 106, 8: 469}[m]
    assert treeshap_cuda.term_ops(m, False) == poly + m * (2 * m - 1 + 3)
    plain = m * (2 * (m - 1) + 1.5 * (m - 1) * (m - 2))
    assert poly <= plain and (m < 5 or poly < plain)


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
