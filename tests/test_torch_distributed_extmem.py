"""Port parity for out-of-core, exact and process_type="update" training
across ranks: two in-memory ranks (threads, each on its own pages or rows)
of the port against two of the reference on the same data, one rank
against two, and ``train_distributed``'s gloo worker processes over
out-of-core parts against the in-memory ranks.

Tolerances:
- ``ShardMap`` and the streaming cuts: the reference's values and bits.
- deterministic_histogram out of core, exact, and refresh/prune/sync: the
  model JSON byte-identical to the reference's at the same ranks, on every
  rank; out of core also to one rank on the same pages, and to the port's
  in-memory model on the same cuts; exact also to one process on the
  union.
- f32 out of core: the same tree structures and predictions within 1e-4
  of the reference's, as the in-core f32 parity tests hold: the two
  packages sum f32 gradients in other orders.

Each rank joins its thread with a timeout (``ranks``) and fails on a
hang."""
import functools
import json

import numpy as np
import pytest

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu.utils import native as ref_native
from xgboost_tpu_torch.tree import stream as port_stream

from test_torch_collective import ranks
from torch_extmem_parts import (PARTS_MAX_BIN, PARTS_PAGE_ROWS, PARTS_PAGES,
                                extmem_part, pages, parts_data)


@pytest.fixture(scope="module", autouse=True)
def _reference_native_scan():
    """The reference's rank threads take its native split scan only when
    its library was loaded in the main thread first (see
    tests/test_torch_distributed.py)."""
    ref_native.load_ffi()


def _js(bst) -> str:
    if isinstance(bst, xtt.Booster):
        return json.dumps(bst.save_raw_dict())
    return json.dumps(json.loads(bst.save_raw("json").decode()))


def _dev(pkg):
    return {} if pkg is xtb else {"device": "cpu"}


def _ext(pkg, it, **kw):
    """``pkg``'s ExtMemQuantileDMatrix over ``it`` (the port's on the CPU,
    uncompressed)."""
    if pkg is xtt:
        kw.update(device="cpu", compress=False)
    return pkg.ExtMemQuantileDMatrix(it, **kw)


# ------------------------------------------------------------------ ShardMap
@pytest.mark.parametrize("num_shards,world",
                         [(1, 1), (4, 2), (5, 2), (7, 3), (64, 2)])
def test_shard_map_is_the_references(num_shards, world):
    got = xtt.ShardMap.create(num_shards, world)
    want = xtb.ShardMap.create(num_shards, world)
    assert got.assign == want.assign
    assert [got.shards_of(r) for r in range(world)] == \
        [want.shards_of(r) for r in range(world)]
    assert got.to_dict() == want.to_dict()
    assert xtt.ShardMap.from_dict(got.to_dict()) == got
    bare = {"num_shards": num_shards, "world": world}
    assert xtt.ShardMap.from_dict(bare) == got
    assert got.rebalance(1).to_dict() == want.rebalance(1).to_dict()


@pytest.mark.parametrize("make", [
    lambda m: m.ShardMap.create(1, 2),
    lambda m: m.ShardMap.create(0, 1),
    lambda m: m.ShardMap.create(3, 0),
    lambda m: m.ShardMap.from_dict({"num_shards": 3, "world": 2,
                                    "assign": [0, 1]}),
], ids=["fewer_shards_than_ranks", "no_shard", "no_rank", "assign_length"])
def test_shard_map_errors_are_the_references(make):
    for pkg in (xtb, xtt):
        with pytest.raises(ValueError):
            make(pkg)


# ------------------------------------------------------------------ the cuts
@pytest.mark.parametrize("world", [1, 2, 4])
def test_streaming_cuts_across_ranks_are_the_references(world):
    """Each rank sketches the pages its ShardMap gives it; the merged cuts
    are the reference's bits on every rank, at any world size (the page is
    the sketch's unit)."""
    X, y = parts_data(seed=51)
    w = (np.random.default_rng(52).random(len(y)) + 0.5).astype(np.float32)

    def cuts(pkg):
        def fn(r):
            idx = list(pkg.ShardMap.create(PARTS_PAGES, world).shards_of(r))
            d = _ext(pkg, pages(pkg, X, y, idx, PARTS_PAGE_ROWS, weight=w),
                     max_bin=PARTS_MAX_BIN, **_dev(pkg))
            return [np.asarray(getattr(d._cuts, f)).tobytes()
                    for f in ("cut_ptrs", "cut_values", "min_vals")]

        return ranks(pkg, f"cuts-{world}-{pkg.__name__}", fn, world=world)

    got, want = cuts(xtt), cuts(xtb)
    assert all(g == want[0] for g in got + want)


def test_a_rank_without_batches_raises_valueerror():
    """As the reference's: the column count comes with the first batch, so
    a rank whose iterator yields none cannot join the sketch."""
    X, y = parts_data()
    for pkg in (xtt, xtb):
        def fn(r):
            idx = [0, 1] if r == 0 else []
            return _ext(pkg, pages(pkg, X, y, idx, PARTS_PAGE_ROWS),
                        max_bin=PARTS_MAX_BIN, **_dev(pkg))

        with pytest.raises(ValueError, match="no batches"):
            ranks(pkg, f"empty-{pkg.__name__}", fn)


def test_pages_with_a_ref_join_no_collective():
    """A matrix built on a ref's cuts sketches nothing: rank 0 alone builds
    one (a validation set) and no rank waits for it."""
    X, y = parts_data()

    def fn(r):
        d = xtt.ExtMemQuantileDMatrix(
            pages(xtt, X, y, [r, r + 2], PARTS_PAGE_ROWS),
            max_bin=PARTS_MAX_BIN, device="cpu", compress=False)
        if r == 0:
            v = xtt.ExtMemQuantileDMatrix(
                pages(xtt, X, y, [3], PARTS_PAGE_ROWS), ref=d,
                max_bin=PARTS_MAX_BIN, device="cpu", compress=False)
            assert v._cuts is d._cuts
        return d._cuts.cut_values.tobytes()

    got = ranks(xtt, "ref-no-collective", fn)
    assert got[0] == got[1]


# ------------------------------------------------------------ out of core
DET = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
       "max_bin": 16, "deterministic_histogram": 1}
F32 = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.3,
       "max_bin": 16}


def _world2_pages(seed=31, n_pages=4, page_rows=1024, F=6):
    """The reference test's data (tests/test_extmem.py:551)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_pages * page_rows, F)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    return X, y


def _page_ranks(pkg, group, params, X, y, idx_of, ref=None, rounds=3,
                **train_kw):
    """Each rank trains on its pages ``idx_of(rank)``: (JSON, booster) a
    rank."""
    def fn(r):
        kw = {} if ref is None else {"ref": ref[pkg]}
        d = _ext(pkg, pages(pkg, X, y, idx_of(r), 1024), max_bin=16,
                 **_dev(pkg), **kw)
        bst = pkg.train(params, d, rounds, verbose_eval=False, **_dev(pkg),
                        **train_kw)
        return _js(bst), bst

    return ranks(pkg, f"{group}-{pkg.__name__}", fn)


@pytest.mark.parametrize("cuts", ["in-memory ref", "merged over ranks"])
def test_deterministic_world2_pages_are_the_references_bytes(cuts):
    """4 pages x 1024 x 6, max_bin 16, depth 3, 3 rounds, two pages a
    rank: the model bytes of the reference's two ranks, of the port's one
    process in memory on the same cuts (``ref``) or on all four pages in
    one matrix (cuts merged over the ranks)."""
    X, y = _world2_pages()
    ref = None
    if cuts == "in-memory ref":
        ref = {xtt: xtt.QuantileDMatrix(X, label=y, max_bin=16,
                                        device="cpu"),
               xtb: xtb.QuantileDMatrix(X, label=y, max_bin=16)}
        single = xtt.train(DET, ref[xtt], 3, verbose_eval=False,
                           device="cpu")
    else:
        single = xtt.train(DET, _ext(xtt, pages(xtt, X, y, [0, 1, 2, 3],
                                                1024), max_bin=16),
                           3, verbose_eval=False, device="cpu")

    def idx_of(r):
        return [2 * r, 2 * r + 1]

    got = _page_ranks(xtt, f"det-{cuts}", DET, X, y, idx_of, ref)
    want = _page_ranks(xtb, f"det-{cuts}", DET, X, y, idx_of, ref)
    assert got[0][0] == got[1][0]
    assert got[0][0] == want[0][0]
    assert got[0][0] == _js(single)


def test_sparse_pages_world2_are_the_references_bytes():
    """SparsePageDMatrix across ranks: its replayed raw pages merge their
    sketch over the ranks and train as binned pages do; the reference's
    two-rank bytes on both ranks, and raw-page predictions equal to the
    reference's."""
    X, y = parts_data(seed=55)

    def run(pkg):
        def fn(r):
            kw = {"device": "cpu", "compress": False} if pkg is xtt else {}
            d = pkg.SparsePageDMatrix(pages(pkg, X, y, [r, r + 2], 1024),
                                      max_bin=16, **kw)
            bst = pkg.train(DET, d, 3, verbose_eval=False, **_dev(pkg))
            return _js(bst), bst.predict(d)

        return ranks(pkg, f"sparse-pages-{pkg.__name__}", fn)

    got, want = run(xtt), run(xtb)
    assert got[0][0] == got[1][0] == want[0][0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])


def _config(pkg, X, y, evals=False):
    def data_fn(smap, rank, world):
        it = pages(pkg, X, y, list(smap.shards_of(rank)), 1024)
        if not evals:
            return it
        dv = pkg.DMatrix(X[:500], label=y[:500], **_dev(pkg))
        return it, [(dv, "hold")]

    kw = {"compress": False} if pkg is xtt else {}
    return pkg.ExtMemConfig(data_fn, num_shards=4, max_bin=16, **kw)


def test_extmem_config_world1_is_world2_and_the_references():
    """``train(params, ExtMemConfig(...))``, as reference
    tests/test_extmem.py:580: world 1 and world 2 write the same bytes, the
    reference's."""
    rng = np.random.default_rng(37)
    X = rng.normal(size=(4 * 1024, 5)).astype(np.float32)
    y = (X[:, 0] - 0.3 * X[:, 2] > 0).astype(np.float32)

    def run(pkg, world):
        def fn(r):
            return _js(pkg.train(DET, _config(pkg, X, y), 3,
                                 verbose_eval=False, **_dev(pkg)))

        return ranks(pkg, f"cfg{world}-{pkg.__name__}", fn, world=world)

    got1, got2 = run(xtt, 1), run(xtt, 2)
    want1, want2 = run(xtb, 1), run(xtb, 2)
    assert got1[0] == got2[0] == got2[1] == want1[0] == want2[0]


def test_extmem_config_evals_apply_where_train_gives_none():
    """The config's evals are logged where ``evals`` is empty: the global
    metrics of the reference's ranks, on every rank."""
    X, y = _world2_pages(seed=38, F=5)

    def run(pkg):
        def fn(r):
            hist = {}
            pkg.train(dict(DET, eval_metric=["logloss", "auc"]),
                      _config(pkg, X, y, evals=True), 2,
                      evals_result=hist, verbose_eval=False, **_dev(pkg))
            return hist

        return ranks(pkg, f"cfg-evals-{pkg.__name__}", fn)

    got, want = run(xtt), run(xtb)
    assert set(got[0]) == {"hold"}
    assert got[0] == got[1] == want[0]


def test_f32_world2_pages_match_the_reference():
    """f32 out of core at two ranks: the ranks' bytes equal, the
    reference's trees, predictions within 1e-4."""
    X, y = parts_data(seed=31)

    def idx_of(r):
        return [r, r + 2]

    got = _page_ranks(xtt, "f32", F32, X, y, idx_of)
    want = _page_ranks(xtb, "f32", F32, X, y, idx_of)
    assert got[0][0] == got[1][0]
    g, w = got[0][1], want[0][1]
    assert len(g.trees) == len(w.trees)
    for a, b in zip(g.trees, w.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
        np.testing.assert_array_equal(a.left_children, b.left_children)
    np.testing.assert_allclose(g.predict(xtt.DMatrix(X, device="cpu")),
                               w.predict(xtb.DMatrix(X)), atol=1e-4)


def _mean_margin(margin, dmat):
    return "mean-margin", float(np.mean(margin))


@pytest.mark.parametrize("extra", [
    {"eval_metric": ["logloss", "auc", "error"]},
    {"objective": "reg:absoluteerror", "eval_metric": ["mae", "rmse"]},
], ids=["metrics", "absoluteerror"])
def test_pages_metrics_and_base_score_are_the_references(extra):
    """On pages across ranks the base score comes from every rank's
    labels, the metrics are global and a custom metric is the ranks'
    mean: the reference's models and histories, on every rank (an
    adaptive objective keeps the grower's leaves on pages, as the
    reference's does)."""
    X, y = parts_data(seed=54)
    if extra.get("objective") == "reg:absoluteerror":
        y = (np.nan_to_num(X[:, 0]) * 3.0 + np.nan_to_num(X[:, 1])).astype(
            np.float32)
    params = dict(DET, **extra)

    def run(pkg):
        def fn(r):
            d = _ext(pkg, pages(pkg, X, y, [r, r + 2], 1024), max_bin=16,
                     **_dev(pkg))
            hist = {}
            bst = pkg.train(params, d, 3, evals=[(d, "train")],
                            evals_result=hist, verbose_eval=False,
                            custom_metric=_mean_margin, **_dev(pkg))
            return _js(bst), hist

        return ranks(pkg, f"pages-metrics-{len(extra)}-{pkg.__name__}", fn)

    got, want = run(xtt), run(xtb)
    assert got[0] == got[1] == want[0] == want[1]
    assert "mean-margin" in got[0][1]["train"]


def test_page_skip_with_a_rank_all_sampled_out_finishes(monkeypatch):
    """Gradient-based sampling where rank 1's rows all carry zero weight:
    its pages sample out, yet one stays streamed and the rank joins every
    level's exchange.  The model is the reference's, every page streamed
    or not."""
    X, y = parts_data(seed=53)
    w = np.ones(len(y), np.float32)
    w[2 * 1024:] = 0.0
    params = dict(DET, max_depth=4, subsample=0.5,
                  sampling_method="gradient_based")
    skipped = {}
    orig = port_stream.StreamingHistTreeGrower._route_skipped

    def spy(self, dmat, pos, offs, skip, *a):
        skipped[id(dmat)] = list(skip)
        return orig(self, dmat, pos, offs, skip, *a)

    monkeypatch.setattr(port_stream.StreamingHistTreeGrower,
                        "_route_skipped", spy)

    def run(pkg, p):
        def fn(r):
            d = _ext(pkg, pages(pkg, X, y, [2 * r, 2 * r + 1], 1024,
                                weight=w), max_bin=16, **_dev(pkg))
            out = _js(pkg.train(p, d, 3, verbose_eval=False, **_dev(pkg)))
            return out, skipped.get(id(d))

        return ranks(pkg, f"skip-{len(p)}-{pkg.__name__}", fn)

    got = run(xtt, params)
    assert got[0][1] is None and got[1][1] == [1]
    want = run(xtb, params)
    every = run(xtt, dict(params, _extmem_page_skip=0))
    assert got[0][0] == got[1][0] == want[0][0] == every[0][0]


def test_train_distributed_out_of_core_parts_are_the_thread_ranks():
    """Two gloo worker processes, each building its ExtMemQuantileDMatrix
    in a callable part once the collective is up: the deterministic model
    of two in-memory ranks on the same parts."""
    params = dict(DET, device="cpu", max_bin=PARTS_MAX_BIN)
    out = xtt.train_distributed(
        params, [functools.partial(extmem_part, r) for r in range(2)],
        num_boost_round=3, timeout=300)

    def fn(r):
        return _js(xtt.train(params, extmem_part(r), 3, verbose_eval=False))

    mem = ranks(xtt, "gloo-extmem", fn)
    assert _js(out["booster"]) == mem[0] == mem[1]


# --------------------------------------------------------------------- exact
EXACT = {"objective": "reg:squarederror", "tree_method": "exact",
         "max_depth": 4, "eta": 0.5}

_EXACT_CASES = {
    "squarederror": {},
    "logistic_sampled": {"objective": "binary:logistic", "subsample": 0.7,
                         "colsample_bynode": 0.8, "seed": 3},
    "absoluteerror": {"objective": "reg:absoluteerror"},
    "forest": {"num_parallel_tree": 2, "colsample_bytree": 0.8, "seed": 5},
}


def _exact_data():
    """The reference test's rows (tests/test_exact.py:218)."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(900, 5)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 0.2 * rng.normal(size=900)).astype(np.float32)
    return X, y


def _row_ranks(pkg, group, params, X, y, rounds=3, cut=450, **train_kw):
    def fn(r):
        lo, hi = (0, cut) if r == 0 else (cut, len(X))
        yy = y[lo:hi]
        if params.get("objective") == "binary:logistic":
            yy = (yy > 0).astype(np.float32)
        d = pkg.DMatrix(X[lo:hi], label=yy, **_dev(pkg))
        return _js(pkg.train(params, d, rounds, verbose_eval=False,
                             **_dev(pkg), **train_kw))

    return ranks(pkg, f"{group}-{pkg.__name__}", fn)


@pytest.mark.parametrize("case", list(_EXACT_CASES))
def test_exact_two_ranks_are_the_references_bytes(case):
    """Every rank enumerates every rank's rows and keeps rank 0's tree:
    the reference's two-rank bytes, on both ranks; unsampled, one process
    on the union too."""
    X, y = _exact_data()
    params = dict(EXACT, **_EXACT_CASES[case])
    got = _row_ranks(xtt, f"exact-{case}", params, X, y)
    want = _row_ranks(xtb, f"exact-{case}", params, X, y)
    assert got[0] == got[1] == want[0]
    if case == "squarederror":
        single = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), 3,
                           verbose_eval=False, device="cpu")
        assert got[0] == _js(single)


# -------------------------------------------------------------------- update
_UPDATERS = ["refresh", "refresh,prune", "refresh,prune,sync", "prune,sync"]


@pytest.mark.parametrize("updater", _UPDATERS)
def test_update_two_ranks_are_the_references_bytes(updater):
    """process_type="update" over a 5-round model at two ranks of uneven
    rows: each node's (G, H) summed over the ranks, prune local, sync rank
    0's model: the reference's two-rank bytes on both ranks."""
    X, y = _exact_data()
    base = {"objective": "reg:squarederror", "max_depth": 4, "eta": 0.5,
            "max_bin": 32, "deterministic_histogram": 1}
    models = {xtt: xtt.train(base, xtt.DMatrix(X, label=y, device="cpu"), 5,
                             verbose_eval=False, device="cpu"),
              xtb: xtb.train(base, xtb.DMatrix(X, label=y), 5,
                             verbose_eval=False)}
    assert _js(models[xtt]) == _js(models[xtb])
    params = dict(base, process_type="update", updater=updater, gamma=0.5)

    def run(pkg):
        return _row_ranks(pkg, f"update-{updater}", params, X, y, rounds=5,
                          cut=520, xgb_model=models[pkg])

    got, want = run(xtt), run(xtb)
    assert got[0] == got[1] == want[0]
