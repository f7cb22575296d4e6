"""Port parity for the out-of-core input path's data side: the streaming
sketch, the page geometry, the compressed and spilled pages, the
scheduler, SparsePageDMatrix and the refusals, held against xgboost_tpu on
the same numpy batches.

Tolerances: the cuts of StreamingSketch and merge_quantile_grids are the
reference's bits (any push order); page bins, offsets, valid rows and the
padded labels, weights and base margins are equal; predictions on the
pages equal the raw predictions bit for bit; each refused configuration
raises the reference's error type."""
import os
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu.data import quantile as rq
from xgboost_tpu_torch.data import extmem as tx
from xgboost_tpu_torch.data import quantile as tq


def make_iter(mod, batches):
    """A DataIter of ``mod`` over a list of input_data keyword dicts."""

    class It(mod.DataIter):
        def __init__(self):
            super().__init__()
            self.i = 0

        def reset(self):
            self.i = 0

        def next(self, input_data):
            if self.i >= len(batches):
                return 0
            input_data(**batches[self.i])
            self.i += 1
            return 1

    return It()


def make_batches(R=2500, F=6, splits=(0, 900, 2000, 2500), seed=0,
                 n_cat=0, weight=False, margin=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(R, F)).astype(np.float32)
    X[rng.random((R, F)) < 0.05] = np.nan
    if n_cat:
        X[:, F - n_cat:] = rng.integers(0, 7, size=(R, n_cat))
        X[rng.random(R) < 0.05, F - 1] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])
         + 0.3 * (np.nan_to_num(X[:, F - 1]) % 3 == 1)
         + 0.3 * rng.normal(size=R) > 0).astype(np.float32)
    w = (rng.random(R) + 0.5).astype(np.float32)
    bm = (0.1 * rng.normal(size=R)).astype(np.float32)
    out = []
    for a, b in zip(splits, splits[1:]):
        batch = {"data": X[a:b], "label": y[a:b]}
        if weight:
            batch["weight"] = w[a:b]
        if margin:
            batch["base_margin"] = bm[a:b]
        if n_cat:
            batch["feature_types"] = ["q"] * (F - n_cat) + ["c"] * n_cat
        out.append(batch)
    return X, y, out


def both(batches, **kw):
    """The reference's and the port's ExtMemQuantileDMatrix."""
    ref = xtb.ExtMemQuantileDMatrix(make_iter(xtb, batches), **kw)
    got = xtt.ExtMemQuantileDMatrix(make_iter(xtt, batches), device="cpu",
                                    **kw)
    return ref, got


def cuts_equal(a, b):
    return (np.array_equal(a.cut_ptrs, b.cut_ptrs)
            and a.cut_values.tobytes() == b.cut_values.tobytes()
            and a.min_vals.tobytes() == b.min_vals.tobytes())


def _sketch_pages(kind, seed=11):
    rng = np.random.default_rng(seed)
    F = 5
    pages, weights = [], []
    for _ in range(6):
        R = int(rng.integers(40, 300))
        X = rng.normal(size=(R, F)).astype(np.float32)
        X[rng.random((R, F)) < 0.1] = np.nan
        if kind in ("categorical", "csr"):
            X[:, 1] = rng.integers(0, 9, size=R)
        if kind == "csr":
            X[rng.random((R, F)) < 0.2] = 0.0
        pages.append(X)
        weights.append((rng.random(R) + 0.1).astype(np.float32))
    cat = (np.array([False, True, False, False, False])
           if kind in ("categorical", "csr") else None)
    return pages, weights, cat


@pytest.mark.parametrize("kind", ["numeric", "weighted", "csr",
                                  "categorical"])
def test_streaming_sketch_is_the_references_in_any_order(kind):
    pages, weights, cat = _sketch_pages(kind)
    weighted = kind in ("weighted", "csr")

    def run(mod, order):
        sk = mod.StreamingSketch(5, 16, cat_mask=cat)
        for i in order:
            w = weights[i] if weighted else None
            if kind == "csr":
                c = sp.csr_matrix(np.nan_to_num(pages[i], nan=0.0))
                sk.push_csr(c.indptr, c.indices, c.data, weights=w)
            else:
                sk.push(pages[i], weights=w)
        return sk.finalize()

    order = list(range(len(pages)))
    want = run(rq, order)
    for perm in (order, order[::-1], [3, 0, 5, 1, 4, 2]):
        assert cuts_equal(run(tq, perm), want)


def test_single_page_sketch_is_the_incore_sketch():
    X = _sketch_pages("numeric")[0][0]
    sk = tq.StreamingSketch(5, 32)
    sk.push(X)
    assert cuts_equal(sk.finalize(), tq.sketch_dense(X, 32))


def test_merge_quantile_grids_is_the_references():
    rng = np.random.default_rng(3)
    W, F, Q = 4, 3, 15
    grids = np.sort(rng.normal(size=(W, F, Q)).astype(np.float32), axis=2)
    grids[1, 2] = np.inf  # a worker without values of feature 2
    nvalid = rng.integers(10, 500, size=(W, F)).astype(np.int64)
    nvalid[1, 2] = 0
    vmax = grids.max(axis=2, where=np.isfinite(grids), initial=-1) + 1
    vmin = grids.min(axis=2, where=np.isfinite(grids), initial=1) - 1
    masses = rng.random((W, F)) * 100
    for m in (None, masses):
        a = tq.merge_quantile_grids(grids, nvalid, vmax, vmin, 16, masses=m)
        b = rq.merge_quantile_grids(grids, nvalid, vmax, vmin, 16, masses=m)
        assert cuts_equal(a, b)


@pytest.mark.parametrize("n_cat", [0, 2])
def test_pages_and_geometry_are_the_references(n_cat):
    _, _, batches = make_batches(n_cat=n_cat, weight=True, margin=True)
    ref, got = both(batches, max_bin=32, compress=False)
    assert cuts_equal(got._cuts, ref._cuts)
    assert got.page_offsets() == ref.page_offsets()
    assert got.n_padded_total == ref.n_padded_total
    assert got.num_row() == ref.num_row() and got.num_col() == 6
    np.testing.assert_array_equal(got.valid_mask(), ref.valid_mask())
    for a, b in zip(got._pages, ref._pages):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("padded_labels", "padded_weights", "padded_base_margin"):
        np.testing.assert_array_equal(getattr(got, name)(),
                                      getattr(ref, name)())
    assert got.info.feature_types == ref.info.feature_types
    assert isinstance(got.info, xtt.MetaInfo)


def test_ref_cuts_are_taken_from_an_incore_matrix():
    X, y, batches = make_batches()
    qd = xtt.QuantileDMatrix(X, label=y, max_bin=16, device="cpu")
    ext = xtt.ExtMemQuantileDMatrix(make_iter(xtt, batches), max_bin=16,
                                    ref=qd, device="cpu")
    assert ext._cuts is qd._ellpack.cuts
    # and an in-core matrix binned on another's cuts
    qv = xtt.QuantileDMatrix(X[:100], max_bin=16, ref=qd, device="cpu")
    assert qv._ellpack.cuts is qd._ellpack.cuts
    np.testing.assert_array_equal(qv._ellpack.bins[:100],
                                  qd._ellpack.bins[:100])


@pytest.mark.parametrize("on_host", [True, False])
def test_compressed_and_spilled_pages_train_the_same(on_host):
    pytest.importorskip("zstandard")
    _, _, batches = make_batches()
    params = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 32,
              "deterministic_histogram": 1}
    plain = xtt.ExtMemQuantileDMatrix(make_iter(xtt, batches), max_bin=32,
                                      compress=False, device="cpu")
    comp = xtt.ExtMemQuantileDMatrix(make_iter(xtt, batches), max_bin=32,
                                     compress=True, on_host=on_host,
                                     device="cpu")
    assert all(isinstance(p, tx.CompressedPage) for p in comp._pages)
    assert sum(p.nbytes_compressed for p in comp._pages) < \
        0.8 * plain.page_bytes()
    a = xtt.train(params, plain, 3, verbose_eval=False, device="cpu")
    b = xtt.train(params, comp, 3, verbose_eval=False, device="cpu")
    assert a.get_dump() == b.get_dump()
    np.testing.assert_array_equal(a.predict(plain), b.predict(comp))


def test_uncompressed_spill_is_disk_pages(monkeypatch):
    _, _, batches = make_batches()
    d = xtt.ExtMemQuantileDMatrix(make_iter(xtt, batches), max_bin=32,
                                  compress=False, on_host=False,
                                  device="cpu")
    assert all(isinstance(p, tx.DiskPage) for p in d._pages)
    ref = xtb.ExtMemQuantileDMatrix(make_iter(xtb, batches), max_bin=32,
                                    compress=False)
    for a, b in zip(d._pages, ref._pages):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _flip_file(path, offset):
    with open(path, "r+b") as fh:
        fh.seek(offset)
        b = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([b[0] ^ 0x5A]))


def test_corrupted_pages_raise(tmp_path, monkeypatch):
    pytest.importorskip("zstandard")
    monkeypatch.setenv("XTB_EXTMEM_HOST_CACHE_MB", "0")  # every touch decodes
    arr = np.arange(4096, dtype=np.uint8).reshape(1024, 4)
    # in memory: a damaged blob (bytes flipped inside the zstd frame)
    page = tx.CompressedPage(arr)
    np.testing.assert_array_equal(np.asarray(page), arr)
    blob = bytearray(page._blob)
    for i in range(len(blob) // 2, len(blob) // 2 + 4):
        blob[i] ^= 0xFF
    page._blob = bytes(blob)
    with pytest.raises(tx.PageCorruptError):
        np.asarray(page)
    # spilled compressed and spilled plain pages: bytes flipped in the file
    spilled = tx.CompressedPage(arr, str(tmp_path / "p.zst"))
    _flip_file(str(tmp_path / "p.zst"), os.path.getsize(tmp_path / "p.zst")
               // 2)
    with pytest.raises(tx.PageCorruptError):
        np.asarray(spilled)
    disk = tx.DiskPage(arr, str(tmp_path / "p.npy"))
    np.testing.assert_array_equal(np.asarray(disk), arr)
    _flip_file(str(tmp_path / "p.npy"), os.path.getsize(tmp_path / "p.npy")
               - 10)
    with pytest.raises(tx.PageCorruptError):
        np.asarray(disk)


def test_page_cache_counts_hits(monkeypatch):
    pytest.importorskip("zstandard")
    monkeypatch.setenv("XTB_EXTMEM_HOST_CACHE_MB", "64")
    page = tx.CompressedPage(np.ones((2048, 3), np.uint8))
    tx.reset_counters()
    for _ in range(3):
        np.asarray(page)
    c = tx.counters()
    assert c["xtb_extmem_cache_misses_total"] == 1
    assert c["xtb_extmem_cache_hits_total"] == 2


@pytest.mark.parametrize("lookahead", [0, 2])
def test_cpu_scheduler_yields_the_pages_in_order(lookahead):
    pytest.importorskip("zstandard")
    rng = np.random.default_rng(5)
    arrs = [rng.integers(0, 30, size=(1024, 4)).astype(np.uint8)
            for _ in range(5)]
    pages = [torch.from_numpy(a) if i % 2 else tx.CompressedPage(a)
             for i, a in enumerate(arrs)]
    events = []
    tx.reset_counters()
    sched = tx.PageScheduler(pages, torch.device("cpu"),
                             lookahead=lookahead, events=events)
    for j, a in enumerate(arrs):
        np.testing.assert_array_equal(sched.get(j).numpy(), a)
        sched.release(j)
    sched.close()
    assert tx.counters()["xtb_extmem_pages_loaded_total"] == 5
    assert tx.counters()["xtb_extmem_page_bytes_total"] == 5 * 4096
    if lookahead == 0:
        assert events == [("load_sync", j) for j in range(5)]
    else:  # each wait comes after the window has been submitted
        assert events[:4] == [("submit", 0), ("submit", 1), ("submit", 2),
                              ("wait", 0)]
        assert [e for e in events if e[0] == "wait"] == \
            [("wait", j) for j in range(5)]


def test_predict_on_pages_equals_raw_predict():
    X, y, batches = make_batches(n_cat=2)
    ref, d = both(batches, max_bin=32, compress=False)
    params = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32}
    bst = xtt.train(params, d, 4, verbose_eval=False, device="cpu")
    raw = xtt.DMatrix(X, feature_types=d.feature_types, device="cpu")
    np.testing.assert_array_equal(bst.predict(d), bst.predict(raw))
    np.testing.assert_array_equal(
        bst.predict(d, output_margin=True, iteration_range=(1, 3)),
        bst.predict(raw, output_margin=True, iteration_range=(1, 3)))
    # a model loaded without split bins maps its thresholds onto the cuts
    again = xtt.Booster(model_file=bst.save_raw("json"), device="cpu")
    np.testing.assert_array_equal(again.predict(d), bst.predict(d))


def test_sparse_page_dmatrix_raw_predict_and_training():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(1200, 5)).astype(np.float32)
    X[rng.random(X.shape) < 0.15] = np.nan
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) > 0).astype(
        np.float32)
    batches = [{"data": X[i * 400:(i + 1) * 400],
                "label": y[i * 400:(i + 1) * 400]} for i in range(3)]
    params = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 32,
              "deterministic_histogram": 1}
    d = xtt.SparsePageDMatrix(make_iter(xtt, batches), max_bin=32,
                              device="cpu")
    ref = xtb.SparsePageDMatrix(make_iter(xtb, batches), max_bin=32)
    assert d.num_row() == 1200 and d.num_col() == 5
    assert cuts_equal(d._cuts, ref._cuts)
    bst = xtt.train(params, d, 3, verbose_eval=False, device="cpu")
    want = xtb.train(params, ref, 3, verbose_eval=False)
    assert bst.save_raw("json") == want.save_raw("json")
    np.testing.assert_array_equal(
        bst.predict(d), bst.predict(xtt.DMatrix(X, device="cpu")))
    # a model trained on other cuts predicts on the raw pages exactly
    other = xtt.train({"objective": "binary:logistic", "max_depth": 3,
                       "max_bin": 17}, xtt.DMatrix(X, label=y, device="cpu"),
                      2, verbose_eval=False, device="cpu")
    np.testing.assert_array_equal(
        other.predict(d), other.predict(xtt.DMatrix(X, device="cpu")))


def test_sparse_page_dmatrix_scipy_batches_and_sentinel():
    rng = np.random.default_rng(7)
    dense = rng.normal(size=(600, 4)).astype(np.float32)
    dense[rng.random(dense.shape) < 0.3] = 0.0
    y = (dense[:, 0] > 0).astype(np.float32)
    batches = [{"data": sp.csr_matrix(dense[:300]), "label": y[:300]},
               {"data": sp.csr_matrix(dense[300:]), "label": y[300:]}]
    params = {"objective": "binary:logistic", "max_depth": 2, "max_bin": 16}
    d = xtt.SparsePageDMatrix(make_iter(xtt, batches), max_bin=16,
                              device="cpu")
    bst = xtt.train(params, d, 2, verbose_eval=False, device="cpu")
    Xnan = np.where(dense == 0.0, np.nan, dense)  # absent entries: missing
    np.testing.assert_array_equal(
        bst.predict(d), bst.predict(xtt.DMatrix(Xnan, device="cpu")))
    dense2 = np.abs(rng.normal(size=(200, 3)).astype(np.float32))
    dense2[rng.random(dense2.shape) < 0.2] = -1.0
    b2 = [{"data": dense2, "label": (dense2[:, 0] > 0.5).astype(np.float32)}]
    d2 = xtt.SparsePageDMatrix(make_iter(xtt, b2), missing=-1.0, max_bin=16,
                               device="cpu")
    m2 = xtt.train(params, d2, 2, verbose_eval=False, device="cpu")
    X2 = np.where(dense2 == -1.0, np.nan, dense2)
    np.testing.assert_array_equal(
        m2.predict(d2), m2.predict(xtt.DMatrix(X2, device="cpu")))


def test_empty_iterator_raises():
    for mod, kw in ((xtb, {}), (xtt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="no batches"):
            mod.ExtMemQuantileDMatrix(make_iter(mod, []), max_bin=16, **kw)


def test_a_dataiter_is_required():
    with pytest.raises(TypeError):
        xtt.ExtMemQuantileDMatrix(np.zeros((4, 2)), device="cpu")


_REFUSED = [
    ("exact", {"tree_method": "exact"}, NotImplementedError, {}),
    ("dart", {"booster": "dart"}, ValueError, {}),
    ("gblinear", {"booster": "gblinear"}, NotImplementedError, {}),
]


@pytest.mark.parametrize("name,params,err,_", _REFUSED,
                         ids=[c[0] for c in _REFUSED])
def test_refused_training_raises_the_references_error(name, params, err, _):
    _, _, batches = make_batches(R=1200, splits=(0, 600, 1200))
    ref, got = both(batches, max_bin=16, compress=False)
    p = dict(params, objective="binary:logistic", max_depth=3, max_bin=16)
    with pytest.raises(err):
        xtb.train(p, ref, 1, verbose_eval=False)
    with pytest.raises(err):
        xtt.train(p, got, 1, verbose_eval=False, device="cpu")


def test_refused_predictions_and_updates_raise_the_references_error():
    _, _, batches = make_batches(R=1200, splits=(0, 600, 1200))
    ref, got = both(batches, max_bin=16, compress=False)
    p = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16}
    br = xtb.train(p, ref, 1, verbose_eval=False)
    bt = xtt.train(p, got, 1, verbose_eval=False, device="cpu")
    for kw in ("pred_leaf", "pred_contribs", "pred_interactions"):
        with pytest.raises(ValueError):
            br.predict(ref, **{kw: True})
        with pytest.raises(ValueError):
            bt.predict(got, **{kw: True})
    upd = dict(p, process_type="update", updater="refresh")
    with pytest.raises(NotImplementedError):
        xtb.train(upd, ref, 1, xgb_model=br, verbose_eval=False)
    with pytest.raises(NotImplementedError):
        xtt.train(upd, got, 1, xgb_model=bt, verbose_eval=False,
                  device="cpu")


def test_row_budget_of_deterministic_histogram(monkeypatch):
    """More than MAX_ROWS (2**24) padded rows under deterministic_histogram
    raise ValueError, as in the reference; the budget is lowered here to
    the test's 2048 padded rows."""
    from xgboost_tpu.ops import quantise as rquant
    from xgboost_tpu_torch.ops import quantise as tquant

    _, _, batches = make_batches(R=1500, splits=(0, 900, 1500))
    ref, got = both(batches, max_bin=16, compress=False)
    monkeypatch.setattr(rquant, "MAX_ROWS", 1024)
    monkeypatch.setattr(tquant, "MAX_ROWS", 1024)
    p = {"objective": "binary:logistic", "max_depth": 2, "max_bin": 16,
         "deterministic_histogram": 1}
    with pytest.raises(ValueError, match="deterministic_histogram"):
        xtb.train(p, ref, 1, verbose_eval=False)
    with pytest.raises(ValueError, match="deterministic_histogram"):
        xtt.train(p, got, 1, verbose_eval=False, device="cpu")


def test_multi_column_labels_raise_valueerror():
    """The reference breaks on (R, 2) labels on pages with a ValueError
    (its padded labels); the port refuses them with one, at ingestion."""
    X, _, _ = make_batches(R=1024, splits=(0, 1024))
    Y = np.stack([X[:, 0], X[:, 1]], axis=1)
    batches = [{"data": X, "label": Y}]
    p = {"objective": "reg:squarederror", "num_target": 2, "max_depth": 2}
    with pytest.raises(ValueError):
        xtb.train(p, xtb.ExtMemQuantileDMatrix(make_iter(xtb, batches),
                                               max_bin=16), 1,
                  verbose_eval=False)
    with pytest.raises(ValueError, match="one label a row"):
        xtt.ExtMemQuantileDMatrix(make_iter(xtt, batches), max_bin=16,
                                  device="cpu")


def test_port_only_refusals():
    """Pages carry no query groups; an ExtMemConfig in one process (no
    collective) trains the matrix its data_fn gives, over every shard."""
    _, y, batches = make_batches(R=1200, splits=(0, 600, 1200))
    d = xtt.ExtMemQuantileDMatrix(make_iter(xtt, batches), max_bin=16,
                                  compress=False, device="cpu")
    with pytest.raises(NotImplementedError, match="query groups"):
        xtt.train({"objective": "rank:ndcg"}, d, 1, verbose_eval=False,
                  device="cpu")
    shards = []

    def data_fn(smap, rank, world):
        shards.append((smap.shards_of(rank), rank, world))
        return make_iter(xtt, batches)

    p = {"max_depth": 3, "deterministic_histogram": 1}
    cfg = xtt.ExtMemConfig(data_fn, num_shards=2, max_bin=16,
                           compress=False)
    got = xtt.train(p, cfg, 2, verbose_eval=False, device="cpu")
    want = xtt.train(p, d, 2, verbose_eval=False, device="cpu")
    assert shards == [((0, 1), 0, 1)]
    assert got.save_raw_dict() == want.save_raw_dict()
    with pytest.raises(TypeError, match="DataIter"):
        xtt.train({}, xtt.ExtMemConfig(lambda *a: None), 1,
                  verbose_eval=False, device="cpu")
    sk = tq.StreamingSketch(2, 8)
    sk.push(np.zeros((4, 2), np.float32))
    # the distributed finalize is ported: in one process it is the local
    # merge (tests/test_torch_distributed.py holds it across ranks)
    one = sk.finalize(distributed=True)
    assert np.array_equal(one.padded(), sk.finalize().padded())
    with pytest.raises(NotImplementedError):
        d.host_dense()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="no pages"):
            tq.StreamingSketch(2, 8).finalize()
