"""Port parity for out-of-core training: StreamingHistTreeGrower over
ExtMemQuantileDMatrix pages, held against xgboost_tpu's external-memory
training on the same numpy batches, and against the port's in-core
training on the same cuts.

Tolerances:
- deterministic_histogram: the model JSON is byte-identical to the
  reference's extmem model (several pages; depthwise, lossguide with
  max_leaves, categorical, column and row sampling, constraints, weights
  and base margins, multiclass, gradient-based page skip), and to the
  port's in-core model on the same cuts (numeric, no row sampling: the
  pages pad each page, so the threefry draws over padded rows differ).
- f32 histogram: the same tree structures, and margins as close to the
  reference's as the port's in-core f32 path comes on the same data: the
  two packages sum f32 gradients in other orders (the reference's native
  row pass and Eigen's dot for the root), which moves small leaves by
  ~1e-4 in both paths."""
import json

import numpy as np
import pytest

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu_torch.data import extmem as tx

from test_torch_extmem import both, make_batches, make_iter

DET = {"objective": "binary:logistic", "max_depth": 4, "max_bin": 32,
       "eta": 0.3, "deterministic_histogram": 1}


def _json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _ref_json(bst) -> str:
    return json.dumps(json.loads(bst.save_raw("json").decode()))


def _train_both(params, batches, rounds=4, **kw):
    ref, got = both(batches, max_bin=params.get("max_bin", 32),
                    compress=False, **kw)
    br = xtb.train(params, ref, rounds, verbose_eval=False)
    bt = xtt.train(params, got, rounds, verbose_eval=False, device="cpu")
    return ref, got, br, bt


_CASES = {
    "depthwise": ({}, {}),
    "lossguide_max_leaves": ({"grow_policy": "lossguide", "max_leaves": 6,
                              "max_depth": 5}, {}),
    "categorical": ({"max_cat_to_onehot": 4}, {"n_cat": 2}),
    "categorical_onehot": ({"max_cat_to_onehot": 16}, {"n_cat": 2}),
    "sampling": ({"subsample": 0.7, "colsample_bylevel": 0.7,
                  "colsample_bynode": 0.8, "seed": 3}, {}),
    "constraints": ({"monotone_constraints": "(1,0,0,0,0,-1)",
                     "interaction_constraints": "[[0,1],[2,3,4]]",
                     "max_leaves": 9}, {}),
    "weights_base_margin": ({}, {"weight": True, "margin": True}),
    "squarederror": ({"objective": "reg:squarederror", "base_score": 0.25},
                     {}),
    "absoluteerror": ({"objective": "reg:absoluteerror", "base_score": 0.5},
                      {}),
    "approx": ({"tree_method": "approx"}, {}),
    "forest": ({"num_parallel_tree": 2, "subsample": 0.8, "seed": 1}, {}),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_deterministic_extmem_json_is_the_references(case):
    extra, data_kw = _CASES[case]
    _, _, batches = make_batches(**data_kw)
    _, _, br, bt = _train_both(dict(DET, **extra), batches)
    assert _json(bt) == _ref_json(br)


def test_deterministic_multiclass_json_is_the_references():
    X, _, batches = make_batches()
    lab = np.clip(np.abs(np.nan_to_num(X[:, 0])) * 2, 0, 2).astype(
        np.int32).astype(np.float32)
    for b, (a, e) in zip(batches, ((0, 900), (900, 2000), (2000, 2500))):
        b["label"] = lab[a:e]
    params = dict(DET, objective="multi:softprob", num_class=3, max_depth=3)
    _, _, br, bt = _train_both(params, batches, rounds=3)
    assert _json(bt) == _ref_json(br)
    # the reference grows scalar trees on pages whatever multi_strategy
    vec = dict(params, multi_strategy="multi_output_tree")
    _, _, br, bt = _train_both(vec, batches, rounds=2)
    assert _json(bt) == _ref_json(br)
    assert all(t.leaf_vector is None for t in bt.trees)


def test_continuation_evals_and_custom_objective_on_pages():
    X, y, batches = make_batches()
    ref, got = both(batches, max_bin=32, compress=False)
    res_r, res_t = {}, {}
    br = xtb.train(DET, ref, 3, evals=[(ref, "t")], evals_result=res_r,
                   verbose_eval=False)
    bt = xtt.train(DET, got, 3, evals=[(got, "t")], evals_result=res_t,
                   verbose_eval=False, device="cpu")
    assert res_t == res_r
    # 2 + 1 rounds through xgb_model: the margin cache is rebuilt from the
    # pages, base + (tree 0 + tree 1), as the reference rebuilds it (which
    # adds in another order than the straight run's)
    first = xtt.train(DET, got, 2, verbose_eval=False, device="cpu")
    again = xtt.train(DET, got, 1, xgb_model=first.save_raw("ubj"),
                      verbose_eval=False, device="cpu")
    want = xtb.train(DET, ref, 1, verbose_eval=False,
                     xgb_model=xtb.train(DET, ref, 2, verbose_eval=False))
    assert _json(again) == _ref_json(want)

    def obj(preds, dmat):
        p = 1.0 / (1.0 + np.exp(-preds.astype(np.float64)))
        return p - y, p * (1.0 - p)

    co_r = xtb.train(DET, ref, 2, obj=obj, verbose_eval=False)
    co_t = xtt.train(DET, got, 2, obj=obj, verbose_eval=False, device="cpu")
    assert _json(co_t) == _ref_json(co_r)


def test_gradient_based_page_skip_matches_skip_off_and_reference():
    """Pages whose rows all sampled out stream once a tree, not once a
    level, and the model is the one that streamed them at every level."""
    n_pages, page_rows, F = 4, 1024, 5
    rng = np.random.default_rng(43)
    X = rng.normal(size=(n_pages * page_rows, F)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    batches = [{"data": X[i * page_rows:(i + 1) * page_rows],
                "label": y[i * page_rows:(i + 1) * page_rows]}
               for i in range(n_pages)]
    cut = 2 * page_rows

    def obj(preds, dmat):
        g = np.asarray(preds, np.float64) - y
        h = np.ones_like(g)
        g[cut:] = 0.0
        h[cut:] = 0.0
        return g, h

    params = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
              "max_bin": 16, "subsample": 0.9,
              "sampling_method": "gradient_based", "seed": 7,
              "deterministic_histogram": 1}
    ref, d = both(batches, max_bin=16, compress=False)

    def run(skip):
        tx.reset_counters()
        bst = xtt.train(dict(params, _extmem_page_skip=skip), d, 2,
                        verbose_eval=False, obj=obj, device="cpu")
        return bst, tx.counters()["xtb_extmem_pages_loaded_total"]

    b_skip, loads_skip = run("1")
    b_full, loads_full = run("0")
    assert loads_full == 2 * 4 * n_pages
    assert loads_skip == 2 * (4 * 2 + 2)
    assert _json(b_skip) == _json(b_full)
    want = xtb.train(params, ref, 2, verbose_eval=False, obj=obj)
    assert _json(b_skip) == _ref_json(want)
    np.testing.assert_array_equal(b_skip.predict(d), b_full.predict(d))


@pytest.mark.parametrize("extra", [{}, {"max_leaves": 7},
                                   {"colsample_bynode": 0.7, "seed": 2}])
def test_deterministic_extmem_is_the_incore_model_on_the_same_cuts(extra):
    X, y, batches = make_batches()
    params = dict(DET, **extra)
    qd = xtt.QuantileDMatrix(X, label=y, max_bin=32, device="cpu")
    ext = xtt.ExtMemQuantileDMatrix(make_iter(xtt, batches), max_bin=32,
                                    ref=qd, device="cpu", compress=False)
    a = xtt.train(params, qd, 4, verbose_eval=False, device="cpu")
    b = xtt.train(params, ext, 4, verbose_eval=False, device="cpu")
    assert _json(b) == _json(a)
    np.testing.assert_array_equal(b.predict(ext), a.predict(qd))


def test_prefetch_off_trains_the_same_model():
    _, _, batches = make_batches(splits=(0, 600, 1200, 1800, 2500))
    d = xtt.ExtMemQuantileDMatrix(make_iter(xtt, batches), max_bin=32,
                                  device="cpu")
    on = xtt.train(DET, d, 3, verbose_eval=False, device="cpu")
    off = xtt.train(dict(DET, _extmem_prefetch=0), d, 3, verbose_eval=False,
                    device="cpu")
    assert _json(on) == _json(off)


def test_f32_extmem_margins_are_as_close_as_incore():
    X, y, batches = make_batches()
    params = {k: v for k, v in DET.items() if k != "deterministic_histogram"}
    ref, got, br, bt = _train_both(params, batches, rounds=5)
    for a, b in zip(bt.trees, br.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
        np.testing.assert_array_equal(a.left_children, b.left_children)
    ext_err = np.abs(bt.predict(got, output_margin=True)
                     - br.predict(ref, output_margin=True)).max()
    # the same training in memory, each package on its own sketch of the
    # concatenated rows
    ir = xtb.train(params, xtb.DMatrix(X, label=y), 5, verbose_eval=False)
    it = xtt.train(params, xtt.DMatrix(X, label=y, device="cpu"), 5,
                   verbose_eval=False, device="cpu")
    in_err = np.abs(it.predict(xtt.DMatrix(X, device="cpu"),
                               output_margin=True)
                    - ir.predict(xtb.DMatrix(X), output_margin=True)).max()
    assert ext_err <= max(1.5 * in_err, 1e-5), (ext_err, in_err)
    assert ext_err < 1e-4
