"""Categorical data and splits of the port against the reference, on the
same numpy input made from a seed:

- cuts (identity cuts [1 .. n_cats] for categorical columns, the numeric
  columns sketched alone) and bins, bitwise, with the host grid and with
  the device sketch (the reference's forced device branch);
- ``evaluate_splits`` with a ``cat_mask``, bitwise in every output, in the
  partition and one-hot regimes, with ties in G/H, empty categories,
  feature masks, monotone constraints and max_delta_step; and under
  deterministic_histogram, where the reference's compiled level fuses the
  dequantising product into the one-hot sums, against that fused program;
- whole trainings: under deterministic_histogram=1 the model JSON is the
  reference's byte for byte (binary:logistic one-hot and partition, a
  monotone numeric feature, reg:squarederror with and without base_score);
  on the f32 histogram path and under lossguide the trees are the same
  (features, children, category sets) and the predictions agree within
  1e-4, the tolerance tests/test_torch_train.py holds the numeric f32 path
  to (the root sums are the reference's f32 dot product, whose order the
  port does not reproduce, and f32 sums in another order move the leaves);
- the golden categorical.json (real XGBoost 3.4.0-dev) margins at 1e-5
  from the parquet frame, JSON and UBJ round trips, models carried both
  ways between the packages, unseen and negative codes going left, NaN
  taking the default direction, frames recoded between train and
  predict, and the dumps.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu_torch.convert import booster_from_dict, booster_to_dict

HERE = os.path.dirname(os.path.abspath(__file__))
MODELS = os.path.join(HERE, "data", "models")


def _data(R=1500, n_num=4, n_cat=3, n_cats=12, seed=0):
    """Numeric columns with 10% NaN and head-heavy category codes with 5%
    NaN (Criteo-like), and a label that depends on both."""
    rng = np.random.default_rng(seed)
    X = np.empty((R, n_num + n_cat), np.float32)
    X[:, :n_num] = rng.normal(size=(R, n_num))
    X[:, :n_num][rng.random((R, n_num)) < 0.1] = np.nan
    X[:, n_num:] = np.minimum(rng.geometric(0.2, size=(R, n_cat)) - 1,
                              n_cats - 1)
    X[:, n_num:][rng.random((R, n_cat)) < 0.05] = np.nan
    effect = rng.normal(size=n_cats)
    code = np.nan_to_num(X[:, n_num], nan=0).astype(int)
    z = (np.nan_to_num(X[:, 0]) - 0.5 * np.nan_to_num(X[:, 1])
         + effect[code] + 0.8 * (X[:, n_num + 1] == 2))
    return X, z, ["q"] * n_num + ["c"] * n_cat


def _json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.astype(np.float32).view(np.uint32)
    else:
        a, b = a.astype(np.int64), b.astype(np.int64)
    np.testing.assert_array_equal(a, b)


def _train_both(params, rounds=5, objective="binary:logistic", seed=0):
    X, z, ft = _data(seed=seed)
    y = (z > 0).astype(np.float32) if objective == "binary:logistic" else z
    params = dict(params, objective=objective)
    ref = xtb.train(params, xtb.DMatrix(X, label=y, feature_types=ft,
                                        enable_categorical=True),
                    rounds, verbose_eval=False)
    got = xtt.train(params, xtt.DMatrix(X, label=y, feature_types=ft,
                                        enable_categorical=True,
                                        device="cpu"),
                    rounds, verbose_eval=False, device="cpu")
    return X, ft, ref, got


def _assert_same_trees(ref, got):
    assert len(got.trees) == len(ref.trees)
    for a, b in zip(got.trees, ref.trees):
        np.testing.assert_array_equal(a.split_indices, b.split_indices)
        np.testing.assert_array_equal(a.left_children, b.left_children)
        np.testing.assert_array_equal(a.split_type, b.split_type)
        ca, cb = a.categories or {}, b.categories or {}
        assert sorted(ca) == sorted(cb)
        for k in ca:
            np.testing.assert_array_equal(ca[k], cb[k])


def _margins(ref, got, X, ft):
    return (ref.predict(xtb.DMatrix(X, feature_types=ft), output_margin=True),
            got.predict(xtt.DMatrix(X, feature_types=ft, device="cpu"),
                        output_margin=True))


def _predictions(ref, got, X, ft):
    return (ref.predict(xtb.DMatrix(X, feature_types=ft)),
            got.predict(xtt.DMatrix(X, feature_types=ft, device="cpu")))


# ---------------------------------------------------------------- cuts
@pytest.mark.parametrize("max_bin", [16, 128])
def test_cuts_and_bins_are_the_references(max_bin):
    from xgboost_tpu.data.quantile import sketch_dense as ref_sketch
    from xgboost_tpu_torch.data.ellpack import build_ellpack
    from xgboost_tpu_torch.data.quantile import sketch_dense

    X, _, ft = _data()
    cm = np.asarray([t == "c" for t in ft])
    want = ref_sketch(X, max_bin, cat_mask=cm)
    got = sketch_dense(torch.from_numpy(X), max_bin, cat_mask=cm)
    for field in ("cut_ptrs", "cut_values", "min_vals"):
        _bits_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(got.feature_cuts(4), np.arange(1, 13))
    # the numeric columns' cuts are those of the same columns alone
    alone = sketch_dense(torch.from_numpy(X[:, :4].copy()), max_bin)
    for f in range(4):
        _bits_equal(got.feature_cuts(f), alone.feature_cuts(f))
    dt = xtt.DMatrix(X, feature_types=ft, device="cpu")
    dr = xtb.DMatrix(X, feature_types=ft)
    tb, rb = dt.ensure_ellpack(max_bin), dr.ensure_ellpack(max_bin)
    np.testing.assert_array_equal(tb.bins.numpy(), np.asarray(rb.bins))
    assert tb.bins.dtype == torch.uint8


def test_device_sketch_with_categorical_columns(monkeypatch):
    """The card's route (the device sketch of the numeric sub-matrix, the
    largest code on the device) against the reference's forced device
    branch, above the 2**19-row subsample."""
    from xgboost_tpu.data.quantile import sketch_dense as ref_sketch
    from xgboost_tpu_torch.data.quantile import sketch_dense

    monkeypatch.setenv("XTB_FORCE_DEVICE_SKETCH", "1")
    rng = np.random.default_rng(3)
    R = (1 << 19) + 4096
    X = rng.normal(size=(R, 3)).astype(np.float32)
    X[:, 1] = np.minimum(rng.geometric(0.08, size=R) - 1, 99)
    X[rng.random(R) < 0.01, 1] = np.nan
    cm = np.array([False, True, False])
    want = ref_sketch(X, 128, use_device=True, cat_mask=cm)
    got = sketch_dense(torch.from_numpy(X), 128, use_device=True,
                       cat_mask=cm)
    for field in ("cut_ptrs", "cut_values", "min_vals"):
        _bits_equal(getattr(got, field), getattr(want, field))


def test_identity_cuts_bin_codes_as_the_reference():
    """Code c in bin c; codes at or above n_cats clamp into the top bin,
    negative and fractional codes take the bin of their count of cuts, NaN
    the sentinel (reference ellpack.py, the same searchsorted)."""
    from xgboost_tpu.data.ellpack import build_ellpack as ref_build
    from xgboost_tpu.data.quantile import sketch_dense as ref_sketch
    from xgboost_tpu_torch.data.ellpack import build_ellpack
    from xgboost_tpu_torch.data.quantile import sketch_dense

    X, _, ft = _data(R=600)
    cm = np.asarray([t == "c" for t in ft])
    cuts = sketch_dense(torch.from_numpy(X), 128, cat_mask=cm)
    Y = X.copy()
    Y[:8, 4] = [0, 11, 12, 50, -1, -7.5, 2.5, np.nan]
    got = build_ellpack(torch.from_numpy(Y), cuts).bins.numpy()
    want = np.asarray(ref_build(Y, ref_sketch(X, 128, cat_mask=cm)).bins)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:8, 4], [0, 11, 11, 11, 0, 0, 2,
                                               cuts.max_n_bins])


def test_frame_ingest_matches_the_reference():
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "a": rng.normal(size=50).astype(np.float32),
        "c": pd.Categorical(rng.choice(["x", "y", "z"], 50),
                            categories=["z", "y", "x"]),
        "i": rng.integers(0, 5, 50)})
    df.loc[3, "c"] = np.nan
    dt = xtt.DMatrix(df, enable_categorical=True, device="cpu")
    dr = xtb.DMatrix(df, enable_categorical=True)
    assert dt.feature_types == dr.feature_types == ["q", "c", "int"]
    assert dt.feature_names == dr.feature_names
    assert dt.get_categories() == dr.get_categories()
    np.testing.assert_array_equal(dt.X.numpy(), dr.host_dense())
    assert torch.isnan(dt.X[3, 1])


# ---------------------------------------------------------------- split scan
SPLIT = dict(eta=0.3, gamma=0.0, min_child_weight=0.5, lambda_=1.0,
             alpha=0.0, max_delta_step=0.0)


def _scan_case(N, F, B, seed):
    """Histograms with repeated bins (ties in G/H), 10% empty bins, n_bins
    below B (pad bins), 60% categorical features, the numeric ones weaker
    so that categorical splits are chosen."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, F, B, 2)).astype(np.float32)
    h[..., 1] = np.abs(h[..., 1]) * 2
    h[:, :, 1::3] = h[:, :, ::3][:, :, :len(range(1, B, 3))]
    nb = rng.integers(2, B + 1, size=F).astype(np.int32)
    for f in range(F):
        h[:, f, nb[f]:] = 0.0
    h[rng.random((N, F, B)) < 0.1] = 0.0
    tot = (h[:, 0].sum(1) * np.float32(1.05)).astype(np.float32)
    cm = rng.random(F) < 0.6
    cm[0] = True
    h[:, ~cm, :, 0] *= 0.02  # weak numeric features: categorical splits win
    fm = rng.random((N, F)) < 0.8
    bounds = np.stack([np.full(N, -0.5), np.full(N, 0.6)], 1).astype(
        np.float32)
    mono = tuple(int(c) for c in rng.integers(-1, 2, size=F))
    return h, tot, nb, cm, fm, bounds, mono


@pytest.mark.parametrize("mds", [0.0, 0.7])
@pytest.mark.parametrize("monotone", [False, True])
@pytest.mark.parametrize("onehot", [4, 64])
@pytest.mark.parametrize("N,F,B", [(1, 9, 16), (4, 7, 16), (8, 5, 40),
                                   (2, 9, 130)])
def test_categorical_split_scan_bitwise(N, F, B, onehot, monotone, mds):
    from xgboost_tpu.ops.split import SplitParams as RefSplitParams
    from xgboost_tpu.ops.split import evaluate_splits as ref_evaluate
    from xgboost_tpu_torch.ops.split import SplitParams, evaluate_splits

    h, tot, nb, cm, fm, bounds, mono = _scan_case(N, F, B, N + B)
    kw = dict(SPLIT, max_delta_step=mds, max_cat_to_onehot=onehot,
              monotone=mono if monotone else None)
    T = torch.from_numpy
    chosen_cat = False
    for mask in (None, fm):
        want = ref_evaluate(jnp.asarray(h), jnp.asarray(tot), jnp.asarray(nb),
                            RefSplitParams(**kw),
                            None if mask is None else jnp.asarray(mask),
                            jnp.asarray(bounds), cat_mask=jnp.asarray(cm))
        got = evaluate_splits(T(h), T(tot), T(nb), SplitParams(**kw),
                              None if mask is None else T(mask), T(bounds),
                              cat_mask=T(cm))
        for name in want._fields:
            _bits_equal(getattr(got, name), getattr(want, name))
        chosen_cat |= bool(got.is_cat.any())
    assert chosen_cat


@pytest.mark.parametrize("onehot", [4, 64])
@pytest.mark.parametrize("seed", range(6))
def test_categorical_scan_of_limbs_is_the_fused_references(seed, onehot):
    """Under deterministic_histogram the reference's level program fuses
    dequantise's product into the one-hot sums, fma(-comb, scale, total);
    the port's scan, given (comb, scale), is that program bitwise."""
    from xgboost_tpu.ops.quantise import dequantise as ref_dequantise
    from xgboost_tpu.ops.split import SplitParams as RefSplitParams
    from xgboost_tpu.ops.split import evaluate_splits as ref_evaluate
    from xgboost_tpu_torch.ops.quantise import dequantise_parts
    from xgboost_tpu_torch.ops.split import SplitParams, evaluate_splits

    rng = np.random.default_rng(seed)
    N, F, B = 8, 7, 32
    limbs = rng.integers(-128, 128, size=(N, F, B, 2, 3)).astype(np.int32)
    limbs[..., 2] = rng.integers(-2, 3, size=(N, F, B, 2))
    limbs[..., 1, :] = np.abs(limbs[..., 1, :])
    limbs[rng.random((N, F, B)) < 0.15] = 0
    nb = rng.integers(3, 13, size=F).astype(np.int32)
    for f in range(F):
        limbs[:, f, nb[f]:] = 0
    rho = (rng.random(2) * 5).astype(np.float32)
    cm = rng.random(F) < 0.6
    h = np.asarray(ref_dequantise(jnp.asarray(limbs), jnp.asarray(rho)))
    tot = (h.sum(2)[:, 0] * np.float32(1.1)).astype(np.float32)
    kw = dict(SPLIT, max_cat_to_onehot=onehot)
    rp = RefSplitParams(**kw)
    want = jax.jit(lambda q, r: ref_evaluate(
        ref_dequantise(q, r), jnp.asarray(tot), jnp.asarray(nb), rp,
        cat_mask=jnp.asarray(cm)))(jnp.asarray(limbs), jnp.asarray(rho))
    comb, scale = dequantise_parts(torch.from_numpy(limbs),
                                   torch.from_numpy(rho))
    got = evaluate_splits(comb * scale, torch.from_numpy(tot),
                          torch.from_numpy(nb), SplitParams(**kw),
                          cat_mask=torch.from_numpy(cm), dq=(comb, scale))
    for name in want._fields:
        _bits_equal(getattr(got, name), getattr(want, name))


# ---------------------------------------------------------------- training
DET = {"max_depth": 4, "max_bin": 32, "eta": 0.3, "deterministic_histogram": 1}


@pytest.mark.parametrize("extra", [
    # max_cat_threshold is accepted and read by no split code, in both
    {"max_cat_to_onehot": 4, "max_cat_threshold": 8},
    {"max_cat_to_onehot": 64},
    {"monotone_constraints": "(1,0,0,-1,0,0,0)"}],
    ids=["partition", "onehot", "monotone"])
def test_deterministic_json_is_the_references(extra):
    X, ft, ref, got = _train_both(dict(DET, **extra))
    assert _json(got) == _json(ref)
    assert sum(len(t.categories or {}) for t in got.trees) > 0


@pytest.mark.parametrize("base_score", [0.25, None])
def test_deterministic_squarederror_json_is_the_references(base_score):
    params = dict(DET, max_cat_to_onehot=8)
    if base_score is not None:
        params["base_score"] = base_score
    _, _, ref, got = _train_both(params, objective="reg:squarederror")
    assert _json(got) == _json(ref)


@pytest.mark.parametrize("onehot", [4, 64])
def test_f32_trees_are_the_references(onehot):
    X, ft, ref, got = _train_both({"max_depth": 4, "max_bin": 32, "eta": 0.3,
                                   "max_cat_to_onehot": onehot})
    _assert_same_trees(ref, got)
    a, b = _predictions(ref, got, X, ft)
    np.testing.assert_allclose(b, a, atol=1e-4)


def test_lossguide_trees_are_the_references():
    X, ft, ref, got = _train_both({"grow_policy": "lossguide",
                                   "max_leaves": 12, "max_depth": 0,
                                   "max_bin": 32, "eta": 0.3,
                                   "max_cat_to_onehot": 4}, rounds=4)
    _assert_same_trees(ref, got)
    assert any(t.categories for t in got.trees)
    a, b = _predictions(ref, got, X, ft)
    np.testing.assert_allclose(b, a, atol=1e-4)


# ---------------------------------------------------------------- models
def test_golden_categorical_margins():
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    df = pd.read_parquet(os.path.join(MODELS, "categorical_X.parquet"))
    bst = xtt.Booster(model_file=os.path.join(MODELS, "categorical.json"),
                      device="cpu")
    assert any(t.has_categorical for t in bst.trees)
    got = bst.predict(xtt.DMatrix(df, enable_categorical=True, device="cpu"),
                      output_margin=True)
    np.testing.assert_allclose(
        got, np.load(os.path.join(MODELS, "categorical_margin.npy")),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ext", ["json", "ubj"])
def test_save_load_round_trip(tmp_path, ext):
    X, ft, _, got = _train_both(dict(DET, max_cat_to_onehot=4), rounds=3)
    path = str(tmp_path / f"m.{ext}")
    got.save_model(path)
    again = xtt.Booster(model_file=path, device="cpu")
    d = xtt.DMatrix(X, feature_types=ft, device="cpu")
    np.testing.assert_array_equal(again.predict(d), got.predict(d))
    assert _json(again) == _json(got)


def test_models_carry_both_ways():
    """A reference model loads in the port and predicts the same margins,
    bitwise, and a port model in the reference; the dicts round-trip."""
    X, ft, ref, got = _train_both(dict(DET, max_cat_to_onehot=4), rounds=3)
    port_of_ref = booster_from_dict(ref.save_raw_dict(), device="cpu")
    a, b = _margins(ref, port_of_ref, X, ft)
    _bits_equal(b, a)
    ref_of_port = xtb.Booster()
    ref_of_port.load_model_dict(booster_to_dict(got))
    a, b = _margins(ref_of_port, got, X, ft)
    _bits_equal(b, a)
    assert json.dumps(booster_to_dict(port_of_ref)) == json.dumps(
        booster_to_dict(got))


def test_unseen_negative_and_missing_codes_route_as_the_reference():
    """Codes out of the sets' range and negative codes go left, NaN takes
    the default direction (common/categorical.h Decision), as the
    reference routes them."""
    X, ft, ref, got = _train_both(dict(DET, max_cat_to_onehot=4), rounds=4)
    Y = np.repeat(X[:40], 4, axis=0)
    for k, v in enumerate([99.0, -1.0, np.nan, 1e10]):
        Y[k::4, 4:] = v
    a, b = _margins(ref, got, Y, ft)
    _bits_equal(b, a)
    assert np.isfinite(b).all()


def test_frames_recode_between_train_and_predict(tmp_path):
    """A frame whose categories are declared in another order is recoded
    onto the training frame's (encoder/ordinal.h Recode), after a save and
    load too, and a category never seen in training raises."""
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(0)
    n = 1200
    colors = ["red", "green", "blue", "yellow"]
    col = rng.choice(colors, size=n)
    num = rng.normal(size=n).astype(np.float32)
    y = ((col == "red") | (col == "blue")).astype(np.float32) + 0.01 * num
    df = pd.DataFrame({"c": pd.Categorical(col, categories=colors), "x": num})
    params = {"objective": "reg:squarederror", "max_depth": 4,
              "max_cat_to_onehot": 1, "deterministic_histogram": 1}
    d = xtt.DMatrix(df, label=y, enable_categorical=True, device="cpu")
    bst = xtt.train(params, d, 8, verbose_eval=False, device="cpu")
    dr = xtb.DMatrix(df, label=y, enable_categorical=True)
    ref = xtb.train(params, dr, 8, verbose_eval=False)
    assert _json(bst) == _json(ref)  # cat_categories attribute included
    assert bst.get_categories() == ref.get_categories() == {"c": colors}
    p_train = bst.predict(d)
    _bits_equal(p_train, ref.predict(dr))
    flip = pd.DataFrame({"c": pd.Categorical(col, categories=colors[::-1]),
                         "x": num})
    d_flip = xtt.DMatrix(flip, enable_categorical=True, device="cpu")
    np.testing.assert_array_equal(bst.predict(d_flip), p_train)
    path = str(tmp_path / "cat.json")
    bst.save_model(path)
    again = xtt.Booster(model_file=path, device="cpu")
    np.testing.assert_array_equal(again.predict(d_flip), p_train)
    bad = pd.DataFrame({
        "c": pd.Categorical(["purple"] + list(col[1:]),
                            categories=["purple"] + colors), "x": num})
    with pytest.raises(ValueError, match="purple"):
        bst.predict(xtt.DMatrix(bad, enable_categorical=True, device="cpu"))
    with pytest.raises(ValueError, match="category ordering"):
        bst.update(d_flip, 8)


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_dumps_are_the_references(fmt):
    _, _, ref, got = _train_both(dict(DET, max_cat_to_onehot=4), rounds=2)
    for stats in (False, True):
        assert got.get_dump(with_stats=stats, dump_format=fmt) == \
            ref.get_dump(with_stats=stats, dump_format=fmt)
    assert any(":{" in t for t in got.get_dump())
