"""The serving engine's CUDA graphs on the card: a replay gives the bits of
the eager ``Booster.predict`` on the card and on the CPU, for each model
kind; nothing is captured after warm-up under concurrent load; K4 runs in
every replay of a transformed binary:logistic batch; an evicted model's
graphs and buffers are freed.  Skipped without a card; run them with

    python -m pytest -q -p no:cacheprovider tests/test_torch_serving_cuda.py
"""
import threading

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xtt
from xgboost_tpu_torch.ops import hist_cuda
from xgboost_tpu_torch.ops.predict import graph_replays

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA graphs run only on a GPU")

ROWS = (1, 7, 33, 64, 4097)
MODELS = {
    "binary": {"objective": "binary:logistic", "max_depth": 4},
    "squarederror": {"objective": "reg:squarederror", "max_depth": 4},
    "softprob": {"objective": "multi:softprob", "num_class": 3,
                 "max_depth": 3},
    "categorical": {"objective": "reg:squarederror", "max_depth": 4,
                    "max_cat_to_onehot": 1},
    "dart": {"objective": "binary:logistic", "booster": "dart",
             "rate_drop": 0.3, "max_depth": 3},
    "multi_output": {"objective": "reg:squarederror", "max_depth": 3,
                     "num_target": 3, "multi_strategy": "multi_output_tree"},
}


def _data(name, n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    X[rng.random(size=X.shape) < 0.05] = np.nan
    kw = {}
    if name == "categorical":
        X[:, 0] = rng.integers(0, 6, size=n)
        kw = {"feature_types": ["c", "q", "q", "q", "q"],
              "enable_categorical": True}
    z = np.nan_to_num(X[:, 1]) + 0.5 * np.nan_to_num(X[:, 2])
    if name == "softprob":
        y = np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    elif name == "multi_output":
        y = np.stack([z, z * z, -z], axis=1).astype(np.float32)
    elif name in ("binary", "dart"):
        y = (z > 0).astype(np.float32)
    else:
        y = z.astype(np.float32)
    return X, y, kw


def _pair(name, tmp_path, rounds=4):
    """The model trained on the CPU, and the same JSON loaded on the card
    and on the CPU; the rows to ask about."""
    X, y, kw = _data(name, 1500, 1)
    bst = xtt.train(MODELS[name], xtt.DMatrix(X, label=y, device="cpu",
                                              **kw),
                    rounds, verbose_eval=False, device="cpu")
    path = str(tmp_path / f"{name}.json")
    bst.save_model(path)
    card = xtt.Booster(model_file=path, device="cuda")
    cpu = xtt.Booster(model_file=path, device="cpu")
    return card, cpu, _data(name, max(ROWS), 2)[0]


@needs_cuda
@pytest.mark.parametrize("name", list(MODELS))
def test_replay_bitwise_eager_card_and_cpu(name, tmp_path):
    from xgboost_tpu_torch.serving import ServingEngine

    card, cpu, X = _pair(name, tmp_path)
    with ServingEngine(max_delay_us=200, max_batch=8192,
                       warmup_buckets=(8, 64, 8192)) as eng:
        eng.add_model(name, card)
        built = eng.compile_cache_size()
        replays = graph_replays()
        n = 0
        for r in ROWS:
            for margin in (False, True):
                want = card.predict(xtt.DMatrix(X[:r], device="cuda"),
                                    output_margin=margin)
                cpu_want = cpu.predict(xtt.DMatrix(X[:r], device="cpu"),
                                       output_margin=margin)
                np.testing.assert_array_equal(want, cpu_want)
                for direct in (False, True):
                    got = eng.predict(name, X[:r], output_margin=margin,
                                      direct=direct)
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{r} rows")
                    n += 1
        assert eng.compile_cache_size() == built  # every bucket was warm
        assert eng.metrics_snapshot()["compiles_steady"] == 0
        assert graph_replays() - replays == n


@needs_cuda
def test_k4_runs_in_every_transformed_replay(tmp_path):
    from xgboost_tpu_torch.serving import ServingEngine

    card, _, X = _pair("binary", tmp_path)
    with ServingEngine(use_batcher=False, warmup_buckets=(8, 64)) as eng:
        eng.add_model("m", card)
        hist_cuda.reset_launches()
        for r in (1, 33, 64):
            eng.predict("m", X[:r])
        eng.predict("m", X[:5], output_margin=True)
        assert hist_cuda.launches["sigmoid"] == 3


@needs_cuda
def test_no_capture_after_warmup_under_threads(tmp_path):
    from xgboost_tpu_torch.serving import ServingEngine

    card, _, X = _pair("binary", tmp_path)
    refs = {r: card.predict(xtt.DMatrix(X[:r], device="cuda"))
            for r in (1, 5, 8, 33, 64)}
    with ServingEngine(max_delay_us=500, max_batch=64,
                       warmup_buckets=(8, 16, 32, 64)) as eng:
        eng.add_model("m", card)
        before = eng.compile_cache_size()
        errors = []
        barrier = threading.Barrier(6)

        def worker(t):
            try:
                barrier.wait(30)
                for i in range(40):
                    r = (1, 5, 8, 33, 64)[(t + i) % 5]
                    out = eng.predict("m", X[:r], direct=bool(i % 2))
                    assert np.array_equal(out, refs[r])
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
        if errors:
            raise errors[0]
        assert eng.compile_cache_size() == before
        assert eng.metrics_snapshot()["compiles_steady"] == 0


@needs_cuda
def test_eviction_frees_the_models_memory(tmp_path):
    from xgboost_tpu_torch.serving import ServingEngine

    card, _, X = _pair("binary", tmp_path)
    other, _, _ = _pair("squarederror", tmp_path)
    with ServingEngine(use_batcher=False, max_models=1) as eng:
        torch.cuda.synchronize()
        empty = torch.cuda.memory_allocated()
        programs = eng.compile_cache_size()
        eng.add_model("a", card)  # the default ladder, 8 ... 4096
        eng.predict("a", X[:100])
        resident = torch.cuda.memory_allocated()
        assert resident > empty
        eng.add_model("b", other, warmup=False)  # evicts a
        eng.registry.remove("b")
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == empty
        assert eng.compile_cache_size() == programs
