"""Port parity for the launcher (xgboost_tpu_torch/launcher.py): worker
processes on the CPU, each ``fn(rank, world)`` of tests/
torch_launcher_workers.py, against the reference's two in-memory ranks on
the same shards.

Tolerance: under deterministic_histogram=1 the model JSON of every worker
is byte-identical to the reference's two-rank model, whichever way the
ranks meet (the tracker's relay, gloo at the tracker's coordinator, or
gloo directly)."""
import ast
import functools
import json
import time

import pytest

import xgboost_tpu as xtb
from xgboost_tpu.utils import native as ref_native
from xgboost_tpu_torch import launcher
from xgboost_tpu_torch.launcher import WorkerFailedError, run_distributed

import torch_launcher_workers as workers
from test_torch_distributed import DET, _ref_json, _train


@pytest.fixture(scope="module")
def reference_model():
    """The reference's two in-memory ranks on the workers' shards, 3
    rounds: the model JSON.  Its native library is loaded here first, as
    tests/test_torch_distributed.py does: a rank thread asking for it
    while another loads it would trace the XLA scan."""
    ref_native.load_ffi()
    shards = [(X, y, {}) for X, y in workers.shards()]
    got = _train(xtb, "launcher-ref", DET, shards, rounds=3)
    return _ref_json(got[0][0])


@pytest.mark.parametrize("rendezvous,coll", [
    ("tracker", "relay"), ("tracker", "gloo"), ("direct", "auto")])
def test_workers_write_the_references_bytes(rendezvous, coll, tmp_path,
                                            monkeypatch, reference_model):
    monkeypatch.setenv("XGBOOST_TPU_COLL", coll)
    fn = functools.partial(workers.train_shard, out_dir=str(tmp_path),
                           params=dict(DET, device="cpu"), rounds=3)
    stats = run_distributed(fn, 2, platform="cpu", rendezvous=rendezvous,
                            timeout=300)
    assert stats["succeeded"] == 2 and stats["tolerated"] == []
    for r in range(2):
        out = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert out["world"] == 2
        assert out["model"] == reference_model, r


def test_signal_error_aborts_the_peer():
    """A worker calling signal_error ends the job at once: it exits 1,
    and the tracker's abort ends its peer, waiting in a collective, with
    code 255."""
    t0 = time.monotonic()
    with pytest.raises(WorkerFailedError) as err:
        run_distributed(workers.signal_or_wait, 2, platform="cpu",
                        timeout=300)
    assert time.monotonic() - t0 < 120, "the failure did not end the job"
    assert sorted(rc for _l, rc, _t in err.value.failures) == [1, 255]
    assert "aborted by tracker fan-out" in str(err.value)
    assert "rank 1 gives up on purpose" in str(err.value)


@pytest.mark.parametrize("kwargs,item", [
    ({"elastic": True}, "9b.3"),
    ({"max_respawns": 1}, "9b.3"),
    ({"tracker_failover": True}, "item 11"),
    ({"max_tracker_respawns": 1}, "item 11"),
    ({"fault_plan": "{}"}, "item 11"),
])
def test_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        run_distributed(workers.signal_or_wait, 2, platform="cpu", **kwargs)


def test_child_imports_only_the_port():
    """The launcher's worker script imports the standard library and
    xgboost_tpu_torch, nothing else."""
    mods = set()
    for node in ast.walk(ast.parse(launcher._CHILD)):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert mods == {"pickle", "sys", "xgboost_tpu_torch"}
