"""Port parity for the collective (xgboost_tpu_torch/collective.py) and the
host exchange of the multi-rank growers (parallel/process.py).

Every op runs on in-memory groups (threads of this process, one rank
each) of both packages with the same inputs, and each rank's result must
be the reference's bit for bit: an allreduce is a numpy reduction of the
gathered stack in rank order in both.  The gloo backend runs in two
worker processes.  Each test's group names are its own."""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import xgboost_tpu as xtb
import xgboost_tpu_torch as xtt
from xgboost_tpu_torch import collective as coll
from xgboost_tpu_torch.ops import hist_cuda
from xgboost_tpu_torch.parallel import HostExchange

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def ranks(pkg, group, fn, world=2, timeout=120):
    """``fn(rank)`` in ``world`` threads, each an in-memory rank of
    ``group`` of ``pkg``'s collective: the results by rank, or the lowest
    failed rank's own exception.  A rank that fails aborts the group (the
    port's CommunicatorContext does so itself), so no rank waits out its
    peers; a peer's broken barrier is that failure's echo, raised only
    where no rank raised anything else."""
    out, errs = {}, {}

    def worker(r):
        try:
            with pkg.collective.CommunicatorContext(
                    dmlc_communicator="in-memory", in_memory_world_size=world,
                    in_memory_rank=r, in_memory_group=group):
                backend = pkg.collective._TLS.backend
                try:
                    out[r] = fn(r)
                except BaseException:
                    backend._group.barrier.abort()
                    raise
        except BaseException as e:  # noqa: BLE001 - reported below
            errs[r] = e

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errs:
        own = {r: e for r, e in errs.items()
               if not isinstance(e, threading.BrokenBarrierError)}
        raise (own or errs)[min(own or errs)]
    return [out[r] for r in range(world)]


def _inputs(rank, world):
    rng = np.random.default_rng(100 + rank)
    return {
        "i64": rng.integers(-1000, 1000, size=(3, 4)).astype(np.int64),
        "f32": rng.normal(size=(5,)).astype(np.float32),
        "f64": rng.normal(size=(2, 3)),
        "rows": rng.normal(size=(rank + 2, 3)).astype(np.float32),
        "vec": np.arange(rank * 3 + 1, dtype=np.int32),
    }


def _ops(c, rank, world):
    """Every op of the flat API on this rank's inputs."""
    x = _inputs(rank, world)
    out = {}
    for op in c.Op:
        out[f"allreduce_{op.name}"] = c.allreduce(x["i64"], op)
    for op in (c.Op.SUM, c.Op.MAX, c.Op.MIN):
        out[f"allreduce_f32_{op.name}"] = c.allreduce(x["f32"], op)
        out[f"allreduce_f64_{op.name}"] = c.allreduce(x["f64"], op)
    out["allgather"] = c.allgather(x["f32"])
    out["allgather_ragged_2d"] = c.allgather_ragged(x["rows"])
    out["allgather_ragged_1d"] = c.allgather_ragged(x["vec"])
    out["broadcast"] = c.broadcast(
        {"rank": rank, "cuts": x["f64"].tolist()} if rank == world - 1
        else None, world - 1)
    out["global_sum"] = c.global_sum(np.asarray([float(rank + 1), 2.5]))
    out["global_max"] = c.global_max(np.asarray([rank, -rank]))
    out["global_ratio"] = c.global_ratio(float(rank), 1.0 + rank)
    out["world"] = (c.get_rank(), c.get_world_size(), c.is_distributed())
    return out


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    return a == b


@pytest.mark.parametrize("world", [2, 3])
def test_every_op_is_the_references(world):
    got = ranks(xtt, f"ops-port-{world}",
                lambda r: _ops(xtt.collective, r, world), world)
    want = ranks(xtb, f"ops-ref-{world}",
                 lambda r: _ops(xtb.collective, r, world), world)
    for r in range(world):
        assert got[r].keys() == want[r].keys()
        for k in want[r]:
            assert _same(got[r][k], want[r][k]), (r, k, got[r][k],
                                                  want[r][k])
        # every rank holds the same reductions
        for k in want[r]:
            if k != "world":
                assert _same(got[r][k], got[0][k]), (r, k)


def test_single_process_identities():
    """Without a group: world 1, the identity, as the reference."""
    a = np.asarray([3, 5], np.int64)
    one = coll.SingleProcessBackend()
    assert (one.rank(), one.world_size()) == (0, 1)
    np.testing.assert_array_equal(one.allreduce(a, coll.Op.SUM), a)
    np.testing.assert_array_equal(one.allgather(a), a[None])
    assert one.broadcast_bytes(b"xy", 0) == b"xy"
    for c in (coll, xtb.collective):
        np.testing.assert_array_equal(c.allreduce(a, c.Op.MAX), a)
        assert c.get_rank() == 0 and c.get_world_size() == 1
        assert not c.is_distributed()
        assert c.broadcast({"x": 1}, 0) == {"x": 1}
        np.testing.assert_array_equal(c.allgather_ragged(a), a)
        assert c.global_ratio(3.0, 4.0) == 0.75
        assert np.isnan(c.global_ratio(1.0, 0.0))


def test_failed_rank_aborts_its_peers():
    """A rank that leaves its block by an exception makes its peer's
    collective raise at once (no rank waits out the timeout)."""
    def fn(r):
        if r == 1:
            raise ValueError("rank 1 failed")
        return coll.allreduce(np.ones(2))

    errs = {}

    def worker(r):
        try:
            with coll.CommunicatorContext(
                    dmlc_communicator="in-memory", in_memory_world_size=2,
                    in_memory_rank=r, in_memory_group="abort-port"):
                fn(r)
        except BaseException as e:  # noqa: BLE001
            errs[r] = e

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert isinstance(errs[1], ValueError)
    assert isinstance(errs[0], threading.BrokenBarrierError)


@pytest.mark.parametrize("args,match", [
    ({"dmlc_tracker_uri": "127.0.0.1"}, "tracker"),
    ({"dmlc_communicator": "federated"}, "federated"),
    ({"dmlc_communicator": "in-memory", "in_memory_join": True}, "join"),
])
def test_unported_backends_raise(args, match):
    """The unported backends raise NotImplementedError; a tracker address
    without its port raises the reference's ValueError (a worker that
    meant to join a job must not train its shard alone)."""
    exc = ValueError if match == "tracker" else NotImplementedError
    with pytest.raises(exc, match=match):
        coll.init(**args)
    with pytest.raises(ValueError, match="BOTH"):
        xtb.collective.init(**{"dmlc_tracker_port": 9091})
    with pytest.raises(NotImplementedError, match="regroup"):
        coll.regroup(0)
    assert coll.get_world_size() == 1  # nothing was left initialized


@pytest.mark.parametrize("dtype,out", [(torch.float32, None),
                                       (torch.int32, torch.int64)])
def test_host_exchange_sums_in_rank_order(dtype, out):
    """The growers' exchange: the rank-order numpy sum of every rank's
    tensor (int32 limbs as int64), the same on every rank, with its parts
    counted."""
    def local(r):
        g = torch.Generator().manual_seed(7 + r)
        t = torch.randn((3, 4, 5, 2), generator=g) * 1e3
        return t if dtype == torch.float32 else t.to(torch.int32)

    def fn(r):
        ex = HostExchange()
        res = ex.allreduce(local(r), out)
        return res, ex.stats

    got = ranks(xtt, f"exchange-{dtype}", fn, world=3)
    stack = np.stack([local(r).numpy() for r in range(3)])
    want = np.sum(stack.astype(np.int64) if out is not None else stack,
                  axis=0)
    for res, stats in got:
        assert res.dtype == (out or dtype)
        np.testing.assert_array_equal(res.numpy(), want)
        assert stats["calls"] == 1
        assert stats["bytes"] == local(0).numpy().nbytes


def test_launch_counts_survive_rank_threads():
    """The ranks of the in-memory collective are threads sharing the
    kernel launch counts: no count may be lost, and each thread sees its
    own (more threads than cores, a short switch interval)."""
    n_threads, n = 16, 2000
    mine = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        hist_cuda.reset_launches()

        def worker(i):
            for _ in range(n):
                hist_cuda.launched("hist_q", None, 0)
            mine[i] = hist_cuda.thread_launches()["hist_q"]

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert hist_cuda.launches["hist_q"] == n_threads * n
        assert mine == {i: n for i in range(n_threads)}
    finally:
        sys.setswitchinterval(old)
        hist_cuda.reset_launches()


_GLOO_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from xgboost_tpu_torch import collective as c
port, rank = sys.argv[2], int(sys.argv[3])
with c.CommunicatorContext(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=rank):
    x = np.arange(4, dtype=np.float32) * (rank + 1) + 0.1
    out = {
        "rank": c.get_rank(), "world": c.get_world_size(),
        "sum": c.allreduce(x).tolist(),
        "max": c.allreduce(np.asarray([rank, 7 - rank], np.int64),
                           c.Op.MAX).tolist(),
        "xor": c.allreduce(np.asarray([rank + 1], np.int32),
                           c.Op.BITWISE_XOR).tolist(),
        "ragged": c.allgather_ragged(np.full((rank + 1, 2), rank,
                                             np.int16)).tolist(),
        "bcast": c.broadcast({"from": rank} if rank == 1 else None, 1),
        "ratio": c.global_ratio(float(rank), 2.0),
    }
print(json.dumps(out))
"""


def test_gloo_processes_reduce_as_the_in_memory_ranks():
    """Two processes over torch.distributed's gloo backend: every op's
    result is what the in-memory ranks compute from the same inputs."""
    from xgboost_tpu_torch.launcher import _free_port

    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_WORKER, ROOT, str(port), str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        o, e = p.communicate(timeout=120)
        assert p.returncode == 0, e[-2000:]
        outs.append(json.loads(o.strip().splitlines()[-1]))
    xs = [np.arange(4, dtype=np.float32) * (r + 1) + 0.1 for r in range(2)]
    want = {"world": 2, "sum": np.sum(np.stack(xs), axis=0).tolist(),
            "max": [1, 7], "xor": [3],
            "ragged": [[0, 0], [1, 1], [1, 1]], "bcast": {"from": 1},
            "ratio": 0.25}
    for r, o in enumerate(outs):
        assert o.pop("rank") == r
        assert o == want
