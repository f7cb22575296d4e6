"""Port parity for the rendezvous tracker (xgboost_tpu_torch/tracker.py)
against the reference's (xgboost_tpu/tracker.py): the same bytes on the
wire, the reference's raw-socket protocol checks (tests/test_tracker.py)
against the port's tracker, clients of either package with the other's
tracker, the relay's gathers and failures, and the abort fan-out in
worker processes.

No test here sends ``abort`` to a client in this process: a client's
watcher exits the process on it.  The fan-out is checked on raw sockets
and in worker processes."""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import xgboost_tpu_torch as xtt
from xgboost_tpu import tracker as ref_tracker
from xgboost_tpu_torch import tracker as port_tracker
from xgboost_tpu_torch.tracker import RabitTracker, recv_msg, send_msg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_MESSAGES = {
    "start": ({"cmd": "start", "host": "hostA", "task_id": ""}, b""),
    "assignment": ({"rank": 0, "world": 3, "coordinator": None,
                    "coll_port": 4242, "failover": False, "elastic": False},
                   b""),
    "coll": ({"cmd": "coll", "seq": 7, "nbytes": 12,
              "crc": 0x89ABCDEF}, np.arange(3, dtype=np.float32).tobytes()),
    "unicode": ({"cmd": "error", "msg": "worker 1: ValueError('é — x')"},
                b""),
}


def _wire(mod, obj, trailing):
    """What ``mod.send_msg`` writes for ``obj`` and ``trailing``."""
    a, b = socket.socketpair()
    with a, b:
        mod.send_msg(a, obj, trailing=trailing)
        a.shutdown(socket.SHUT_WR)
        data = b""
        while chunk := b.recv(1 << 16):
            data += chunk
    return data


@pytest.mark.parametrize("name", list(_MESSAGES))
def test_send_msg_writes_the_references_bytes(name):
    obj, trailing = _MESSAGES[name]
    got = _wire(port_tracker, obj, trailing)
    assert got == _wire(ref_tracker, obj, trailing)
    assert got.endswith(trailing)
    for mod in (port_tracker, ref_tracker):
        a, b = socket.socketpair()
        with a, b:
            a.sendall(got)
            assert mod.recv_msg(b, timeout=5) == obj


@pytest.mark.parametrize("where", ["payload", "crc", "length"])
def test_damaged_frame_raises_connection_error(where):
    """A flipped bit in the JSON or its CRC fails the CRC check, and one in
    the length's top byte an insane length: ConnectionError in both."""
    frame = bytearray(_wire(port_tracker, {"cmd": "shutdown"}, b""))
    frame[{"payload": 12, "crc": 5, "length": 0}[where]] ^= 0x10
    for mod in (port_tracker, ref_tracker):
        a, b = socket.socketpair()
        with a, b:
            a.sendall(bytes(frame))
            with pytest.raises(ConnectionError):
                mod.recv_msg(b, timeout=5)


def test_recv_msg_timeout_is_one_budget_a_message():
    """A peer that trickles a message spends one timeout, not one a
    byte, in both packages."""
    frame = _wire(port_tracker, {"cmd": "x" * 40}, b"")
    for mod in (port_tracker, ref_tracker):
        a, b = socket.socketpair()

        def trickle():
            for i in range(len(frame)):
                try:
                    a.sendall(frame[i:i + 1])
                except OSError:
                    return
                time.sleep(0.05)

        t = threading.Thread(target=trickle, daemon=True)
        t.start()
        t0 = time.monotonic()
        with pytest.raises(ConnectionError):
            mod.recv_msg(b, timeout=0.5)
        assert time.monotonic() - t0 < 2.0
        a.close()
        b.close()
        t.join(10)


def test_rendezvous_protocol_assigns_sorted_ranks():
    """The reference's raw-socket check (tests/test_tracker.py:18): ranks
    by host, the world, one coordinator, rank 0 reporting it first."""
    tr = RabitTracker(n_workers=3, host_ip="127.0.0.1")
    tr.start()
    results = {}

    def worker(host_tag, idx):
        s = socket.create_connection(("127.0.0.1", tr.port), timeout=30)
        send_msg(s, {"cmd": "start", "host": host_tag})
        reply = recv_msg(s)
        if reply.get("coordinator") is None:
            assert reply["rank"] == 0
            send_msg(s, {"cmd": "coordinator", "addr": "127.0.0.1:45678"})
            reply = dict(reply, coordinator="127.0.0.1:45678")
        results[idx] = (host_tag, reply)
        send_msg(s, {"cmd": "shutdown"})
        s.close()

    threads = []
    for idx, tag in enumerate(["hostC", "hostA", "hostB"]):
        t = threading.Thread(target=worker, args=(tag, idx))
        t.start()
        threads.append(t)
        time.sleep(0.2)  # a fixed arrival order
    for t in threads:
        t.join(30)
    tr.wait_for(timeout=30)
    by_host = {tag: r for (tag, r) in results.values()}
    assert [by_host[h]["rank"] for h in ("hostA", "hostB", "hostC")] == \
        [0, 1, 2]
    assert len({r["coordinator"] for (_t, r) in results.values()}) == 1
    assert all(r["world"] == 3 for (_t, r) in results.values())
    assert all(r["coll_port"] == tr._relay.port for _t, r in results.values())
    tr.free()


def test_sortby_task_and_arrival_and_stray_connections():
    """sortby="task" orders by task_id; equal keys keep their arrival
    order; a connection that sends no start takes no slot."""
    tr = RabitTracker(n_workers=3, host_ip="127.0.0.1", sortby="task")
    tr.start()
    stray = socket.create_connection(("127.0.0.1", tr.port), timeout=30)
    stray.close()
    got = {}

    def worker(task, idx):
        s = socket.create_connection(("127.0.0.1", tr.port), timeout=30)
        send_msg(s, {"cmd": "start", "host": "same", "task_id": task})
        reply = recv_msg(s)
        if reply["coordinator"] is None:
            send_msg(s, {"cmd": "coordinator", "addr": "127.0.0.1:1"})
        got[idx] = reply["rank"]
        send_msg(s, {"cmd": "shutdown"})
        s.close()

    threads = []
    for idx, task in enumerate(["t2", "t1", "t1"]):
        t = threading.Thread(target=worker, args=(task, idx))
        t.start()
        threads.append(t)
        time.sleep(0.2)
    for t in threads:
        t.join(30)
    tr.wait_for(timeout=30)
    tr.free()
    assert got == {1: 0, 2: 1, 0: 2}


def test_wait_for_raises_on_worker_error():
    """The reference's check (tests/test_tracker.py:59): a worker's error
    message makes wait_for raise and the tracker send the other worker
    ``abort``."""
    tr = RabitTracker(n_workers=2, host_ip="127.0.0.1")
    tr.start()
    aborted = {}

    def ok_worker():
        s = socket.create_connection(("127.0.0.1", tr.port), timeout=30)
        send_msg(s, {"cmd": "start", "host": "a"})
        reply = recv_msg(s)
        assert reply["rank"] == 0 and reply["coordinator"] is None
        send_msg(s, {"cmd": "coordinator", "addr": "127.0.0.1:45678"})
        aborted["msg"] = recv_msg(s)  # blocks until the fan-out
        s.close()

    def bad_worker():
        s = socket.create_connection(("127.0.0.1", tr.port), timeout=30)
        send_msg(s, {"cmd": "start", "host": "b"})
        recv_msg(s)
        time.sleep(0.3)
        send_msg(s, {"cmd": "error", "msg": "synthetic failure"})
        s.close()

    t1 = threading.Thread(target=ok_worker)
    t2 = threading.Thread(target=bad_worker)
    t1.start()
    t2.start()
    with pytest.raises(RuntimeError, match="synthetic failure"):
        tr.wait_for(timeout=30)
    t1.join(30)
    t2.join(30)
    assert aborted["msg"] == {"cmd": "abort",
                              "msg": "worker 1: synthetic failure"}
    tr.free()


def test_lost_worker_aborts_the_others():
    """A worker whose connection drops without a shutdown is a death: the
    others are aborted and wait_for raises."""
    tr = RabitTracker(n_workers=2, host_ip="127.0.0.1")
    tr.start()
    socks = {}

    def worker(host):
        s = socket.create_connection(("127.0.0.1", tr.port), timeout=30)
        send_msg(s, {"cmd": "start", "host": host})
        reply = recv_msg(s)
        if reply["coordinator"] is None:
            send_msg(s, {"cmd": "coordinator", "addr": "127.0.0.1:1"})
        socks[reply["rank"]] = s

    threads = [threading.Thread(target=worker, args=(h,)) for h in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    socks[1].close()
    with pytest.raises(RuntimeError, match="worker 1: tracker connection "
                       "lost"):
        tr.wait_for(timeout=30)
    assert recv_msg(socks[0], timeout=10)["cmd"] == "abort"
    socks[0].close()
    tr.free()


def _clients(client_mod, tracker, n=2, fn=None):
    """``n`` clients of ``client_mod`` in threads against ``tracker``;
    each gathers ``fn(rank)`` on the relay and shuts down.  By rank: the
    client's (rank, world, coordinator, gathered stack)."""
    out, errs = {}, []

    def worker():
        try:
            c = client_mod.TrackerClient("127.0.0.1", tracker.port)
            stack = c.coll_allgather(fn(c.rank)) if fn else None
            out[c.rank] = (c.rank, c.world, c.coordinator, stack)
            c.shutdown()
        except BaseException as e:  # noqa: BLE001 - raised below
            errs.append(e)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads), "a client hung"
    if errs:
        raise errs[0]
    return out


def _rank_rows(rank):
    return np.arange(6, dtype=np.int64).reshape(2, 3) * (rank + 1) - rank


@pytest.mark.parametrize("tracker_pkg,client_pkg", [
    ("port", "port"), ("reference", "port"), ("port", "reference")])
def test_clients_rendezvous_across_packages(tracker_pkg, client_pkg):
    """Port clients with the reference's tracker and the reverse: the
    same ranks, one coordinator, the rank-ordered stack on the relay."""
    mods = {"port": port_tracker, "reference": ref_tracker}
    tr = mods[tracker_pkg].RabitTracker(n_workers=2, host_ip="127.0.0.1")
    tr.start()
    out = _clients(mods[client_pkg], tr, fn=_rank_rows)
    tr.wait_for(timeout=30)
    tr.free()
    assert sorted(out) == [0, 1]
    want = np.stack([_rank_rows(0), _rank_rows(1)])
    for r, (rank, world, coord, stack) in out.items():
        assert (rank, world, coord) == (r, 2, out[0][2])
        assert stack.dtype == want.dtype
        np.testing.assert_array_equal(stack, want)


def test_relay_gathers_in_rank_order():
    """Several gathers of several dtypes on the relay: each the stack of
    the ranks' arrays in rank order, on every rank."""
    tr = RabitTracker(n_workers=3, host_ip="127.0.0.1")
    tr.start()
    arrays = {r: [np.full((2, 2), r, np.int8),
                  np.linspace(0, 1, 5, dtype=np.float32) + r,
                  np.asarray([r * 1e300], np.float64)] for r in range(3)}

    def fn(c):
        return [c.coll_allgather(a) for a in arrays[c.rank]]

    out, errs = {}, []

    def worker():
        try:
            c = port_tracker.TrackerClient("127.0.0.1", tr.port)
            out[c.rank] = fn(c)
            c.shutdown()
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs and len(out) == 3
    tr.wait_for(timeout=30)
    tr.free()
    for r in range(3):
        for k in range(3):
            want = np.stack([arrays[q][k] for q in range(3)])
            assert out[r][k].dtype == want.dtype
            np.testing.assert_array_equal(out[r][k], want)


def test_client_closing_mid_gather_fails_its_peer():
    """A client that closes its relay connection while a gather it did
    not feed is pending makes its peer's gather raise RuntimeError at
    once, and the relay reports the lost rank (the tracker's abort
    fan-out, replaced here by a recorder)."""
    tr = RabitTracker(n_workers=2, host_ip="127.0.0.1")
    lost = []
    tr._relay.on_worker_lost = lambda rank, msg: lost.append((rank, msg))
    tr.start()
    clients, ready = {}, threading.Barrier(2)
    errs = {}

    def worker():
        c = port_tracker.TrackerClient("127.0.0.1", tr.port)
        clients[c.rank] = c
        ready.wait(30)
        if c.rank == 0:
            try:
                c.coll_allgather(np.ones(3))
            except RuntimeError as e:
                errs[0] = (e, time.monotonic())
        else:
            c._coll_sock()  # joins the relay
            time.sleep(0.5)  # rank 0's gather is pending by now
            c._coll.close()
            c._coll = None
            errs[1] = time.monotonic()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads), "a client hung"
    err, t_err = errs[0]
    assert "collective relay failed" in str(err)
    assert t_err - errs[1] < 10
    # the fan-out runs in the relay thread that records the failure, which
    # may finish after rank 0's error reached it
    deadline = time.monotonic() + 10
    while not lost and time.monotonic() < deadline:
        time.sleep(0.05)
    assert lost and lost[0][0] == 1
    for c in clients.values():
        c.shutdown()
    tr.wait_for(timeout=30)
    tr.free()


def _join_elastic_reference():
    tr = ref_tracker.RabitTracker(n_workers=1, host_ip="127.0.0.1",
                                  elastic=True)
    tr.start()
    try:
        port_tracker.TrackerClient("127.0.0.1", tr.port, retries=1)
    finally:
        tr.free()


def _client_method(name):
    tr = RabitTracker(n_workers=1, host_ip="127.0.0.1")
    tr.start()
    c = port_tracker.TrackerClient("127.0.0.1", tr.port)
    try:
        if name == "regroup":
            c.regroup(1)
        else:
            c.ship_telemetry({})
    finally:
        c.shutdown()
        tr.wait_for(timeout=30)
        tr.free()


_REFUSED = {
    "elastic": (lambda: RabitTracker(2, host_ip="127.0.0.1", elastic=True),
                "9b.3"),
    "journal": (lambda: RabitTracker(2, host_ip="127.0.0.1",
                                     journal="/nonexistent/j"), "item 11"),
    "join_elastic_reference": (_join_elastic_reference, "9b.3"),
    "regroup": (lambda: _client_method("regroup"), "9b.3"),
    "ship_telemetry": (lambda: _client_method("ship_telemetry"), "item 11"),
}


@pytest.mark.parametrize("case", list(_REFUSED))
def test_refused_arguments_raise(case):
    fn, item = _REFUSED[case]
    with pytest.raises(NotImplementedError, match=item):
        fn()


@pytest.mark.parametrize("cmd,item", [("regroup_join", "9b.3"),
                                      ("telemetry", "item 11")])
def test_unserved_messages_end_the_job(cmd, item):
    """A worker message of the elastic or reliability layers ends the job
    with an error naming its item, rather than being dropped."""
    tr = RabitTracker(n_workers=1, host_ip="127.0.0.1")
    tr.start()
    s = socket.create_connection(("127.0.0.1", tr.port), timeout=30)
    send_msg(s, {"cmd": "start", "host": "a"})
    recv_msg(s)
    send_msg(s, {"cmd": "coordinator", "addr": "127.0.0.1:1"})
    send_msg(s, {"cmd": cmd, "round": 1})
    with pytest.raises(RuntimeError, match=item):
        tr.wait_for(timeout=30)
    s.close()
    tr.free()


def test_tracker_is_exported():
    assert xtt.tracker is port_tracker
    assert "tracker" in xtt.__all__


_ABORT_CHILD = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
from xgboost_tpu_torch import collective
uri, port, mode = sys.argv[2], int(sys.argv[3]), sys.argv[4]
collective.init(dmlc_tracker_uri=uri, dmlc_tracker_port=port,
                dmlc_nworker=2, device="cpu")
if mode == "fail":
    time.sleep(0.5)
    collective.signal_error("boom")  # exits 1 after telling the tracker
else:
    collective.allreduce(np.ones(2))  # only the abort fan-out ends it
    time.sleep(900)
"""


def test_error_fanout_kills_the_waiting_worker():
    """The reference's end-to-end check (tests/test_tracker.py:166) on the
    port's collective: one worker signals, the other, waiting in a
    collective on the relay, is aborted with code 255, and wait_for
    raises."""
    tr = RabitTracker(n_workers=2, host_ip="127.0.0.1")
    tr.start()
    args = tr.worker_args()
    t0 = time.monotonic()
    procs = {mode: subprocess.Popen(
        [sys.executable, "-c", _ABORT_CHILD, ROOT,
         str(args["dmlc_tracker_uri"]), str(args["dmlc_tracker_port"]),
         mode], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for mode in ("hang", "fail")}
    try:
        with pytest.raises(RuntimeError, match="boom"):
            tr.wait_for(timeout=120)
        assert procs["fail"].wait(timeout=60) == 1
        assert procs["hang"].wait(timeout=60) == 255
        assert time.monotonic() - t0 < 120
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        tr.free()
