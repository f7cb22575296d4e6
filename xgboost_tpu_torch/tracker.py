"""Rendezvous tracker (port of xgboost_tpu/tracker.py; reference
python-package/xgboost/tracker.py RabitTracker over
src/collective/tracker.cc).

A socket rendezvous server.  Workers connect without a rank; the tracker
sorts them by host (``sortby="host"``, or by ``task_id`` under
``sortby="task"``), then by arrival, and hands every worker its
``(rank, world)``, the coordinator address rank 0 reported (the gloo
process group's ``init_method``) and the port of its collective relay.
The persistent connection is the error channel: a worker that reports a
failure (``collective.signal_error``), or whose connection drops without
a ``shutdown``, makes the tracker send ``{"cmd": "abort"}`` to every other
worker, whose watcher thread exits the process with code 255 (the
reference's tracker.cc:345 CMD::kError and comm.cc:340-376 detached
watcher).

Wire format, the reference's byte for byte: a 4-byte big-endian length, a
4-byte CRC-32 of the JSON, then the JSON object; the relay's binary
payloads follow their ``coll`` / ``coll_result`` header, which carries
their CRC.  A CRC mismatch or a length above ``MAX_MSG`` raises
``ConnectionError``, as a dropped connection does.

Not ported: elastic membership (the relay's epochs, regroup, rejoin and
late joiners; ROADMAP Queue 1 item 9b.3), and the reliability layer (the
journal, tracker failover and re-adoption, the stall watchdog, telemetry
ingest, per-link deadlines and the fault seams; item 11).  The arguments
and messages that ask for them raise ``NotImplementedError`` or end the
job with an error naming the item.
"""
from __future__ import annotations

import contextlib
import json
import os
import random
import socket
import struct
import sys
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

__all__ = ["OP_TIMEOUT", "COLL_TIMEOUT", "MAX_MSG", "send_msg", "recv_msg", "get_host_ip",
           "CollRelay", "RabitTracker", "TrackerClient"]

# bound on one handshake or control send or receive (reference :65); the
# watchers, which wait on purpose, pass timeout=None
OP_TIMEOUT = 300.0

# bound on one relay gather's send, wait and receive, which a rank spends
# waiting for its slowest peer; the gloo group's timeout too
# (collective._TIMEOUT)
COLL_TIMEOUT = 600.0

# bound on one control message: a damaged length prefix must be a
# connection fault, not a 4 GiB allocation (reference :95)
MAX_MSG = 1 << 26

_ELASTIC = "ROADMAP Queue 1 item 9b.3"
_RELIABILITY = "ROADMAP Queue 1 item 11"

# worker messages of the reference's elastic and reliability layers, which
# this tracker does not serve: each ends the job with an error naming its
# item
_UNSERVED = {"regroup_join": _ELASTIC, "telemetry": _RELIABILITY,
             "readopt": _RELIABILITY}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to xgboost_tpu_torch yet ({item})")


@contextlib.contextmanager
def _op_timeout(sock: socket.socket, timeout: Optional[float]):
    """Bound one socket operation, then restore the socket's mode."""
    if timeout is None:
        yield
        return
    prev = sock.gettimeout()
    sock.settimeout(timeout)
    try:
        yield
    finally:
        try:
            sock.settimeout(prev)
        except OSError:
            pass  # the peer closed the socket meanwhile


def _crc32(data) -> int:
    return zlib.crc32(data)


def send_msg(sock: socket.socket, obj: dict,
             timeout: Optional[float] = None, *,
             trailing: bytes = b"") -> None:
    """One framed JSON message, then ``trailing`` raw bytes (a relay
    payload) after it."""
    payload = json.dumps(obj).encode()
    frame = struct.pack(">II", len(payload), _crc32(payload)) + payload
    with _op_timeout(sock, timeout):
        sock.sendall(frame)
        if trailing:
            sock.sendall(trailing)


def recv_msg(sock: socket.socket,
             timeout: Optional[float] = None) -> Optional[dict]:
    """One framed JSON message; None on a clean EOF.  ``timeout`` bounds
    each receive and, from the first byte on, the whole message: a peer
    that trickles bytes spends one budget, not one a byte.  A CRC
    mismatch or an insane length raises ``ConnectionError``."""
    deadline: Optional[float] = None
    with _op_timeout(sock, timeout):
        hdr = b""
        while len(hdr) < 8:
            chunk = sock.recv(8 - len(hdr))
            if not chunk:
                return None
            if deadline is None and timeout is not None:
                deadline = time.monotonic() + timeout
            hdr += chunk
            if (deadline is not None and len(hdr) < 8
                    and time.monotonic() >= deadline):
                raise ConnectionError(
                    "tracker message header exceeded its deadline")
        n, crc = struct.unpack(">II", hdr)
        if n > MAX_MSG:
            raise ConnectionError(
                f"tracker message length {n} exceeds the {MAX_MSG} bound "
                "(a damaged length prefix?)")
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
            if (deadline is not None and len(buf) < n
                    and time.monotonic() >= deadline):
                raise ConnectionError(
                    f"tracker message body exceeded its deadline with "
                    f"{n - len(buf)} of {n} bytes outstanding")
    if _crc32(buf) != crc:
        raise ConnectionError(
            f"tracker message CRC mismatch ({n} bytes): damaged in transit")
    return json.loads(buf.decode())


def _recv_exact(sock: socket.socket, n: int,
                timeout: Optional[float] = None) -> bytes:
    """Exactly ``n`` raw bytes, or OSError / ConnectionError (EOF)."""
    with _op_timeout(sock, timeout):
        chunks, got = [], 0
        while got < n:
            chunk = sock.recv(min(n - got, 1 << 20))
            if not chunk:
                raise ConnectionError("peer closed mid-payload")
            chunks.append(chunk)
            got += len(chunk)
    return b"".join(chunks)


def get_host_ip(host_ip: str = "auto") -> str:
    """``host_ip`` itself, or for "auto" the address of the interface a
    route leaves by (no packet is sent), else 127.0.0.1."""
    if host_ip and host_ip != "auto":
        return host_ip
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    except OSError:
        return "127.0.0.1"
    try:
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
    except OSError:
        ip = "127.0.0.1"
    finally:
        s.close()
    return ip


class CollRelay:
    """Rank-ordered allgather through the tracker's process, over plain
    sockets (reference :294, without its elastic epochs).

    Each worker sends ``(seq, payload)``; once all ``world`` contributions
    of a seq have arrived, their rank-ordered concatenation goes back to
    every worker.  Every worker numbers its gathers alike, so a seq is one
    collective.  A worker that closes its connection while a gather it
    has not fed is pending fails that gather for every rank
    (``coll_error``, and ``on_worker_lost`` aborts the job on the main
    channel); a worker that leaves with nothing pending is a clean
    departure.  Every send and receive is bounded by ``op_timeout``."""

    def __init__(self, host_ip: str, world: int,
                 op_timeout: float = COLL_TIMEOUT) -> None:
        self.world = world
        self.op_timeout = op_timeout
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host_ip, 0))
        self.port = self._listener.getsockname()[1]
        self._cond = threading.Condition(threading.Lock())
        self._pending: Dict[int, Dict[int, bytes]] = {}  # seq -> rank -> buf
        self._results: Dict[int, Tuple[bytes, int]] = {}  # seq -> (buf, refs)
        self._departed: set = set()
        self._failed: Optional[str] = None
        self._closing = False
        self.on_worker_lost = None  # callback(rank, msg): the abort fan-out

    def start(self) -> None:
        self._listener.listen(self.world)
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # closed
            try:
                conn.settimeout(30.0)
                msg = recv_msg(conn)
                conn.settimeout(None)
            except (OSError, ValueError):
                conn.close()
                continue
            if not msg or msg.get("cmd") != "coll_join":
                conn.close()
                continue
            if int(msg.get("epoch", 0)) != 0:
                # a worker of an elastic tracker's later epoch
                try:
                    send_msg(conn, {"cmd": "coll_error", "msg": str(
                        _not_ported("the relay's elastic epochs",
                                    _ELASTIC))}, timeout=30.0)
                except OSError:
                    pass
                conn.close()
                continue
            threading.Thread(target=self._serve_worker,
                             args=(conn, int(msg["rank"])),
                             daemon=True).start()

    def _fail(self, msg: str, lost_rank: Optional[int] = None) -> None:
        with self._cond:
            if self._failed is not None or self._closing:
                return
            self._failed = msg
            self._cond.notify_all()
        if lost_rank is not None and self.on_worker_lost is not None:
            self.on_worker_lost(lost_rank, msg)

    def _serve_worker(self, conn: socket.socket, rank: int) -> None:
        try:
            while True:
                try:
                    hdr = recv_msg(conn)
                except OSError:
                    hdr = None
                if hdr is None or hdr.get("cmd") != "coll":
                    break
                seq = int(hdr["seq"])
                buf = _recv_exact(conn, int(hdr["nbytes"]),
                                  timeout=self.op_timeout)
                if hdr.get("crc") is not None and _crc32(buf) != hdr["crc"]:
                    # a damaged contribution never joins a gather: the
                    # worker is dropped, as a lost one is
                    break
                result = self._contribute(seq, rank, buf)
                if result is None:
                    send_msg(conn, {"cmd": "coll_error",
                                    "msg": self._failed or "relay failed"},
                             timeout=30.0)
                    break
                send_msg(conn, {"cmd": "coll_result", "seq": seq,
                                "nbytes": len(result),
                                "crc": _crc32(result)},
                         timeout=self.op_timeout, trailing=result)
        except OSError:
            pass
        finally:
            with self._cond:
                self._departed.add(rank)
                # only a gather still missing this rank's payload is lost;
                # one it fed can complete for the others
                incomplete = (not self._closing
                              and any(rank not in contribs
                                      for contribs in self._pending.values()))
                self._cond.notify_all()
            if incomplete:
                self._fail(f"collective peer {rank} lost mid-gather",
                           lost_rank=rank)
            conn.close()

    def _contribute(self, seq: int, rank: int,
                    buf: bytes) -> Optional[bytes]:
        """Add ``rank``'s payload and wait for the gather: the rank-ordered
        concatenation, or None on a failure or the timeout."""
        deadline = time.monotonic() + self.op_timeout
        with self._cond:
            self._pending.setdefault(seq, {})[rank] = buf
            while True:
                if self._failed is not None or self._closing:
                    return None
                got = self._pending.get(seq)
                if got is not None and len(got) == self.world:
                    del self._pending[seq]
                    self._results[seq] = (
                        b"".join(got[r] for r in range(self.world)),
                        self.world)
                    self._cond.notify_all()
                if seq in self._results:
                    payload, refs = self._results[seq]
                    if refs <= 1:
                        del self._results[seq]
                    else:
                        self._results[seq] = (payload, refs - 1)
                    return payload
                lost = (None if got is None else
                        min((d for d in self._departed if d not in got),
                            default=None))
                if lost is not None:
                    break  # a missing contributor is gone
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(timeout=min(left, 5.0))
        # the lost rank goes with the failure, whichever thread reports it
        # first: the tracker's abort fan-out must not depend on the race
        self._fail(f"collective seq {seq} incomplete "
                   f"(departed={sorted(self._departed)})", lost_rank=lost)
        return None

    def close(self) -> None:
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        try:
            self._listener.close()
        except OSError:
            pass


class RabitTracker:
    """Socket rendezvous and error fan-out (reference :632; the surface of
    python-package/xgboost/tracker.py: ``start``, ``worker_args``,
    ``wait_for``, ``free``), without elastic membership or a journal."""

    def __init__(self, n_workers: int, host_ip: str = "auto", port: int = 0,
                 sortby: str = "host", timeout: int = 0,
                 handshake_timeout: float = OP_TIMEOUT,
                 elastic: bool = False,
                 journal: Optional[str] = None) -> None:
        if elastic:
            raise _not_ported("the elastic tracker (elastic=True)", _ELASTIC)
        if journal:
            raise _not_ported("the tracker's journal and failover "
                              "(journal=)", _RELIABILITY)
        self.n_workers = n_workers
        self.host_ip = get_host_ip(host_ip)
        self.sortby = sortby
        self.timeout = timeout
        self.handshake_timeout = handshake_timeout
        self._closing = False
        self._relay = CollRelay(self.host_ip, n_workers)
        self._relay.on_worker_lost = self._relay_worker_lost
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host_ip, port))
        self.port = self._listener.getsockname()[1]
        self._conns: List[socket.socket] = []
        self._done = threading.Event()
        self._error: Optional[str] = None
        self._lock = threading.Lock()
        self._tx: Dict[int, threading.Lock] = {}  # id(conn) -> send lock
        self._watched: set = set()
        self._serve_done = False
        self._clean_exits = 0

    def start(self) -> None:
        self._listener.listen(self.n_workers)
        self._relay.start()
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self) -> None:
        pending = []  # (sort key, arrival, conn)
        arrival = 0
        try:
            while len(pending) < self.n_workers:
                conn, _addr = self._listener.accept()
                # a stray connection (a port scan, a probe) takes no slot
                # and cannot block the accept loop
                conn.settimeout(30.0)
                try:
                    msg = recv_msg(conn)
                except (OSError, ValueError):
                    msg = None
                if not msg or msg.get("cmd") != "start":
                    conn.close()
                    continue
                conn.settimeout(None)
                key = (str(msg.get("task_id", "")) if self.sortby == "task"
                       else str(msg.get("host", "")))
                pending.append((key, arrival, conn))
                arrival += 1
        except OSError:
            return  # freed while accepting
        pending.sort(key=lambda t: (t[0], t[1]))
        with self._lock:
            # published under the lock: _fan_abort reads it from the
            # watchers' threads
            self._conns = [c for (_k, _a, c) in pending]
        # two-phase bootstrap: rank 0 binds the coordinator address on its
        # own host and reports it before the other ranks are released
        r0 = self._conns[0]
        try:
            send_msg(r0, self._assignment(0, None),
                     timeout=self.handshake_timeout)
            reply = recv_msg(r0, timeout=self.handshake_timeout)
        except OSError:
            reply = None
        if not reply or reply.get("cmd") != "coordinator":
            with self._lock:
                if self._error is None:
                    self._error = ("worker 0: coordinator handshake failed "
                                   "or timed out")
            for c in self._conns:
                c.close()
            self._done.set()
            return
        coordinator = str(reply["addr"])
        for rank, conn in enumerate(self._conns[1:], start=1):
            try:
                send_msg(conn, self._assignment(rank, coordinator),
                         timeout=self.handshake_timeout)
            except OSError:
                pass  # its watcher sees the EOF
        with self._lock:
            self._watched = set(self._conns)
            self._serve_done = True
        for rank, conn in enumerate(self._conns):
            threading.Thread(target=self._watch_worker, args=(conn, rank),
                             daemon=True).start()

    def _assignment(self, rank: int, coordinator: Optional[str]) -> dict:
        return {"rank": rank, "world": self.n_workers,
                "coordinator": coordinator, "coll_port": self._relay.port,
                "failover": False, "elastic": False}

    def _send_ctl(self, conn: socket.socket, payload: dict, *,
                  timeout: float) -> None:
        """A control message, one sender a connection at a time, the state
        lock not held across the send."""
        with self._lock:
            lk = self._tx.setdefault(id(conn), threading.Lock())
        with lk:
            send_msg(conn, payload, timeout=timeout)

    def _fan_abort(self, rank: int, msg: str,
                   source: Optional[socket.socket]) -> None:
        """The first failure wins: record it, and abort every other
        worker (tracker.cc:345; their watchers exit)."""
        targets: List[socket.socket] = []
        err = ""
        with self._lock:
            if self._error is None:
                self._error = err = f"worker {rank}: {msg}"
                targets = [c for c in self._conns if c is not source]
        for other in targets:
            try:
                self._send_ctl(other, {"cmd": "abort", "msg": err},
                               timeout=30.0)
            except OSError:
                pass
        self._done.set()

    def _relay_worker_lost(self, rank: int, msg: str) -> None:
        self._fan_abort(rank, msg, None)

    def _watch_worker(self, conn: socket.socket, rank: int) -> None:
        clean = False
        while True:
            try:
                msg = recv_msg(conn)
            except OSError:
                msg = None
            if msg is None:
                break
            cmd = msg.get("cmd")
            if cmd == "shutdown":
                clean = True
                break
            if cmd == "error":
                self._fan_abort(rank, msg.get("msg", "unknown error"), conn)
                break
            if cmd in _UNSERVED:
                self._fan_abort(rank, str(_not_ported(
                    f"the tracker's {cmd!r} message", _UNSERVED[cmd])), conn)
                break
        if clean:
            with self._lock:
                self._clean_exits += 1
        elif not self._closing and self._error is None:
            # EOF without a shutdown: the worker died before it could
            # signal; its peers may wait on it in a collective
            self._fan_abort(rank, "tracker connection lost (worker process "
                            "died)", conn)
        with self._lock:
            self._watched.discard(conn)
            finished = self._serve_done and not self._watched
            if finished and self._clean_exits == 0 and self._error is None:
                self._error = "all workers lost (no clean shutdowns)"
        if finished:
            self._done.set()

    @property
    def rendezvous_complete(self) -> bool:
        """True once every worker of the cohort has its rank."""
        with self._lock:
            return self._serve_done

    def worker_args(self) -> Dict[str, Union[str, int]]:
        """The arguments of ``collective.init`` in tracker mode: no rank,
        the tracker hands one out."""
        return {"dmlc_tracker_uri": self.host_ip,
                "dmlc_tracker_port": self.port,
                "dmlc_nworker": self.n_workers}

    def wait_for(self, timeout: int = 0) -> None:
        """Block until every worker has shut down or one failed; raises
        ``RuntimeError`` with the first failure, ``TimeoutError`` past
        ``timeout`` seconds (0: the tracker's own, 0 for none)."""
        if not self._done.wait(timeout or self.timeout or None):
            raise TimeoutError("tracker wait_for timed out")
        if self._error is not None:
            raise RuntimeError(f"tracker: training failed — {self._error}")

    def free(self) -> None:
        with self._lock:
            self._closing = True  # the watchers' EOFs from here on are ours
        self._relay.close()
        try:
            self._listener.close()
        except OSError:
            pass
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self._done.set()


def _connect(host: str, port: int, timeout: float, retries: int,
             seed: int) -> socket.socket:
    """``socket.create_connection`` with up to ``retries`` attempts, a
    jittered exponential backoff between them (0.25 s doubling to 10 s):
    workers that race the tracker's ``start`` connect in the end."""
    rng = random.Random(seed)
    delay = 0.25
    for _ in range(max(retries, 1) - 1):
        try:
            return socket.create_connection((host, int(port)),
                                            timeout=timeout)
        except OSError:
            time.sleep(delay * (0.5 + rng.random()))
            delay = min(delay * 2, 10.0)
    try:
        return socket.create_connection((host, int(port)), timeout=timeout)
    except OSError as e:
        raise ConnectionError(f"cannot reach {host}:{port}: {e}") from e


class TrackerClient:
    """A worker's tracker connection: the rendezvous, then a daemon
    watcher on the error channel (the comm.cc:340-376 watcher), and the
    relay's collectives.  No reconnect, rejoin or regroup."""

    def __init__(self, host: str, port: int, timeout: float = 120.0,
                 retries: int = 5, task_id: str = "",
                 handshake_timeout: float = OP_TIMEOUT) -> None:
        self._sock = _connect(host, port, timeout, retries, os.getpid())
        try:
            # the handshake is bounded: a tracker that accepts and stalls
            # is a ConnectionError here, not a hang
            self._sock.settimeout(handshake_timeout)
            send_msg(self._sock, {"cmd": "start",
                                  "host": socket.gethostname(),
                                  "task_id": task_id})
            try:
                reply = recv_msg(self._sock)
            except OSError as e:
                raise ConnectionError(
                    f"tracker handshake failed or timed out: {e}") from e
            if not reply or "rank" not in reply:
                raise ConnectionError("tracker rejected the start handshake")
            if reply.get("elastic"):
                raise _not_ported("joining an elastic tracker", _ELASTIC)
            if reply.get("failover"):
                raise _not_ported("joining a tracker with failover",
                                  _RELIABILITY)
            self.rank = int(reply["rank"])
            self.world = int(reply["world"])
            self.coll_port = reply.get("coll_port")
            if reply.get("coordinator") is None:
                self.coordinator = self._report_coordinator()
            else:
                self.coordinator = str(reply["coordinator"])
        except BaseException:
            self._sock.close()
            raise
        self._coll_host = host
        self.op_timeout = COLL_TIMEOUT
        self._coll: Optional[socket.socket] = None
        self._coll_seq = 0
        self._coll_lock = threading.Lock()
        # the handshake is done: the connection is the error channel now,
        # and the watcher blocks on it for good
        self._sock.settimeout(None)
        self._watcher = threading.Thread(target=self._watch, daemon=True)
        self._watcher.start()

    def _report_coordinator(self) -> str:
        """Rank 0: take a free port for the coordinator on the address
        this host reaches the tracker from, and report it.  The port is
        closed again before the process group's store binds it, so another
        process may take it in between (the reference accepts the same
        race); a failed bind here raises."""
        my_ip = self._sock.getsockname()[0]
        try:
            with socket.socket() as s:
                s.bind((my_ip, 0))
                addr = f"{my_ip}:{s.getsockname()[1]}"
        except OSError as e:
            raise ConnectionError(
                f"rank 0 could not bind a coordinator port on {my_ip}: "
                f"{e}") from e
        send_msg(self._sock, {"cmd": "coordinator", "addr": addr})
        return addr

    def _watch(self) -> None:
        while True:
            try:
                msg = recv_msg(self._sock)
            except socket.timeout:
                # a timed send on the shared socket (signal_error) set its
                # timeout while this receive waited: not a failure
                continue
            except OSError:
                msg = None
            if msg is None:
                return  # our shutdown, or the tracker is gone
            if msg.get("cmd") == "abort":
                print(f"[rank {self.rank}] aborting: peer failure — "
                      f"{msg.get('msg', '')}", file=sys.stderr, flush=True)
                os._exit(255)  # the reference's std::exit(-1) in the watcher

    def _coll_sock(self) -> socket.socket:
        if self._coll is None:
            if self.coll_port is None:
                raise RuntimeError("the tracker offers no collective relay")
            self._coll = _connect(self._coll_host, int(self.coll_port), 60.0,
                                  5, self.rank)
            send_msg(self._coll, {"cmd": "coll_join", "rank": self.rank,
                                  "epoch": 0}, timeout=30.0)
        return self._coll

    def coll_allgather(self, arr) -> np.ndarray:
        """Rank-ordered allgather over the tracker's relay:
        ``(world, *arr.shape)``."""
        arr = np.ascontiguousarray(arr)
        payload = arr.tobytes()
        with self._coll_lock:
            s = self._coll_sock()
            seq = self._coll_seq
            self._coll_seq += 1
            try:
                send_msg(s, {"cmd": "coll", "seq": seq,
                             "nbytes": len(payload),
                             "crc": _crc32(payload)},
                         timeout=self.op_timeout, trailing=payload)
                hdr = recv_msg(s, timeout=self.op_timeout)
                if not hdr or hdr.get("cmd") != "coll_result":
                    raise RuntimeError(
                        "collective relay failed: "
                        f"{(hdr or {}).get('msg', 'connection lost')}")
                buf = _recv_exact(s, int(hdr["nbytes"]),
                                  timeout=self.op_timeout)
                if hdr.get("crc") is not None and _crc32(buf) != hdr["crc"]:
                    raise ConnectionError(
                        f"relay gather seq {seq} CRC mismatch: damaged "
                        "payload")
            except OSError as e:
                raise RuntimeError(
                    f"collective relay I/O failed (peer or tracker lost?): "
                    f"{e}") from e
        return np.frombuffer(buf, arr.dtype).reshape(
            (self.world,) + arr.shape).copy()

    def regroup(self, completed_round: int, timeout=None) -> dict:
        raise _not_ported("the elastic regroup", _ELASTIC)

    def ship_telemetry(self, payload: dict) -> bool:
        raise _not_ported("telemetry shipping", _RELIABILITY)

    def signal_error(self, msg: str) -> None:
        """Report a failure; the tracker aborts every other worker.
        Bounded: a dying worker does not wait on a wedged tracker."""
        try:
            send_msg(self._sock, {"cmd": "error", "msg": msg}, timeout=30.0)
        except OSError:
            pass

    def shutdown(self) -> None:
        with self._coll_lock:
            if self._coll is not None:
                try:
                    self._coll.close()
                except OSError:
                    pass
                self._coll = None
        try:
            send_msg(self._sock, {"cmd": "shutdown"}, timeout=30.0)
            self._sock.close()
        except OSError:
            pass
