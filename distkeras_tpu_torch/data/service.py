"""Fault-tolerant streaming data service (port of
``distkeras_tpu/data/service.py``, DESIGN.md §20).

Host code only: nothing here touches a device. Spark fed dist-keras's
executors their partitions; here a coordinator leases row ranges to
worker threads over the repo's one socket framing
(:func:`~distkeras_tpu_torch.parallel.remote_ps.send_message`,
``[u32 header_len][JSON header][blobs...]`` with the shared-token check),
and every op, reply and blob is the JAX package's, so a client of either
package drains a coordinator of the other.

- The :class:`DataCoordinator` cuts the global row space ``[0, total_rows)``
  into fixed-size ranges (the LAST range is smaller: unequal shards are
  native, no divisibility constraint) and serves them to workers in a
  **deterministic, seeded, per-epoch permuted order**. A range's position
  in that permuted order is its ``stream_pos``: the global-stream order key
  that is independent of which worker ends up serving it, so resharding
  (1->N->M workers) never reorders the global stream.
- Workers hold **leases** (:mod:`~distkeras_tpu_torch.health.membership`,
  the elastic PS fleet's machinery). Every ``data_lease``/``data_ack``
  renews; a worker that stops calling (killed, preempted, partitioned)
  lapses, and the lazy sweep re-queues its unacknowledged ranges for the
  survivors.
- **Exactly-once range retirement**: acks carry ``(cid, seq)`` like PS
  commits; a retried ack (applied server-side, reply lost) replays the
  cached reply instead of double-retiring, and retirement itself is
  idempotent. A worker that *lands* a range's batches but dies before
  acking causes that range to replay on a survivor: the service
  guarantees each range is RETIRED exactly once.
- The **shuffle cursor** ``[epoch, watermark]`` (watermark = length of the
  contiguous retired prefix of the permuted order) is a fixed-shape int64
  array that rides a trainer's snapshots; restoring it on a fresh
  coordinator resumes the stream bitwise-deterministically: the remaining
  stream is exactly ``perm[watermark:]`` of the same seeded permutation.
- **Streaming admission**: a coordinator constructed with a (lazily
  file-backed) :class:`~distkeras_tpu_torch.data.dataset.Dataset` serves
  row ranges as npy blobs through ``data_fetch``, so workers never need
  the files or the RAM for the whole epoch.

Chaos sites (:mod:`~distkeras_tpu_torch.utils.fault`): ``data.lease``
meters the server-side dispatch (delay / reset / kill: the
torn-coordinator drill) and ``data.fetch`` the client request egress
(drop / delay / reset / reset_after_send: the ack-dedup drill).
"""

from __future__ import annotations

import io
import os
import socket
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from distkeras_tpu_torch import comms, telemetry
from distkeras_tpu_torch.health import recorder as flight_recorder
from distkeras_tpu_torch.health.endpoints import (HEALTH_OPS,
                                                  handle_health_op)
from distkeras_tpu_torch.health.membership import DEFAULT_LEASE_S, Membership
from distkeras_tpu_torch.parallel.remote_ps import (check_token,
                                                    recv_message,
                                                    send_message)
from distkeras_tpu_torch.utils import fault, rng

_sendall = send_message
_recv = recv_message


class DataServiceUnavailable(RuntimeError):
    """The data coordinator could not be reached within the retry budget —
    the typed signal (mirroring ``PSUnavailable``) streaming consumers key
    on instead of crashing on a bare socket error."""


def _encode_columns(cols: Dict[str, np.ndarray]) -> Tuple[list, list]:
    """(names, blobs): each column as one self-describing .npy blob
    (dtype + shape travel in the npy header, so heterogeneous columns
    round-trip without a side-channel schema)."""
    names, blobs = [], []
    for name, arr in cols.items():
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
        names.append(name)
        blobs.append(buf.getvalue())
    return names, blobs


def _decode_columns(names: Sequence[str],
                    blobs: Sequence[bytes]) -> Dict[str, np.ndarray]:
    return {name: np.load(io.BytesIO(blob), allow_pickle=False)
            for name, blob in zip(names, blobs)}


class DataCoordinator:
    """Socket front-end leasing permuted row ranges to streaming workers.

    ``total_rows`` may be given directly (workers hold the data and only
    need the *order*: local-slice mode) or implied by ``dataset=`` (the
    coordinator additionally serves the bytes via ``data_fetch`` —
    streaming admission). ``range_size`` is in rows; the last range keeps
    the remainder, so any ``(total_rows, range_size, worker count)``
    combination is legal — the typed :class:`~distkeras_tpu_torch.data.
    global_shards.ShardingError` constraint of the legacy path does not
    exist here.

    The epoch stream is ``permutation(seed * 1_000_003 + epoch,
    num_ranges)`` (the GlobalShards seeding idiom, so the two paths are
    comparable): position ``p`` of the stream is range
    ``perm[p]``. Leases hand out positions in ascending stream order,
    re-queued (lapsed) positions first — deterministic given the op
    sequence. The durable cursor is ``[epoch, watermark]``; see the module
    docstring for its exactness contract.

    Thread-safe: one handler thread per connection mutates the ledger
    under one lock; no blocking call runs under it.
    """

    #: bounded per-client replay window for (cid, seq) lease/ack dedup —
    #: same rationale and bound as the PS commit dedup cache.
    DEDUP_CACHE = 128

    def __init__(self, total_rows: Optional[int] = None,
                 range_size: int = 1024,
                 seed: int = 0, num_epochs: int = 1,
                 dataset=None,
                 host: str = "0.0.0.0", port: int = 0,
                 token: Optional[str] = None,
                 lease_s: float = DEFAULT_LEASE_S,
                 time_fn: Callable[[], float] = time.time):
        if dataset is not None:
            n = len(dataset)
            if total_rows is not None and int(total_rows) != n:
                raise ValueError(
                    f"total_rows={total_rows} disagrees with the dataset's "
                    f"{n} rows; pass one or the other")
            total_rows = n
        if total_rows is None:
            raise ValueError("DataCoordinator needs total_rows= or dataset=")
        if total_rows <= 0:
            raise ValueError(f"total_rows must be > 0, got {total_rows}")
        if range_size <= 0:
            raise ValueError(f"range_size must be > 0, got {range_size}")
        if num_epochs <= 0:
            raise ValueError(f"num_epochs must be > 0, got {num_epochs}")
        self.total_rows = int(total_rows)
        self.range_size = int(range_size)
        self.num_ranges = -(-self.total_rows // self.range_size)
        self.seed = int(seed)
        self.num_epochs = int(num_epochs)
        self.dataset = dataset
        self.token = token
        self.membership = Membership(lease_s=lease_s, time_fn=time_fn)
        self._lock = threading.Lock()
        # -- epoch ledger (all under self._lock) ---------------------------
        self._epoch = 0
        self._perm = self._epoch_perm(0)
        self._next_pos = 0            # next never-dispatched stream position
        self._pending: List[int] = []  # re-queued positions, kept sorted
        self._outstanding: Dict[int, int] = {}      # pos -> worker
        self._worker_pos: Dict[int, set] = {}       # worker -> {pos}
        self._retired = np.zeros(self.num_ranges, bool)  # by stream pos
        self._watermark = 0
        self._releases = 0
        self._exhausted = self.num_epochs == 0
        self._dedup: dict = {}  # cid -> OrderedDict(seq -> reply header)
        self._dedup_lock = threading.Lock()
        # -- socket plumbing (the remote_ps service shape) -----------------
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self.address = f"127.0.0.1:{self.port}"
        self._running = False
        self._threads: list = []
        self._conns: set = set()
        self._conn_lock = threading.Lock()
        telemetry.gauge("data.service.ranges").set(self.num_ranges)
        self._publish_gauges_locked()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def stop(self) -> None:
        self._running = False
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def kill(self, reason: str = "chaos") -> None:
        """Simulate coordinator PROCESS DEATH (the chaos ``kill`` action):
        the listener and every live connection die instantly; in-flight
        requests get no reply. The torn-restart drill then constructs a
        FRESH coordinator and :meth:`restore_cursor`\\ s the checkpointed
        cursor — the remaining stream must be bitwise-identical to the
        uninterrupted run's suffix."""
        if not self._running:
            return
        telemetry.record_event("data_service", transition="killed",
                               reason=reason, epoch=int(self._epoch),
                               watermark=int(self._watermark))
        self.stop()
        with self._conn_lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        flight_recorder.auto_dump("data_coordinator_killed")

    def __enter__(self) -> "DataCoordinator":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- deterministic shuffle state --------------------------------------
    def _epoch_perm(self, epoch: int) -> np.ndarray:
        # the GlobalShards seeding idiom: every party (and every restart)
        # derives the same permutation from (seed, epoch) alone
        return rng.permutation(self.seed * 1_000_003 + epoch,
                               self.num_ranges)

    def _range_bounds(self, range_idx: int) -> Tuple[int, int]:
        start = range_idx * self.range_size
        return start, min(start + self.range_size, self.total_rows)

    def epoch_stream(self, epoch: int) -> List[Tuple[int, int, int]]:
        """The canonical global stream for one epoch:
        ``[(stream_pos, row_start, row_stop), ...]`` in stream order. Pure
        and communication-free — tests and consumers use it as the
        reference order that leasing (under any worker count or churn)
        must reproduce."""
        perm = self._epoch_perm(epoch)
        return [(p, *self._range_bounds(int(perm[p])))
                for p in range(self.num_ranges)]

    def cursor_carry(self) -> np.ndarray:
        """The durable shuffle cursor as a fixed-shape int64 array
        ``[epoch, watermark]`` — the leaf a trainer writes beside the
        center in every snapshot (``data_cursor``, DESIGN.md §20)."""
        with self._lock:
            if self._exhausted:
                return np.array([self.num_epochs, self.num_ranges],
                                np.int64)
            return np.array([self._epoch, self._watermark], np.int64)

    def restore_cursor(self, carry) -> None:
        """Resume from a :meth:`cursor_carry` snapshot: positions before
        the watermark are retired, everything after re-dispatches in the
        seeded permutation's order. Ranges consumed-but-unacked at crash
        time replay (the honest at-least-once window across coordinator
        crashes, DESIGN.md §20); the ORDER of the remaining stream is
        bitwise-deterministic."""
        arr = np.asarray(carry, np.int64).reshape(-1)
        if arr.size != 2:
            raise ValueError(
                f"cursor carry must be [epoch, watermark], got {arr!r}")
        epoch, watermark = int(arr[0]), int(arr[1])
        if not 0 <= watermark <= self.num_ranges:
            raise ValueError(
                f"watermark {watermark} outside [0, {self.num_ranges}]")
        with self._lock:
            if epoch >= self.num_epochs:
                self._epoch = self.num_epochs
                self._exhausted = True
            else:
                self._epoch = epoch
                self._exhausted = False
                self._perm = self._epoch_perm(epoch)
            self._pending = []
            self._outstanding = {}
            self._worker_pos = {}
            self._retired = np.zeros(self.num_ranges, bool)
            self._retired[:watermark] = True
            self._watermark = watermark
            self._next_pos = watermark
            self._publish_gauges_locked()
        telemetry.record_event("data_service", transition="restored",
                               epoch=epoch, watermark=watermark)

    # -- ledger (callers hold self._lock) ----------------------------------
    def _publish_gauges_locked(self) -> None:
        telemetry.gauge("data.service.cursor").set(self._watermark)
        telemetry.gauge("data.service.epoch").set(self._epoch)
        telemetry.gauge("data.service.leased_ranges").set(
            len(self._outstanding))

    def _requeue_worker_locked(self, worker: int, reason: str) -> int:
        poss = sorted(self._worker_pos.pop(worker, ()))
        for pos in poss:
            if not self._retired[pos]:
                self._outstanding.pop(pos, None)
                self._pending.append(pos)
        self._pending.sort()
        n = len(poss)
        if n:
            self._releases += n
            telemetry.counter("data.service.releases",
                              reason=reason).inc(n)
            telemetry.record_event("data_service", transition="release",
                                   worker=worker, reason=reason, ranges=n)
        return n

    def _sweep_locked(self) -> None:
        for worker in self.membership.sweep():
            self._requeue_worker_locked(worker, reason="lease")

    def _advance_epoch_locked(self) -> None:
        if self._epoch + 1 >= self.num_epochs:
            self._epoch = self.num_epochs
            self._exhausted = True
            telemetry.record_event("data_service", transition="exhausted")
        else:
            self._epoch += 1
            self._perm = self._epoch_perm(self._epoch)
            self._next_pos = 0
            self._pending = []
            self._outstanding = {}
            self._worker_pos = {}
            self._retired = np.zeros(self.num_ranges, bool)
            self._watermark = 0
            telemetry.record_event("data_service", transition="epoch",
                                   epoch=self._epoch)

    def _lease_locked(self, worker: int, max_ranges: int) -> dict:
        if self._exhausted:
            return {"ranges": [], "epoch": int(self._epoch),
                    "exhausted": True}
        granted: List[list] = []
        while len(granted) < max_ranges:
            if self._pending:
                pos = self._pending.pop(0)
            elif self._next_pos < self.num_ranges:
                pos, self._next_pos = self._next_pos, self._next_pos + 1
            else:
                break
            self._outstanding[pos] = worker
            self._worker_pos.setdefault(worker, set()).add(pos)
            start, stop = self._range_bounds(int(self._perm[pos]))
            granted.append([int(pos), start, stop])
        if granted:
            telemetry.counter("data.service.leases").inc(len(granted))
        self._publish_gauges_locked()
        reply = {"ranges": granted, "epoch": int(self._epoch),
                 "exhausted": False}
        if not granted:
            # nothing grantable but the epoch is not done: ranges are
            # outstanding on other workers — poll again (or inherit them
            # when their lease lapses)
            reply["wait"] = True
        return reply

    def _ack_locked(self, worker: int, epoch: int,
                    positions: Sequence[int]) -> dict:
        if epoch != self._epoch or self._exhausted:
            # an epoch the coordinator has moved past: every position in
            # it is already retired — idempotent no-op
            telemetry.counter("data.service.stale_acks").inc(len(positions))
            return {"retired": 0, "stale": len(positions),
                    "epoch": int(self._epoch)}
        retired = stale = 0
        for pos in positions:
            pos = int(pos)
            if not 0 <= pos < self.num_ranges:
                raise ValueError(f"ack position {pos} outside "
                                 f"[0, {self.num_ranges})")
            if self._retired[pos]:
                stale += 1  # double-ack (or a zombie after re-retire)
                continue
            owner = self._outstanding.pop(pos, None)
            if owner != worker:
                # re-leased away (the acker's lease lapsed) or never
                # dispatched: retire anyway — the bytes landed — but
                # account the anomaly
                stale += 1
                if owner is not None:
                    self._worker_pos.get(owner, set()).discard(pos)
                if pos in self._pending:
                    self._pending.remove(pos)
            else:
                self._worker_pos.get(worker, set()).discard(pos)
            self._retired[pos] = True
            retired += 1
        while (self._watermark < self.num_ranges
               and self._retired[self._watermark]):
            self._watermark += 1
        if retired:
            telemetry.counter("data.service.acks").inc(retired)
        if stale:
            telemetry.counter("data.service.stale_acks").inc(stale)
        epoch_done = bool(self._retired.all())
        if epoch_done:
            self._advance_epoch_locked()
        self._publish_gauges_locked()
        return {"retired": retired, "stale": stale,
                "epoch_done": epoch_done, "epoch": int(self._epoch)}

    # -- (cid, seq) replay cache (the PS commit-dedup shape) ---------------
    def _dedup_get(self, cid, seq) -> Optional[dict]:
        with self._dedup_lock:
            return self._dedup.get(cid, {}).get(seq)

    def _dedup_put(self, cid, seq, reply: dict) -> None:
        with self._dedup_lock:
            replies = self._dedup.setdefault(cid, OrderedDict())
            replies[seq] = reply
            while len(replies) > self.DEDUP_CACHE:
                replies.popitem(last=False)

    # -- introspection -----------------------------------------------------
    def status_digest(self) -> dict:
        """The compact DATA digest: merged into the health ``status`` op
        and the source of ``health.cli watch --table``'s DATA line."""
        with self._lock:
            return {
                "data": {
                    "epoch": int(self._epoch),
                    "cursor": int(self._watermark),
                    "ranges": int(self.num_ranges),
                    "leased": len(self._outstanding),
                    "pending": len(self._pending),
                    "releases": int(self._releases),
                    "exhausted": bool(self._exhausted),
                },
                "membership": self.membership.status(),
            }

    # -- per-connection handler -------------------------------------------
    def _serve(self, conn: socket.socket):
        with self._conn_lock:
            self._conns.add(conn)
        try:
            with conn:
                while True:
                    try:
                        header, blobs = _recv(conn)
                    except ConnectionError:
                        return
                    if not check_token(self.token, header):
                        telemetry.counter(
                            "data.service.server.auth_failures").inc()
                        _sendall(conn, {"error": "authentication failed"})
                        return
                    try:
                        self._dispatch(conn, header)
                    except ConnectionError:
                        return  # chaos reset / peer vanished; service lives
        except Exception:
            if self._running:
                raise
        finally:
            with self._conn_lock:
                self._conns.discard(conn)

    def _dispatch(self, conn, header: dict):
        op = header["op"]
        act = fault.chaos("data.lease")
        if act is not None:
            if act.action == "delay":
                time.sleep(act.delay_s)
            elif act.action == "kill":
                self.kill(reason="chaos")
                raise ConnectionError("chaos: data coordinator killed")
            else:  # either reset flavor: drop the connection, no reply
                conn.close()
                raise ConnectionError("chaos: server reset the connection")
        telemetry.counter("data.service.server.dispatch", op=op).inc()
        if op in HEALTH_OPS:
            _sendall(conn, handle_health_op(
                op, header, extra_status=self.status_digest()))
            return
        if op == "data_register":
            worker = int(header["worker"])
            lease = self.membership.register(worker)
            _sendall(conn, {"lease_s": lease,
                            "serves_data": self.dataset is not None,
                            "total_rows": self.total_rows,
                            "range_size": self.range_size,
                            "num_ranges": self.num_ranges,
                            "num_epochs": self.num_epochs})
        elif op == "data_lease":
            worker = int(header["worker"])
            cid, seq = header.get("cid"), header.get("seq")
            cached = None if cid is None else self._dedup_get(cid, seq)
            if cached is not None:
                telemetry.counter("data.service.dedup_hits").inc()
                _sendall(conn, cached)
                return
            # a lease request is proof of life: register renews (and
            # re-admits a lapsed worker — its old ranges were re-queued
            # by the sweep; it simply leases fresh ones)
            self.membership.register(worker)
            with self._lock:
                self._sweep_locked()
                reply = self._lease_locked(
                    worker, max(1, int(header.get("max_ranges", 1))))
            if cid is not None:
                self._dedup_put(cid, seq, reply)
            _sendall(conn, reply)
        elif op == "data_ack":
            worker = int(header["worker"])
            cid, seq = header.get("cid"), header.get("seq")
            cached = None if cid is None else self._dedup_get(cid, seq)
            if cached is not None:
                telemetry.counter("data.service.dedup_hits").inc()
                _sendall(conn, cached)
                return
            self.membership.register(worker)
            with self._lock:
                self._sweep_locked()
                reply = self._ack_locked(worker, int(header["epoch"]),
                                         header.get("positions", ()))
            if cid is not None:
                self._dedup_put(cid, seq, reply)
            _sendall(conn, reply)
        elif op == "data_fetch":
            if self.dataset is None:
                _sendall(conn, {
                    "error": "this coordinator was constructed without a "
                             "dataset; it leases order only — slice rows "
                             "locally",
                    "error_kind": "no_data"})
                return
            start, stop = int(header["start"]), int(header["stop"])
            if not 0 <= start <= stop <= self.total_rows:
                _sendall(conn, {
                    "error": f"range [{start}, {stop}) outside "
                             f"[0, {self.total_rows})",
                    "error_kind": "bad_range"})
                return
            cols = header.get("cols") or self.dataset.columns
            names, blobs = _encode_columns(
                {c: self.dataset[c][start:stop] for c in cols})
            telemetry.counter("data.service.fetch_rows").inc(stop - start)
            _sendall(conn, {"cols": names}, blobs)
        elif op == "data_cursor":
            carry = self.cursor_carry()
            with self._lock:
                digest = {
                    "cursor": [int(carry[0]), int(carry[1])],
                    "epoch": int(self._epoch),
                    "watermark": int(self._watermark),
                    "releases": int(self._releases),
                    "exhausted": bool(self._exhausted),
                }
            _sendall(conn, digest)
        elif op == "data_restore":
            try:
                self.restore_cursor(header["cursor"])
            except ValueError as e:
                _sendall(conn, {"error": str(e), "error_kind": "bad_cursor"})
                return
            _sendall(conn, {"ok": True})
        elif op == "data_deregister":
            worker = int(header["worker"])
            with self._lock:
                self._requeue_worker_locked(worker, reason="deregister")
                self._publish_gauges_locked()
            self.membership.deregister(worker)
            _sendall(conn, {"ok": True})
        else:
            _sendall(conn, {"error": f"unknown op {op!r}",
                            "error_kind": "unknown_op"})


class DataServiceClient:
    """One worker's connection to a :class:`DataCoordinator`.

    NOT thread-safe — the streaming contract is one client per worker
    thread (unlike the pipelined PS client, data ops are coarse enough
    that sharing a socket buys nothing). Reconnect + bounded exponential
    backoff ride every op; exhaustion raises the typed
    :class:`DataServiceUnavailable`. Mutating ops (lease/ack) carry
    ``(cid, seq)`` so a retried request that DID apply server-side replays
    the cached reply instead of re-executing.
    """

    def __init__(self, address: str, worker: int,
                 token: Optional[str] = None,
                 timeout: float = 30.0,
                 op_timeout: Optional[float] = 30.0,
                 retry: Optional[comms.RetryPolicy] = None):
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self.worker = int(worker)
        self.token = token
        self._timeout = timeout
        self._op_timeout = op_timeout
        self.retry = retry if retry is not None else comms.RetryPolicy()
        self._cid = os.urandom(8).hex()
        self._seq = 0
        self._sock: Optional[socket.socket] = None
        self._closed = False
        self.meta: dict = {}

    # -- transport ---------------------------------------------------------
    def _ensure_connected(self) -> socket.socket:
        if self._sock is None:
            if self._closed:
                raise DataServiceUnavailable(
                    f"client for {self._addr[0]}:{self._addr[1]} is closed")
            sock = socket.create_connection(self._addr,
                                            timeout=self._timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
            telemetry.counter("data.service.client.reconnects").inc()
        return self._sock

    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _send_once(self, header: dict) -> Tuple[dict, list]:
        sock = self._ensure_connected()
        act = fault.chaos("data.fetch")
        if act is not None:
            if act.action == "delay":
                time.sleep(act.delay_s)
            elif act.action == "reset":
                self._teardown()
                raise ConnectionError("chaos: connection reset before send")
        dropped = act is not None and act.action == "drop"
        if not dropped:
            _sendall(sock, header)
            if act is not None and act.action == "reset_after_send":
                # the request reached the wire: the server applies it and
                # replies into a closed socket — the (cid, seq) scenario
                self._teardown()
                raise ConnectionError("chaos: connection reset after send")
        else:
            # a swallowed request has no reply coming: ride out a bounded
            # wait, then declare the connection dead (what a real lost
            # frame amounts to on a serial request/reply socket)
            time.sleep(min(self._op_timeout or 1.0, 1.0))
            self._teardown()
            raise socket.timeout("chaos: request dropped")
        try:
            sock.settimeout(self._op_timeout)
            resp, blobs = _recv(sock)
        except (ConnectionError, socket.timeout, OSError):
            self._teardown()
            raise
        if "error" in resp:
            raise RuntimeError(
                f"data op {header.get('op')!r} against "
                f"{self._addr[0]}:{self._addr[1]}: {resp['error']}")
        return resp, blobs

    def _request(self, header: dict) -> Tuple[dict, list]:
        op = header.get("op", "?")
        if self.token is not None:
            header = {**header, "token": self.token}
        attempt = 0
        t0 = time.perf_counter()
        while True:
            try:
                resp, blobs = self._send_once(header)
                break
            except (ConnectionError, socket.timeout, OSError) as e:
                attempt += 1
                if self._closed or attempt > self.retry.max_retries:
                    telemetry.counter("data.service.client.unavailable",
                                      op=op).inc()
                    raise DataServiceUnavailable(
                        f"data coordinator {self._addr[0]}:{self._addr[1]} "
                        f"unavailable: {op} failed after "
                        f"{attempt - 1} retries ({e})") from e
                telemetry.counter("data.service.client.retries",
                                  op=op).inc()
                time.sleep(self.retry.delay(attempt))
        telemetry.histogram("data.service.client.rtt_s", op=op).record(
            time.perf_counter() - t0)
        return resp, blobs

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # -- protocol verbs ----------------------------------------------------
    def register(self) -> dict:
        resp, _ = self._request({"op": "data_register",
                                 "worker": self.worker})
        self.meta = resp
        return resp

    def lease(self, max_ranges: int = 1) -> dict:
        """One lease round-trip: ``{"ranges": [[pos, start, stop], ...],
        "epoch": e, "exhausted": bool, "wait": bool?}``."""
        resp, _ = self._request({"op": "data_lease", "worker": self.worker,
                                 "max_ranges": int(max_ranges),
                                 "cid": self._cid,
                                 "seq": self._next_seq()})
        return resp

    def ack(self, epoch: int, positions: Sequence[int]) -> dict:
        resp, _ = self._request({"op": "data_ack", "worker": self.worker,
                                 "epoch": int(epoch),
                                 "positions": [int(p) for p in positions],
                                 "cid": self._cid,
                                 "seq": self._next_seq()})
        return resp

    def fetch(self, start: int, stop: int,
              cols: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        header = {"op": "data_fetch", "start": int(start), "stop": int(stop)}
        if cols is not None:
            header["cols"] = list(cols)
        resp, blobs = self._request(header)
        return _decode_columns(resp["cols"], blobs)

    def cursor(self) -> dict:
        resp, _ = self._request({"op": "data_cursor"})
        return resp

    def restore(self, carry) -> None:
        self._request({"op": "data_restore",
                       "cursor": [int(v) for v in
                                  np.asarray(carry).reshape(-1)]})

    def deregister(self) -> None:
        self._request({"op": "data_deregister", "worker": self.worker})

    def close(self) -> None:
        self._closed = True
        self._teardown()

    def __enter__(self) -> "DataServiceClient":
        self.register()
        return self

    def __exit__(self, *exc) -> None:
        try:
            if self._sock is not None and not self._closed:
                self.deregister()
        except (RuntimeError, OSError):
            pass
        self.close()


def stream_ranges(client: DataServiceClient,
                  dataset=None,
                  cols: Optional[Sequence[str]] = None,
                  max_ranges: int = 1,
                  poll_s: float = 0.02,
                  sleep_fn: Callable[[float], None] = time.sleep):
    """Generator driving one worker's lease → materialize → ack loop.

    Yields ``(epoch, stream_pos, row_start, row_stop, columns_dict)`` per
    leased range, in this worker's lease order; the GLOBAL stream order is
    recovered by sorting on ``(epoch, stream_pos)`` — that key is assigned
    by the coordinator's seeded permutation, so it is identical whatever
    the worker count or churn. Rows come from ``dataset`` (local-slice
    mode) when given, else over the wire via ``data_fetch`` (streaming
    admission; requires a coordinator constructed with ``dataset=``).

    The ack for a range is sent AFTER its item is yielded and the consumer
    asks for the next one — i.e. after the consumer has landed the
    batches. A worker killed mid-range therefore loses nothing: its
    unacked ranges re-lease to survivors (DESIGN.md §20's loss-window
    statement covers the consumed-but-unacked corner).
    """
    if dataset is None and not client.meta.get("serves_data"):
        raise ValueError(
            "no local dataset and the coordinator does not serve bytes "
            "(constructed without dataset=); one side must hold the rows")
    while True:
        resp = client.lease(max_ranges=max_ranges)
        if resp.get("exhausted"):
            return
        ranges = resp.get("ranges", ())
        if not ranges:
            sleep_fn(poll_s)  # tail of an epoch: ranges outstanding
            continue          # elsewhere — poll (or inherit on lapse)
        epoch = int(resp["epoch"])
        done: List[int] = []
        try:
            for pos, start, stop in ranges:
                if dataset is not None:
                    want = list(cols) if cols is not None else None
                    rows = {c: np.asarray(dataset[c][start:stop])
                            for c in (want or dataset.columns)}
                else:
                    rows = client.fetch(start, stop, cols=cols)
                yield int(epoch), int(pos), int(start), int(stop), rows
                done.append(int(pos))
        finally:
            # landed ranges are acked even when the consumer abandons the
            # generator mid-lease; unyielded ones re-lease via lapse. An
            # unreachable (or closed) coordinator here is not an error:
            # failing to ack only widens the replay window — the safe
            # direction — and raising out of a GeneratorExit would turn
            # every abandon-during-outage into a crash.
            if done:
                try:
                    client.ack(epoch, done)
                except DataServiceUnavailable:
                    pass
