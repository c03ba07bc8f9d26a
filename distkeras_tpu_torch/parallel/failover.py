"""Coordinator failover: write-behind authority replication + lease handoff
(port of ``distkeras_tpu/parallel/failover.py``; the protocol and its
records are the JAX package's).

DESIGN.md §6 was honest that a shard-0 crash ends the run: the elastic
fleet (DESIGN.md §13) made follower shards disposable, but the
coordinator's AUTHORITY — its clock, the membership/lease table, the
commit-dedup window, the history barrier state, the fleet telemetry
collector — lived in exactly one process. This module replicates that
authority to a designated **standby** service so a coordinator death is
a lease handoff, not a checkpoint-restart (DESIGN.md §17):

- :class:`Replicator` runs ON the coordinator: every folded commit is
  forwarded to the standby as a ``repl_append`` record over the existing
  wire framing — carrying the RAW received blobs (zero re-encode) plus
  the fold's ``(at_fold, applied_weight)`` verdict — and a ``coord_lease``
  heartbeat at lease/3 cadence streams the clock + membership export.
  The log is write-BEHIND: the commit is acked to the worker first, the
  record ships asynchronously (a bounded queue + one background thread),
  so replication adds zero latency to the fold path.

- :class:`StandbyState` runs on the standby service: each commit record
  replays through :meth:`ParameterServer.replay` — the SAME fold
  at the SAME clock with the SAME float32 weight — so the replica center
  is bit-identical to the coordinator's after every applied record.
  Membership, histories, telemetry batches, and the dedup window mirror
  as plain state.

- **Promotion** is lazy and lease-driven, the same idiom as
  ``Membership.sweep``: there is no failure-detector thread — the first
  ``coordinator`` query after the coordinator's lease lapses finds the
  lapse and promotes right there (workers send that query from their
  reconnect path). Promotion is fenced by an **epoch number**: it bumps
  the epoch, a second promotion is rejected, and a deposed coordinator
  that comes back hears ``{"fenced": true, epoch}`` on its next
  heartbeat and stops serving coordinator ops (replying with a redirect
  instead) — split-brain cannot fold two divergent centers.

Loss window (documented, DESIGN.md §17): a commit the coordinator acked
but whose record had not yet shipped when it died is absent from the
replica — the standby's clock pins forward over the gap (``replay``
returns it; ``gaps`` counts it honestly) and follower shards are one
fold ahead of the replica for those records. Tests and the failover
probe close the window deterministically with :meth:`Replicator.flush`.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Callable, Optional

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.health.collector import TelemetryCollector
from distkeras_tpu_torch.health.heartbeat import StragglerDetector
from distkeras_tpu_torch.health.membership import DEFAULT_LEASE_S, Membership
from distkeras_tpu_torch.parallel import remote_ps

#: Default coordinator lease: the standby grants the coordinator this
#: long between heartbeats (sent at lease/3) before the next coordinator
#: query may promote. Shorter than the worker lease — a dead coordinator
#: must be replaced before worker leases start lapsing en masse.
DEFAULT_COORD_LEASE_S = 10.0


class Replicator:
    """The coordinator's write-behind log shipper (one per coordinator).

    Thread-safe producers (:meth:`record_commit` / :meth:`record_history`
    / :meth:`record_telemetry` are called from the service's handler
    threads) enqueue onto a bounded queue; one daemon thread drains it
    over a persistent socket to the standby, acking record-by-record.
    A full queue DROPS the record with a counter — replication must
    never backpressure the fold path (the standby's ``replay`` closes
    the resulting clock gap honestly).
    """

    #: queue bound: at ~1 record per commit this is minutes of slack at
    #: test rates and seconds at production rates — enough to ride out a
    #: standby GC pause, small enough that a dead standby cannot grow
    #: coordinator RAM.
    QUEUE_MAX = 512

    def __init__(self, standby_address: str, token: Optional[str] = None,
                 *, lease_s: float = DEFAULT_COORD_LEASE_S,
                 members_fn: Optional[Callable[[], dict]] = None,
                 clock_fn: Optional[Callable[[], int]] = None,
                 on_fenced: Optional[Callable[[int], None]] = None,
                 time_fn: Callable[[], float] = time.time,
                 timeout: float = 5.0):
        host, port = standby_address.rsplit(":", 1)
        self.standby_address = standby_address
        self._addr = (host, int(port))
        self.token = token
        self.lease_s = float(lease_s)
        self._members_fn = members_fn
        self._clock_fn = clock_fn
        self._on_fenced = on_fenced
        self._time = time_fn
        self._timeout = float(timeout)
        self.epoch = 0
        self.fenced = False
        self.fenced_epoch = 0
        self._q: queue.Queue = queue.Queue(maxsize=self.QUEUE_MAX)
        self._rseq = 0
        self._rseq_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self, timeout: float = 2.0) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(None)  # wake the drain loop immediately
        except queue.Full:
            pass
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._drop_sock()

    # -- producers (service handler threads) ------------------------------
    def _next_rseq(self) -> int:
        with self._rseq_lock:
            self._rseq += 1
            return self._rseq

    def record_commit(self, *, blobs, codec: str, at_fold: int,
                      weight: float, last_update: int,
                      cid: Optional[str], seq) -> None:
        """Ship one folded commit: the raw wire blobs as received, plus
        the coordinator's fold verdict — everything the standby needs to
        replay the identical fold and to answer a dedup'd retry."""
        header = {"op": "repl_append", "kind": "commit",
                  "rseq": self._next_rseq(), "codec": codec,
                  "at_fold": int(at_fold), "weight": float(weight),
                  "last_update": int(last_update)}
        if cid is not None and seq is not None:
            header["cid"], header["seq"] = cid, int(seq)
        self._enqueue(header, [bytes(b) for b in blobs])

    def record_history(self, pid: int, windows: list) -> None:
        self._enqueue({"op": "repl_append", "kind": "history",
                       "rseq": self._next_rseq(), "pid": int(pid),
                       "windows": windows})

    def record_telemetry(self, pid: int, rows: list) -> None:
        self._enqueue({"op": "repl_append", "kind": "telemetry",
                       "rseq": self._next_rseq(), "pid": int(pid),
                       "rows": list(rows)})

    def _enqueue(self, header: dict, blobs=()) -> None:
        if self._stop.is_set() or self.fenced:
            return  # a deposed coordinator stops streaming (DESIGN.md §17)
        try:
            self._q.put_nowait((header, list(blobs)))
        except queue.Full:
            telemetry.counter("elastic.failover.repl_dropped").inc()

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every record enqueued BEFORE this call is acked by
        the standby (plus one fresh heartbeat) — how tests and the
        failover probe close the write-behind loss window on demand."""
        done = threading.Event()
        try:
            self._q.put(("flush", done), timeout=timeout)
        except queue.Full:
            return False
        return done.wait(timeout)

    def heartbeat(self) -> None:
        """One synchronous ``coord_lease`` renewal, for deterministic
        tests (the drain loop sends these on its own at lease/3)."""
        self._heartbeat_once()

    # -- drain loop -------------------------------------------------------
    def _loop(self) -> None:
        interval = max(0.05, self.lease_s / 3.0)
        next_hb = time.monotonic()  # first tick heartbeats immediately
        while not self._stop.is_set():
            now = time.monotonic()
            if now >= next_hb:
                self._heartbeat_once()
                next_hb = now + interval
            try:
                item = self._q.get(timeout=max(0.01, next_hb -
                                               time.monotonic()))
            except queue.Empty:
                continue
            if item is None:
                break
            if item[0] == "flush":
                self._heartbeat_once()
                item[1].set()
                continue
            self._send_record(*item)

    def _send_record(self, header: dict, blobs) -> None:
        telemetry.gauge("elastic.failover.repl_lag").set(self._q.qsize())
        try:
            resp = self._rt(header, blobs)
        except (ConnectionError, socket.timeout, OSError, RuntimeError):
            # the record is LOST (the documented write-behind window);
            # the standby's replay pins its clock over the gap
            telemetry.counter("elastic.failover.repl_errors").inc()
            return
        if resp.get("fenced"):
            self._handle_fenced(resp)
        else:
            telemetry.counter("elastic.failover.repl_records").inc()

    def _heartbeat_once(self) -> None:
        header = {"op": "coord_lease", "epoch": self.epoch}
        if self._clock_fn is not None:
            header["clock"] = int(self._clock_fn())
        if self._members_fn is not None:
            header["members"] = self._members_fn()
        try:
            resp = self._rt(header)
        except (ConnectionError, socket.timeout, OSError, RuntimeError):
            telemetry.counter("elastic.failover.repl_errors").inc()
            return
        if resp.get("fenced"):
            self._handle_fenced(resp)

    def _handle_fenced(self, resp: dict) -> None:
        if self.fenced:
            return
        self.fenced = True
        self.fenced_epoch = int(resp.get("epoch", 0))
        telemetry.counter("elastic.failover.fenced").inc()
        telemetry.record_event("failover", transition="fenced",
                               epoch=self.fenced_epoch)
        if self._on_fenced is not None:
            try:
                self._on_fenced(self.fenced_epoch)
            except Exception:
                pass  # fencing must not kill the drain thread

    # -- transport (single persistent socket, one reconnect) --------------
    def _rt(self, header: dict, blobs=()) -> dict:
        header = dict(header)
        if self.token is not None:
            header["token"] = self.token
        for attempt in (0, 1):
            try:
                if self._sock is None:
                    self._sock = socket.create_connection(
                        self._addr, timeout=self._timeout)
                    self._sock.setsockopt(socket.IPPROTO_TCP,
                                          socket.TCP_NODELAY, 1)
                self._sock.settimeout(self._timeout)
                remote_ps.send_message(self._sock, header, blobs)
                resp, _ = remote_ps.recv_message(self._sock)
                break
            except (ConnectionError, socket.timeout, OSError):
                self._drop_sock()
                if attempt:
                    raise
        if "error" in resp:
            raise RuntimeError(f"standby refused: {resp['error']}")
        return resp

    def _drop_sock(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


class StandbyState:
    """The standby's mirror of the coordinator's authority + the
    promotion state machine. Attached to a DARK
    :class:`~distkeras_tpu_torch.parallel.remote_ps.ParameterServerService`
    (``svc.standby = this``, ``svc.is_standby = True``): until promotion
    the service answers only replication/health/discovery ops.
    """

    #: bounded mirrors: the dedup window matches the service's own cache
    #: scale; telemetry keeps the freshest batches only (the collector it
    #: seeds is itself bounded).
    DEDUP_MIRROR = 512
    TELEMETRY_MIRROR = 64

    def __init__(self, service, *, lease_s: float = DEFAULT_COORD_LEASE_S,
                 member_lease_s: float = DEFAULT_LEASE_S,
                 straggler: Optional[StragglerDetector] = None,
                 time_fn: Callable[[], float] = time.time):
        self.service = service
        self.lease_s = float(lease_s)
        self.member_lease_s = float(member_lease_s)
        self.straggler = straggler
        self._time = time_fn
        self._lock = threading.Lock()
        self.promoted = False
        self.epoch = 0  # highest epoch heard from the live coordinator
        self.last_renewal = time_fn()  # lease granted at construction
        self.applied = 0  # rseq high-water mark
        self.gaps = 0  # commits lost in the write-behind window
        self._coord_clock = 0
        self._members: dict = {}
        self._histories: dict = {}
        self._dedup: list = []  # (cid, seq, reply) mirror
        self._telemetry: list = []  # (pid, rows) batches
        self._codecs: dict = {}  # wire name -> per-stream _TreeCodec

    # -- replication stream (service handler threads) ----------------------
    def handle_append(self, header: dict, blobs: list) -> dict:
        with self._lock:
            if self.promoted:
                # the sender is a deposed coordinator still streaming
                return {"fenced": True, "epoch": self.epoch}
            self.last_renewal = self._time()  # a record is proof of life
            rseq = int(header.get("rseq", 0))
            if rseq and rseq <= self.applied:
                return {"ok": True, "applied": self.applied, "dup": True}
            kind = header.get("kind", "commit")
            if kind == "commit":
                self._apply_commit_locked(header, blobs)
            elif kind == "history":
                self._histories[int(header["pid"])] = header["windows"]
            elif kind == "telemetry":
                self._telemetry.append((int(header.get("pid", -1)),
                                        list(header.get("rows", []))))
                del self._telemetry[:-self.TELEMETRY_MIRROR]
            if rseq:
                self.applied = rseq
            return {"ok": True, "applied": self.applied}

    def _apply_commit_locked(self, header: dict, blobs: list) -> None:
        codec = self._codecs.get(header.get("codec", "raw"))
        if codec is None:
            codec = self.service.codec.with_wire(header.get("codec", "raw"))
            self._codecs[header.get("codec", "raw")] = codec
        delta = codec.decode(blobs, kind="commit")
        gap = self.service.ps.replay(delta, header["at_fold"],
                                     header["weight"],
                                     header.get("last_update", 0))
        if gap > 0:
            self.gaps += gap
        cid, seq = header.get("cid"), header.get("seq")
        if cid is not None and seq is not None:
            # mirror the coordinator's dedup verdict: a worker that
            # retries an acked-but-lost-reply commit AFTER promotion gets
            # the original answer instead of a double fold
            self._dedup.append((cid, int(seq),
                                {"at_fold": int(header["at_fold"]),
                                 "weight": float(header["weight"])}))
            del self._dedup[:-self.DEDUP_MIRROR]

    def handle_lease(self, header: dict) -> dict:
        with self._lock:
            if self.promoted:
                return {"fenced": True, "epoch": self.epoch}
            self.last_renewal = self._time()
            self.epoch = max(self.epoch, int(header.get("epoch", 0)))
            if header.get("clock") is not None:
                self._coord_clock = int(header["clock"])
            if header.get("members") is not None:
                self._members = dict(header["members"])
            return {"ok": True, "lease_s": self.lease_s,
                    "epoch": self.epoch}

    # -- discovery + promotion ---------------------------------------------
    def lease_remaining(self) -> float:
        with self._lock:
            return (self.last_renewal + self.lease_s) - self._time()

    def coordinator_view(self) -> dict:
        """Answer "who is the coordinator?" — and notice a lapsed lease
        while answering: promotion is lazy, exactly like membership's
        sweep; the first query after the lapse performs the handoff."""
        self.maybe_promote()
        svc = self.service
        with self._lock:
            if self.promoted:
                address = svc.advertised
            else:
                address = (svc.shard_addresses[0]
                           if svc.shard_addresses else None)
            return {"address": address, "epoch": self.epoch,
                    "promoted": self.promoted, "standby": svc.advertised,
                    "applied": self.applied, "gaps": self.gaps,
                    "lease_remaining_s": round(
                        self.last_renewal + self.lease_s - self._time(), 3)}

    def maybe_promote(self, force: bool = False) -> tuple:
        """Promote when the coordinator's lease has lapsed (or ``force``,
        for deterministic handoffs in tests/drills). Returns
        ``(promoted_now, reason)``; a second promotion is always
        rejected — the epoch fence admits exactly one handoff."""
        with self._lock:
            if self.promoted:
                return False, "already promoted (epoch "\
                    f"{self.epoch}): double promotion rejected"
            if not force and self._time() <= self.last_renewal + self.lease_s:
                return False, "coordinator lease still live"
            self._promote_locked("forced" if force else "lease lapsed")
            return True, "promoted"

    def _promote_locked(self, reason: str) -> None:
        svc = self.service
        self.epoch += 1
        self.promoted = True
        # authority restore, in dependency order: membership first (the
        # commit handler consults it), then the mirrors the handler and
        # the health plane read
        m = Membership(lease_s=self.member_lease_s,
                       straggler=self.straggler, time_fn=self._time)
        m.restore(self._members)
        svc.membership = m
        # the TelemetryCollector + SLO/health plane re-mount HERE: a
        # fresh collector seeded from the replicated batches, served by
        # the same telemetry_put/telemetry_merged/status ops
        col = TelemetryCollector()
        col.adopt_batches(self._telemetry)
        svc.collector = col
        with svc._hist_cv:
            for pid, windows in self._histories.items():
                svc._histories.setdefault(pid, windows)
            svc._hist_cv.notify_all()
        for cid, seq, reply in self._dedup:
            svc._dedup_put(cid, seq, reply)
        svc.is_standby = False  # the dark gate lifts: data ops now serve
        svc.coord_epoch = self.epoch
        if svc.shard_addresses:
            addresses = list(svc.shard_addresses)
            addresses[0] = svc.advertised
            svc.shard_addresses = addresses
        telemetry.counter("elastic.failover.promotions").inc()
        telemetry.gauge("elastic.failover.epoch").set(self.epoch)
        telemetry.record_event("failover", transition="promote",
                               epoch=self.epoch, reason=reason,
                               clock=int(svc.ps.num_updates),
                               gaps=self.gaps)

    def handle_promote(self, force: bool = False) -> dict:
        did, reason = self.maybe_promote(force=force)
        with self._lock:
            return {"promoted": did, "epoch": self.epoch, "reason": reason,
                    "address": self.service.advertised}
