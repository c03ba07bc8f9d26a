"""Cross-process true async: a live parameter service and its client
(port of ``distkeras_tpu/parallel/remote_ps.py``).

dist-keras's deployment is workers training against a live parameter
server on the Spark master: a socket server, a handler thread per connection,
and the center and deltas on the wire. Here
:class:`ParameterServerService` fronts a
:class:`~distkeras_tpu_torch.parameter_servers.ParameterServer` whose
center lives on the card, and :class:`RemoteParameterServer` is the
drop-in client the worker threads of
:class:`~distkeras_tpu_torch.parallel.host_async.HostAsyncRunner` use.
The client survives transport faults (reconnect with seeded backoff,
``(cid, seq)`` commit identity the service dedups on) and raises a typed
:class:`PSUnavailable` when its budget is spent; the service carries the
elastic membership plane, the coordinator failover hooks
(:mod:`~distkeras_tpu_torch.parallel.failover`), the end-of-run history
barrier, the fleet telemetry collector and the health ops. Every op and
reply is the JAX package's, so either package's client talks to either
package's service. :func:`share_service_address` agrees on the
service's address and token across the processes of a
``torch.distributed`` group, with the JAX package's payload bytes.

One framing for every socket of the repo, no pickle: nothing on the wire
can execute code, and leaves decode zero-copy into numpy::

    [u32 header_len][header JSON (utf-8)][blob 0][blob 1]...

``header["blob_lens"]`` carries the byte length of each trailing blob.
The serving front end (:mod:`distkeras_tpu_torch.serving.server`) speaks
it with the same shared-token check (:func:`check_token`), so a client of
either package talks to a server of the other.

:class:`_TreeCodec` moves a weight tree as one blob a leaf: a flax-layout
nested mapping (:mod:`distkeras_tpu_torch.utils.bridge` converts a
``state_dict`` to and from it), a ``state_dict`` or one fleet shard's
list of leaves, flattened in the order ``jax.tree`` flattens it (keys
sorted at every level), so the JAX package and the port put the same
bytes in the same slots.
"""

from __future__ import annotations

import collections
import json
import os
import socket
import struct
import threading
import time
from typing import Any, Optional, Sequence, Tuple

import numpy as np

from distkeras_tpu_torch import comms, telemetry
from distkeras_tpu_torch.comms.chunking import send_buffers
from distkeras_tpu_torch.comms.retry import DEFAULT_RETRY, RetryPolicy
from distkeras_tpu_torch.health import recorder as flight_recorder
from distkeras_tpu_torch.health.endpoints import (HEALTH_OPS,
                                                  handle_health_op)
from distkeras_tpu_torch.health.membership import Membership
from distkeras_tpu_torch.parameter_servers import (ParameterServer,
                                                   dynsgd_fold_weight)
from distkeras_tpu_torch.utils import fault
from distkeras_tpu_torch.utils.transfer import to_host
from distkeras_tpu_torch.utils.trees import tree_flatten, tree_unflatten


def send_message(sock: socket.socket, header: dict,
                 blobs: Sequence = ()):
    """Frame and send. Blobs may be bytes or memoryviews; large ones go
    out as bounded chunks straight from their backing arrays."""
    header = dict(header)
    header["blob_lens"] = [len(b) for b in blobs]
    hb = json.dumps(header).encode()
    sock.sendall(struct.pack("<I", len(hb)) + hb)
    send_buffers(sock, blobs)


def _recvexact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return bytes(buf)


def recv_message(sock: socket.socket) -> Tuple[dict, list]:
    (hlen,) = struct.unpack("<I", _recvexact(sock, 4))
    header = json.loads(_recvexact(sock, hlen))
    blobs = [_recvexact(sock, n) for n in header.get("blob_lens", [])]
    return header, blobs


class PSUnavailable(RuntimeError):
    """The parameter service could not be reached within the retry budget.

    Raised by :class:`RemoteParameterServer` after reconnect/backoff
    exhaustion — the typed signal HostAsyncRunner's degradation ladder
    keys on (compute-only windows against the stale center, fold the
    accumulated delta on reconnect) instead of crashing the worker on a
    bare socket error."""


class HistoryBarrierTimeout(RuntimeError, TimeoutError):
    """The end-of-run history barrier expired before every process (or
    shard) reported — typed so callers can distinguish "the fleet never
    converged on a final center" from a transport timeout, instead of
    silently proceeding with partial history. Also a RuntimeError: that
    is what this condition surfaced as before it was typed, and callers'
    broad handlers keep working."""


class CoordinatorFenced(RuntimeError):
    """The peer is a DEPOSED coordinator: a newer epoch holds the lease
    (DESIGN.md §17). Carries the promoted coordinator's address and the
    fencing epoch, so the sharded client re-resolves without a discovery
    round-trip. A RuntimeError because that is what service error
    replies raised before fencing was typed."""

    def __init__(self, msg: str, coordinator: Optional[str] = None,
                 epoch: int = 0):
        super().__init__(msg)
        self.coordinator = coordinator
        self.epoch = int(epoch)


#: Ops only the CURRENT coordinator may serve: a fenced (deposed)
#: coordinator refuses these with a redirect, and a dark standby refuses
#: them until promoted. Discovery (shard_map/coordinator), replication,
#: promotion, and the health plane stay served in both states.
COORD_OPS = ("pull", "commit", "register", "lease_renew", "deregister",
             "clock", "version", "history_put", "history_get",
             "telemetry_put", "telemetry_merged")


def check_token(expected: Optional[str], header: dict) -> bool:
    """Constant-time shared-token check (ADVICE r5): the service refuses
    any request whose header token does not match the process-0-generated
    secret. ``expected=None`` disables authentication (single-host dev)."""
    if expected is None:
        return True
    import hmac

    got = header.get("token")
    return isinstance(got, str) and hmac.compare_digest(got, expected)


class _TreeCodec:
    """Flatten/unflatten a fixed weight tree to wire leaf blobs.

    Both ends build the codec from their own tree of the same structure
    (a nested mapping, a ``state_dict``, or one fleet shard's list of
    leaves), so the wire carries only leaf blobs: structure, shapes and
    dtypes are agreed out of band and VERIFIED on decode. Leaves go in the
    order ``jax.tree`` flattens the same tree (keys sorted at every
    level), so a JAX peer puts each leaf in the same slot. The leaf
    encoding is a pluggable wire codec (:mod:`distkeras_tpu_torch.comms.
    codec`, raw by default); a lossy codec gets a worker-side
    error-feedback accumulator, so commit quantization error re-enters
    the next delta instead of being lost."""

    def __init__(self, like, wire="raw"):
        leaves, self.treedef = tree_flatten(to_host(like))
        self.specs = [(np.shape(l), np.asarray(l).dtype) for l in leaves]
        self._raw_bytes = sum(
            int(np.prod(s)) * np.dtype(d).itemsize for s, d in self.specs)
        self.set_wire(wire)

    def set_wire(self, wire) -> None:
        self.wire = comms.get_codec(wire)
        self._ef = comms.ErrorFeedback(self.wire) if self.wire.lossy \
            else None

    def with_wire(self, wire) -> "_TreeCodec":
        """A sibling sharing the (immutable) specs and structure with its
        own wire codec and error-feedback state: per-connection codecs on
        the server without re-flattening ``like`` per accept."""
        clone = object.__new__(_TreeCodec)
        clone.treedef = self.treedef
        clone.specs = self.specs
        clone._raw_bytes = self._raw_bytes
        clone.set_wire(wire)
        return clone

    def encode(self, tree, kind: str = "commit") -> list:
        t0 = time.perf_counter()
        leaves = tree_flatten(to_host(tree))[0]
        if len(leaves) != len(self.specs):
            raise ValueError(
                f"tree has {len(leaves)} leaves, codec expects "
                f"{len(self.specs)}")
        if self._ef is not None and kind == "commit":
            blobs = self._ef.encode_leaves(leaves, self.specs)
        else:
            blobs = [self.wire.encode(l, kind=kind) for l in leaves]
        wire_bytes = sum(len(b) for b in blobs)
        if wire_bytes:
            telemetry.histogram("comms.compress_ratio", op=kind,
                                codec=self.wire.name).record(
                self._raw_bytes / wire_bytes)
        telemetry.histogram("profile.phase.encode_s", op=kind).record(
            time.perf_counter() - t0)
        return blobs

    def decode(self, blobs: Sequence[bytes], kind: str = "commit"):
        t0 = time.perf_counter()
        if len(blobs) != len(self.specs):
            raise ValueError(
                f"message has {len(blobs)} blobs, codec expects "
                f"{len(self.specs)}")
        leaves = [self.wire.decode(b, shape, dtype, kind=kind)
                  for b, (shape, dtype) in zip(blobs, self.specs)]
        tree = tree_unflatten(self.treedef, leaves)
        telemetry.histogram("profile.phase.decode_s", op=kind).record(
            time.perf_counter() - t0)
        return tree


class ParameterServerService:
    """Socket front-end for a live ParameterServer (runs on process 0).

    The reference's lifecycle verbs (``start``/``run``/``stop``) and
    thread shape (accept loop + handler thread per connection) are kept;
    the center behind the socket lives on the server's device and its
    folds are the commits of :mod:`distkeras_tpu_torch.parameter_servers`. Also aggregates end-of-run
    window histories from every process (``history_put``/``history_get``).
    """

    #: bounded per-client replay window: how many (seq → reply) entries
    #: the commit dedup cache keeps per cid. A client retries at most one
    #: in-flight commit per worker thread, so 128 is orders of magnitude
    #: of slack — the bound exists so a long run cannot grow the cache.
    DEDUP_CACHE = 128

    def __init__(self, ps: ParameterServer, like,
                 expected_processes: int = 1,
                 host: str = "0.0.0.0", port: int = 0,
                 token: Optional[str] = None,
                 codecs: Optional[Sequence[str]] = None,
                 membership: Optional[Membership] = None,
                 shard: int = 0, num_shards: int = 1,
                 collector=None):
        self.ps = ps
        self.codec = _TreeCodec(like)
        # fleet telemetry sink (health/collector.py): mounted on the
        # coordinator shard only; workers push row batches via the
        # telemetry_put op, readers merge them via telemetry_merged
        self.collector = collector
        # wire codecs this server will grant in the hello handshake
        # (None = everything registered); raw is always granted
        self.supported = tuple(codecs) if codecs is not None \
            else comms.available_codecs()
        self.expected = int(expected_processes)
        self.token = token  # ADVICE r5: required in every request header
        # elastic fleet (DESIGN.md §13): the membership table lives on the
        # coordinator shard (shard 0) only; follower shards fold with the
        # coordinator's explicit weight and keep no member state
        self.membership = membership
        self.shard = int(shard)
        self.num_shards = int(num_shards)
        #: full fleet map ("host:port" per shard), set by the launcher once
        #: every shard is up; served to late joiners via the shard_map op
        self.shard_addresses: Optional[list] = None
        # -- coordinator failover plane (parallel/failover.py) -------------
        #: this service's own reachable address (set by the launcher; the
        #: standby advertises it as the promoted coordinator address)
        self.advertised: Optional[str] = None
        #: the designated standby's address, broadcast to clients so their
        #: reconnect path can re-resolve a dead coordinator
        self.standby_address: Optional[str] = None
        #: a standby service is DARK: coordinator ops refused until its
        #: StandbyState promotes (which flips this back off)
        self.is_standby = False
        #: standby mirror + promotion state machine (StandbyState)
        self.standby = None
        #: the coordinator's write-behind log shipper (Replicator)
        self.replicator = None
        #: a deposed coordinator: a newer epoch fenced it; coordinator ops
        #: are refused with a redirect instead of folding into a stale
        #: center (split-brain guard)
        self.fenced = False
        self.fenced_by: Optional[dict] = None
        #: the promotion epoch this service serves under (0 = the original
        #: coordinator; each handoff increments it)
        self.coord_epoch = 0
        self._dedup: dict = {}  # cid -> OrderedDict(seq -> commit reply)
        self._dedup_lock = threading.Lock()
        self._histories: dict[int, list] = {}
        self._hist_cv = threading.Condition()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._running = False
        self._t_start = time.time()
        self._threads: list = []
        self._conns: set = set()  # established connections, for kill()
        self._conn_lock = threading.Lock()

    # -- lifecycle (reference vocabulary) ---------------------------------
    def start(self) -> None:
        self._running = True
        self._t_start = time.time()
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            # prune finished handlers (ADVICE r5): the list otherwise grows
            # one entry per connection for the life of the service
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def stop(self) -> None:
        self._running = False
        try:
            # shutdown() wakes an accept() blocked in the loop thread; a
            # bare close() would leave that in-flight syscall holding the
            # open file description, and the kernel would hand it exactly
            # one more connection — which a reconnecting fault-tolerant
            # client is quick enough to be (established connections are
            # deliberately left serving; only the listener dies here)
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def kill(self, reason: str = "chaos") -> None:
        """Simulate PROCESS DEATH for this service (the chaos "kill"
        action): unlike :meth:`stop` — which leaves established
        connections serving — the listener AND every live connection die
        instantly, in-flight requests get no reply, and the flight
        recorder dumps this side's postmortem (carrying the failover
        event) exactly as a crashing coordinator's would."""
        if not self._running:
            return
        telemetry.counter("elastic.failover.kills").inc()
        telemetry.record_event("failover", transition="killed",
                               shard=self.shard, reason=reason,
                               clock=int(self.ps.num_updates))
        if self.replicator is not None:
            self.replicator.close(timeout=0.2)  # the log dies with us
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
        flight_recorder.auto_dump(
            "coordinator_killed" if self.shard == 0
            else f"shard{self.shard}_killed")

    def fence(self, epoch: int, coordinator: Optional[str] = None) -> None:
        """Depose this (former) coordinator: a standby promoted under a
        newer epoch. Coordinator ops now refuse with a typed redirect —
        a fenced center must never fold another commit."""
        self.fenced = True
        self.fenced_by = {"epoch": int(epoch),
                          "coordinator": coordinator or self.standby_address}
        telemetry.record_event("failover", transition="deposed",
                               shard=self.shard, epoch=int(epoch))

    # -- per-connection handler (reference: handle_connection) ------------
    def _serve(self, conn: socket.socket):
        inflight = telemetry.gauge("remote_ps.server.inflight_connections")
        inflight.add(1)
        with self._conn_lock:
            self._conns.add(conn)
        codec = self.codec  # per-connection: hello may swap the wire codec
        try:
            with conn:
                while True:
                    try:
                        header, blobs = recv_message(conn)
                    except ConnectionError:
                        return
                    if not check_token(self.token, header):
                        telemetry.counter(
                            "remote_ps.server.auth_failures").inc()
                        send_message(conn, {"error": "authentication failed"})
                        return  # drop the connection, not just the request
                    if header["op"] == "hello":
                        granted = comms.negotiate(
                            header.get("codec", "raw"), self.supported)
                        codec = self.codec.with_wire(granted)
                        telemetry.counter("comms.negotiated",
                                          codec=granted).inc()
                        send_message(conn, {"codec": granted})
                        continue
                    try:
                        self._dispatch(conn, header, blobs, codec)
                    except ConnectionError:
                        # chaos-injected server reset, or the peer vanished
                        # mid-reply: this connection is done, the service
                        # lives on (the client reconnects and retries)
                        return
        except Exception:
            if self._running:  # surface handler crashes, don't die silently
                raise
        finally:
            with self._conn_lock:
                self._conns.discard(conn)
            inflight.add(-1)

    def _dispatch(self, conn, header: dict, blobs: list,
                  codec: Optional[_TreeCodec] = None):
        op = header["op"]
        # the standby replicates shard 0 but is a DIFFERENT process: give
        # it a distinct chaos identity so `shard=0` targets exactly the
        # coordinator (and `shard=-1` exactly the standby)
        act = fault.chaos("remote_ps.server.handle",
                          shard=-1 if self.is_standby else self.shard)
        if act is not None:
            if act.action == "delay":
                time.sleep(act.delay_s)  # a stalled shard, from outside
            elif act.action == "kill":
                # process death, not a connection blip: the whole service
                # (listener + every connection) dies under the caller
                self.kill(reason="chaos")
                raise ConnectionError("chaos: service killed")
            else:  # either reset flavor: kill the connection, no reply
                conn.close()
                raise ConnectionError("chaos: server reset the connection")
        telemetry.counter("remote_ps.server.dispatch", op=op).inc()
        telemetry.counter("remote_ps.server.bytes_received").inc(
            sum(len(b) for b in blobs))
        telemetry.counter("comms.bytes_recv", op=op, side="server").inc(
            sum(len(b) for b in blobs))
        ctx = telemetry.extract(header)
        t0 = time.perf_counter()
        try:
            if ctx is None:
                self._dispatch_op(conn, op, header, blobs,
                                  codec if codec is not None else self.codec)
            else:
                # adopt the caller's trace: server-side handling becomes a
                # child span under the same trace_id, stitched across the
                # socket by the traceparent header
                with telemetry.use_trace(ctx):
                    with telemetry.span("trace.server", op=op,
                                        shard=self.shard):
                        self._dispatch_op(
                            conn, op, header, blobs,
                            codec if codec is not None else self.codec)
        finally:
            telemetry.histogram("remote_ps.server.handle_s",
                                op=op).record(time.perf_counter() - t0)

    @staticmethod
    def _reply(conn, op: str, header: dict, blobs: Sequence = ()):
        telemetry.counter("comms.bytes_sent", op=op, side="server").inc(
            sum(len(b) for b in blobs))
        send_message(conn, header, blobs)

    def _dispatch_op(self, conn, op: str, header: dict, blobs: list,
                     codec: _TreeCodec):
        if op in COORD_OPS and self.fenced:
            # deposed coordinator: refuse with a redirect to the epoch
            # holder — a fenced center must never fold another commit
            fb = self.fenced_by or {}
            send_message(conn, {
                "error": "coordinator fenced: epoch "
                         f"{fb.get('epoch', 0)} promoted at "
                         f"{fb.get('coordinator')}",
                "error_kind": "fenced",
                "coordinator": fb.get("coordinator"),
                "epoch": fb.get("epoch", 0)})
            return
        if op in COORD_OPS and self.is_standby:
            send_message(conn, {"error": "standby shard is dark until "
                                     "promoted", "error_kind": "standby"})
            return
        if op == "pull":
            center, clock = self.ps.pull()
            # model_version rides every pull reply so a rollout
            # controller's poll is one roundtrip (serving/rollout.py)
            self._reply(conn, op,
                        {"clock": clock, "model_version":
                         int(getattr(self.ps, "model_version", 0))},
                        codec.encode(center, kind="pull"))
        elif op == "commit":
            # idempotency check BEFORE decode: a retried commit (client
            # sent, reply lost, client reconnected and re-sent) must fold
            # exactly once, and the replay should not even pay the decode
            cid, seq = header.get("cid"), header.get("seq")
            if cid is not None and seq is not None:
                cached = self._dedup_get(cid, seq)
                if cached is not None:
                    telemetry.counter("remote_ps.server.dedup_hits").inc()
                    telemetry.record_event("wire", outcome="dedup_hit",
                                           cid=cid, seq=seq)
                    self._reply(conn, op, cached)
                    return
            # decode ONCE into the leaves' native dtypes; the PS folds the
            # decoded tree directly (no second materialization)
            delta = codec.decode(blobs, kind="commit")
            worker = header.get("worker")
            weight = header.get("weight")  # follower-shard explicit fold
            if (weight is None and worker is not None
                    and self.membership is not None
                    and self.membership.should_late_fold(worker)):
                # an evicted worker returned: DynSGD-weight its stale
                # commit regardless of server flavor (DESIGN.md §13)
                weight = dynsgd_fold_weight
                telemetry.counter("elastic.late_folds").inc()
            at_fold, applied = self.ps.commit_ex(
                delta, last_update=header["last_update"], weight=weight)
            if worker is not None and self.membership is not None:
                # a landed commit is proof of life: renew the lease,
                # re-admit if evicted, feed the straggler detector
                self.membership.observe_commit(worker,
                                               header.get("window_s"))
            reply = {"at_fold": at_fold, "weight": applied}
            if cid is not None and seq is not None:
                self._dedup_put(cid, seq, reply)
            if self.replicator is not None:
                # write-behind: the fold's verdict + the RAW received
                # blobs ship to the standby asynchronously (zero
                # re-encode, zero added latency on this reply)
                self.replicator.record_commit(
                    blobs=blobs, codec=codec.wire.name, at_fold=at_fold,
                    weight=applied, last_update=header["last_update"],
                    cid=cid, seq=seq)
            self._reply(conn, op, reply)
        elif op == "register":
            if self.membership is None:
                # not the coordinator shard (or membership disabled):
                # lease 0 tells the worker there is no lease to keep
                self._reply(conn, op, {"lease_s": 0.0, "elastic": False})
            else:
                lease = self.membership.register(header["worker"],
                                                 header.get("lease_s"))
                self._reply(conn, op, {"lease_s": lease, "elastic": True})
        elif op == "lease_renew":
            evicted = (self.membership.renew(header["worker"])
                       if self.membership is not None else False)
            self._reply(conn, op, {"evicted": evicted})
        elif op == "deregister":
            if self.membership is not None:
                self.membership.deregister(header["worker"])
            self._reply(conn, op, {"ok": True})
        elif op == "shard_map":
            self._reply(conn, op, {
                "shard": self.shard, "num_shards": self.num_shards,
                "addresses": list(self.shard_addresses or [])})
        elif op == "clock":
            self._reply(conn, op, {"clock": self.ps.pull()[1]})
        elif op == "version":
            # control-plane peek at the published deployment version
            # (serving/rollout.py) without paying a center transfer;
            # ``"set"`` stamps a publish (monotone, refused loudly)
            if header.get("set") is not None:
                try:
                    self.ps.set_model_version(int(header["set"]))
                except (AttributeError, ValueError) as e:
                    send_message(conn, {"error": str(e)})
                    return
            self._reply(conn, op, {
                "version": int(getattr(self.ps, "model_version", 0)),
                "clock": int(self.ps.num_updates)})
        elif op == "history_put":
            with self._hist_cv:
                self._histories[int(header["pid"])] = header["windows"]
                self._hist_cv.notify_all()
            if self.replicator is not None:
                self.replicator.record_history(int(header["pid"]),
                                               header["windows"])
            self._reply(conn, op, {"ok": True})
        elif op == "history_get":
            # blocks until EVERY process uploaded — the end-of-run barrier.
            # The timeout reply is sent AFTER the cv is released: a socket
            # send under self._hist_cv would freeze every history_put
            # worker behind a slow reader's TCP window for the full I/O
            # wait (dktlint: lock-blocking-call).
            with self._hist_cv:
                self._hist_cv.wait_for(
                    lambda: len(self._histories) >= self.expected,
                    timeout=header.get("timeout", 600))
                uploaded = sorted(self._histories)
                merged = sorted(
                    (w for ws in self._histories.values() for w in ws),
                    key=lambda w: w[0])
            if len(uploaded) < self.expected:
                send_message(conn, {"error": "history barrier timeout: "
                                f"{uploaded} of "
                                f"{self.expected} processes uploaded",
                                "error_kind": "history-timeout"})
                return
            center, clock = self.ps.pull()
            self._reply(conn, op, {"windows": merged, "clock": clock},
                        codec.encode(center, kind="pull"))
        elif op == "telemetry_put":
            # fleet telemetry aggregation (DESIGN.md §15): a worker pushes
            # its span/metric rows; bounded on the collector side, a
            # best-effort no-op when this shard mounts no collector
            if self.collector is None:
                self._reply(conn, op, {"ok": False, "accepted": 0,
                                       "dropped": 0})
            else:
                res = self.collector.add_batch(header.get("pid", -1),
                                               header.get("rows", []))
                if self.replicator is not None:
                    self.replicator.record_telemetry(
                        header.get("pid", -1), header.get("rows", []))
                self._reply(conn, op, dict(res, ok=True))
        elif op == "telemetry_merged":
            rows = ([] if self.collector is None
                    else self.collector.merged_rows())
            self._reply(conn, op, {"ok": self.collector is not None,
                                   "rows": rows})
        elif op == "repl_append":
            # the coordinator's write-behind log arriving at the standby
            if self.standby is None:
                send_message(conn, {"error": "not a standby: no replication "
                                         "state mounted"})
            else:
                self._reply(conn, op, self.standby.handle_append(header,
                                                                 blobs))
        elif op == "coord_lease":
            # the coordinator's heartbeat: lease renewal + authority
            # snapshot (clock, membership export)
            if self.standby is None:
                send_message(conn, {"error": "not a standby: no replication "
                                         "state mounted"})
            else:
                self._reply(conn, op, self.standby.handle_lease(header))
        elif op == "coordinator":
            # discovery: who holds the coordinator lease? On a standby
            # this lazily notices a lapsed lease and promotes (the
            # worker's reconnect path is the failure detector)
            self._reply(conn, op, self.coordinator_view())
        elif op == "promote":
            if self.standby is None:
                send_message(conn, {"error": "not a standby: nothing to "
                                         "promote"})
            else:
                self._reply(conn, op, self.standby.handle_promote(
                    force=bool(header.get("force", False))))
        elif op in HEALTH_OPS:
            # live health plane (DESIGN.md §9): header-only introspection
            # sharing this connection's framing + token auth
            with self._hist_cv:
                uploaded = len(self._histories)
            self._reply(conn, op, handle_health_op(op, header, extra_status={
                "service": "parameter_server",
                "clock": int(self.ps.num_updates),  # no center fetch
                "model_version": int(getattr(self.ps, "model_version", 0)),
                "expected_processes": self.expected,
                "histories_uploaded": uploaded,
                "uptime_s": round(time.time() - self._t_start, 3),
                "port": self.port,
                "shard": self.shard,
                "num_shards": self.num_shards,
                # failover discovery hints: HealthClient caches these so
                # a later connection loss can follow the coordinator move
                **({"shard_addresses": list(self.shard_addresses)}
                   if self.shard_addresses else {}),
                **({"standby": self.standby_address}
                   if self.standby_address else {}),
                **({"coord_epoch": self.coord_epoch}
                   if self.coord_epoch else {}),
                **({"is_standby": True} if self.is_standby else {}),
                **({"fenced": self.fenced_by} if self.fenced else {}),
                **({"membership": self.membership.status()}
                   if self.membership is not None else {}),
            }))
        else:
            send_message(conn, {"error": f"unknown op {op!r}"})

    # -- commit idempotency (retried commits fold once) --------------------
    def _dedup_get(self, cid: str, seq) -> Optional[dict]:
        with self._dedup_lock:
            replies = self._dedup.get(cid)
            return None if replies is None else replies.get(int(seq))

    def _dedup_put(self, cid: str, seq, reply: dict) -> None:
        with self._dedup_lock:
            replies = self._dedup.setdefault(cid, collections.OrderedDict())
            replies[int(seq)] = reply
            while len(replies) > self.DEDUP_CACHE:
                replies.popitem(last=False)

    def coordinator_view(self) -> dict:
        """Where this service believes the coordinator lease lives. A
        standby answers from its promotion state machine (and may promote
        while answering); everyone else answers from the fleet map."""
        if self.standby is not None:
            return self.standby.coordinator_view()
        if self.fenced:
            fb = self.fenced_by or {}
            return {"address": fb.get("coordinator"),
                    "epoch": fb.get("epoch", 0), "promoted": True,
                    "standby": self.standby_address}
        return {"address": (self.shard_addresses[0]
                            if self.shard_addresses else self.advertised),
                "epoch": self.coord_epoch, "promoted": self.coord_epoch > 0,
                "standby": self.standby_address}

    # -- direct (in-process) counterparts for process 0 -------------------
    def put_history(self, pid: int, windows: list) -> None:
        windows = [[int(c), float(s), steps] for c, s, steps in windows]
        with self._hist_cv:
            self._histories[int(pid)] = windows
            self._hist_cv.notify_all()
        if self.replicator is not None:
            # process 0's direct upload replicates like the wire one
            self.replicator.record_history(int(pid), windows)

    def get_history_blocking(self, timeout: float = 600):
        with self._hist_cv:
            ok = self._hist_cv.wait_for(
                lambda: len(self._histories) >= self.expected,
                timeout=timeout)
            if not ok:
                raise HistoryBarrierTimeout(
                    f"history barrier: {sorted(self._histories)} of "
                    f"{self.expected} processes uploaded")
            merged = sorted(
                (w for ws in self._histories.values() for w in ws),
                key=lambda w: w[0])
        center, clock = self.ps.pull()
        return merged, to_host(center), clock


class RemoteParameterServer:
    """Client drop-in for the ParameterServer interface over the service.

    One data connection per process; worker threads share it PIPELINED:
    the connection lock covers only the send, and responses are claimed in
    send order by a FIFO of waiters — so a worker's request goes on the
    wire as soon as the previous request finished *sending*, not after its
    full round-trip (the old full-RPC lock made every small request pay
    the largest in-flight commit's RTT, and vice versa). Control-plane ops
    (``num_updates`` polls) ride a separate lazily-opened connection with
    its own server handler thread, so they can never head-of-line-block —
    or be blocked by — a multi-megabyte commit. ``pull``/``commit`` return
    exactly what the local classes return, so HostAsyncRunner cannot tell
    the difference.

    ``codec=`` requests a wire codec in the hello handshake; the server
    answers with what it granted (``.negotiated``; falls back to "raw"
    when the server lacks the codec). Lossy codecs apply error feedback
    to commits inside the tree codec (comms/codec.py).

    Transport faults are survived, not surfaced (DESIGN.md §13): a failed
    round-trip tears the connection down (failing every pipelined waiter,
    who each retry), reconnects with exponential backoff + seeded jitter
    (``retry=``), re-plays the hello handshake, and re-sends. Commits
    carry a client-generated ``(cid, seq)`` identity the server dedups
    on, so "applied but the reply was lost" folds exactly once. When the
    budget is exhausted the caller gets a typed :class:`PSUnavailable` —
    the signal HostAsyncRunner's degradation ladder keys on.
    """

    #: elastic-aware transport: host_async stamps worker identity and
    #: window duration into commits when this is True (the in-process
    #: ParameterServer classes are not on the membership plane).
    elastic = True

    def __init__(self, address: str, like, timeout: float = 600.0,
                 token: Optional[str] = None, codec: str = "raw",
                 retry: Optional[RetryPolicy] = None,
                 op_timeout: Optional[float] = None):
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout
        # per-op reply deadline: a vanished peer becomes a retry after
        # this long, instead of a hang for the full connect timeout
        self._op_timeout = float(op_timeout) if op_timeout else \
            float(timeout)
        self.codec = _TreeCodec(like)
        self.token = token
        self.retry = retry if retry is not None else DEFAULT_RETRY
        self._requested = comms.get_codec(codec).name
        self.negotiated = "raw"
        self._send_lock = threading.Lock()
        self._recv_cv = threading.Condition()
        self._pending: collections.deque = collections.deque()
        self._sock: Optional[socket.socket] = None
        self._gen = 0  # bumped on every teardown: stale waiters see it
        self._ever_connected = False
        self._ctrl_sock: Optional[socket.socket] = None
        self._ctrl_lock = threading.Lock()
        self._closed = False
        # commit identity: one cid per client process, a fresh seq per
        # LOGICAL commit — every retry (and every shard, via the sharded
        # client) re-uses the same (cid, seq); that identity is what the
        # server's dedup cache folds once
        self.cid = os.urandom(8).hex()
        self._seq = 0
        self._seq_lock = threading.Lock()
        with self._send_lock:
            self._ensure_connected()  # fail fast on a bad address

    def next_seq(self) -> int:
        """Allocate the next logical-commit sequence number (shared by
        every shard of one commit in the sharded client)."""
        with self._seq_lock:
            self._seq += 1
            return self._seq

    # -- connection lifecycle ---------------------------------------------
    def _ensure_connected(self) -> None:
        """(Re)open the data connection; caller holds ``_send_lock``."""
        if self._closed:
            raise PSUnavailable(
                f"client for {self._addr[0]}:{self._addr[1]} is closed")
        if self._sock is not None:
            return
        if not self._ever_connected:
            self._connect_locked()
            self._ever_connected = True
            return
        # a RE-connect: visible as a tagged child span when the enclosing
        # rpc is traced (same trace_id), and always as a counter
        with telemetry.span("trace.reconnect"):
            self._connect_locked()
        telemetry.counter("remote_ps.client.reconnects").inc()
        telemetry.record_event("wire", outcome="reconnect",
                               peer=f"{self._addr[0]}:{self._addr[1]}")

    def _connect_locked(self) -> None:
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            if self._requested != "raw":
                # re-play the codec handshake on every (re)connect: the
                # server starts each fresh connection on the raw codec
                hello = {"op": "hello", "codec": self._requested}
                if self.token is not None:
                    hello["token"] = self.token
                # dktlint: disable=lock-blocking-call
                send_message(sock, hello)
                resp, _ = recv_message(sock)  # dktlint: disable=lock-blocking-call
                if "error" in resp:
                    raise ConnectionError(
                        f"hello refused: {resp['error']}")
                granted = resp.get("codec", "raw")
                if granted != self.negotiated:
                    # set_wire resets error-feedback state — only on an
                    # actual codec change, never on a plain reconnect
                    self.negotiated = granted
                    self.codec.set_wire(granted)
        except BaseException:
            sock.close()
            raise
        self._sock = sock

    def _teardown_locked(self) -> None:
        """Close the data connection and fail every pipelined waiter;
        caller holds ``_send_lock``. The generation bump is how waiters
        blocked in ``_roundtrip_once`` learn their reply will never come
        (their retry loop reconnects and re-sends)."""
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        with self._recv_cv:
            self._gen += 1
            self._pending.clear()
            self._recv_cv.notify_all()

    def _teardown(self, gen: int) -> None:
        with self._send_lock:
            if self._gen == gen:  # lost the race: someone already did
                self._teardown_locked()

    # -- round-trips ------------------------------------------------------
    def _roundtrip_once(self, header: dict, blobs,
                        timeout: float) -> Tuple[dict, list]:
        ticket = object()
        with self._send_lock:
            self._ensure_connected()
            sock, gen = self._sock, self._gen
            act = fault.chaos("remote_ps.send")
            if act is not None and act.action == "delay":
                time.sleep(act.delay_s)  # dktlint: disable=lock-blocking-call
            if act is not None and act.action == "reset":
                self._teardown_locked()
                raise ConnectionError("chaos: connection reset before send")
            dropped = act is not None and act.action == "drop"
            if not dropped:
                # enqueue BEFORE releasing the send lock: wire order and
                # waiter order must agree or responses would cross-match.
                # Sending under the lock is the point: it serializes
                # frames on the shared socket (pipelining is recv-side).
                # dktlint: disable=lock-blocking-call
                send_message(sock, header, blobs)
                if act is not None and act.action == "reset_after_send":
                    # the request DID reach the wire: the server applies
                    # it and replies into a closed socket — the dedup
                    # scenario
                    self._teardown_locked()
                    raise ConnectionError(
                        "chaos: connection reset after send")
                with self._recv_cv:
                    self._pending.append(ticket)
        if dropped:
            # a swallowed request never gets a ticket: FIFO reply matching
            # cannot survive selective loss on a live stream, so the drop
            # rides out the op timeout and then declares the connection
            # dead (which is what a real lost frame amounts to here)
            time.sleep(min(timeout, 5.0) if timeout else 1.0)
            self._teardown(gen)
            raise socket.timeout("chaos: request dropped")
        with self._recv_cv:
            while not (self._pending and self._pending[0] is ticket):
                if self._gen != gen or ticket not in self._pending:
                    raise ConnectionError(
                        "connection torn down while awaiting reply")
                self._recv_cv.wait(timeout=1.0)
        # head of the pipeline: this thread owns the next reply
        try:
            sock.settimeout(timeout)
            resp, rblobs = recv_message(sock)
        except (ConnectionError, socket.timeout, OSError):
            self._teardown(gen)
            raise
        with self._recv_cv:
            if self._gen == gen:
                self._pending.popleft()
                self._recv_cv.notify_all()
        return resp, rblobs

    def _roundtrip(self, header: dict, blobs=(),
                   timeout: Optional[float] = None) -> Tuple[dict, list]:
        if telemetry.current_trace() is None:
            return self._roundtrip_impl(header, blobs, timeout)
        # one trace.rpc span per LOGICAL round-trip (retries are child
        # spans inside it, never fresh rpc spans); the span's own context
        # is what gets injected into the wire header below
        with telemetry.span("trace.rpc", op=header.get("op", "?")):
            return self._roundtrip_impl(header, blobs, timeout)

    def _roundtrip_impl(self, header: dict, blobs=(),
                        timeout: Optional[float] = None) -> Tuple[dict, list]:
        op = header.get("op", "?")
        # inject ONCE, outside the retry loop: every re-send of this
        # logical request carries the same traceparent, so the server side
        # of a retried commit lands under the same parent span. Old peers
        # ignore unknown header keys — raw-fallback-safe.
        header = telemetry.inject(dict(header))
        if self.token is not None:
            header["token"] = self.token
        timeout = self._op_timeout if timeout is None else timeout
        t0 = time.perf_counter()
        attempt = 0
        while True:
            try:
                resp, rblobs = self._roundtrip_once(header, blobs, timeout)
                break
            except (ConnectionError, socket.timeout, OSError) as e:
                if self._closed:
                    raise PSUnavailable(
                        f"client for {self._addr[0]}:{self._addr[1]} is "
                        f"closed") from e
                attempt += 1
                if attempt > self.retry.max_retries:
                    telemetry.counter("remote_ps.client.unavailable",
                                      op=op).inc()
                    telemetry.record_event("wire", outcome="unavailable",
                                           op=op, attempts=attempt,
                                           error=str(e)[:200])
                    raise PSUnavailable(
                        f"parameter service {self._addr[0]}:"
                        f"{self._addr[1]} unavailable: {op} failed after "
                        f"{self.retry.max_retries} retries ({e})") from e
                telemetry.counter("remote_ps.client.retries", op=op).inc()
                telemetry.record_event("wire", outcome="retry", op=op,
                                       attempt=attempt)
                with telemetry.span("trace.retry", op=op, attempt=attempt):
                    time.sleep(self.retry.delay(attempt))
        # rtt includes the wait for the shared connection: the contention
        # profile of the one-socket-per-process design is part of what a
        # STALENESS round wants to see
        telemetry.histogram("remote_ps.client.rtt_s",
                            op=op).record(time.perf_counter() - t0)
        telemetry.counter("remote_ps.client.bytes_sent").inc(
            sum(len(b) for b in blobs))
        telemetry.counter("remote_ps.client.bytes_received").inc(
            sum(len(b) for b in rblobs))
        telemetry.counter("comms.bytes_sent", op=op, side="client").inc(
            sum(len(b) for b in blobs))
        telemetry.counter("comms.bytes_recv", op=op, side="client").inc(
            sum(len(b) for b in rblobs))
        if "error" in resp:
            if resp.get("error_kind") == "history-timeout":
                raise HistoryBarrierTimeout(resp["error"])
            if resp.get("error_kind") == "fenced":
                raise CoordinatorFenced(resp["error"],
                                        resp.get("coordinator"),
                                        resp.get("epoch", 0))
            raise RuntimeError(f"parameter service: {resp['error']}")
        return resp, rblobs

    def _control_once(self, header: dict, timeout: float) -> dict:
        # the control channel is intentionally one-request-at-a-time: the
        # lock held over connect/send/recv IS the serialization (only
        # small header-only frames travel here, bounded by the timeout)
        with self._ctrl_lock:
            if self._closed:
                raise PSUnavailable(
                    f"client for {self._addr[0]}:{self._addr[1]} is closed")
            if self._ctrl_sock is None:
                # dktlint: disable=lock-blocking-call
                self._ctrl_sock = socket.create_connection(
                    self._addr, timeout=self._timeout)
                self._ctrl_sock.setsockopt(socket.IPPROTO_TCP,
                                           socket.TCP_NODELAY, 1)
            try:
                self._ctrl_sock.settimeout(timeout)
                send_message(self._ctrl_sock, header)  # dktlint: disable=lock-blocking-call
                resp, _ = recv_message(self._ctrl_sock)  # dktlint: disable=lock-blocking-call
            except (ConnectionError, socket.timeout, OSError):
                try:
                    self._ctrl_sock.close()
                except OSError:
                    pass
                self._ctrl_sock = None
                raise
        if "error" in resp:
            if resp.get("error_kind") == "fenced":
                raise CoordinatorFenced(resp["error"],
                                        resp.get("coordinator"),
                                        resp.get("epoch", 0))
            raise RuntimeError(f"parameter service: {resp['error']}")
        return resp

    def _control_roundtrip(self, header: dict,
                           timeout: Optional[float] = None) -> dict:
        """Small blob-free ops on a dedicated connection (opened on first
        use): a clock poll answers in one small-packet RTT even while the
        data connection is mid-way through a large commit. Same bounded
        reconnect/backoff as the data path."""
        op = header.get("op", "?")
        if self.token is not None:
            header = dict(header, token=self.token)
        timeout = self._op_timeout if timeout is None else timeout
        attempt = 0
        while True:
            try:
                return self._control_once(header, timeout)
            except PSUnavailable:
                raise
            except (ConnectionError, socket.timeout, OSError) as e:
                attempt += 1
                if attempt > self.retry.max_retries:
                    telemetry.counter("remote_ps.client.unavailable",
                                      op=op).inc()
                    telemetry.record_event("wire", outcome="unavailable",
                                           op=op, attempts=attempt,
                                           error=str(e)[:200])
                    raise PSUnavailable(
                        f"parameter service {self._addr[0]}:"
                        f"{self._addr[1]} unavailable: {op} failed after "
                        f"{self.retry.max_retries} retries ({e})") from e
                telemetry.counter("remote_ps.client.retries", op=op).inc()
                telemetry.record_event("wire", outcome="retry", op=op,
                                       attempt=attempt)
                time.sleep(self.retry.delay(attempt))

    # -- ParameterServer interface ----------------------------------------
    def pull(self):
        resp, blobs = self._roundtrip({"op": "pull"})
        return self.codec.decode(blobs, kind="pull"), resp["clock"]

    def pull_versioned(self):
        """(center, clock, model_version): the rollout controller's poll
        primitive — one roundtrip, version stamped by the same reply."""
        resp, blobs = self._roundtrip({"op": "pull"})
        return (self.codec.decode(blobs, kind="pull"), resp["clock"],
                int(resp.get("model_version", 0)))

    def commit(self, delta: Any, last_update: int = 0, **kw) -> int:
        return self.commit_ex(delta, last_update=last_update, **kw)[0]

    def commit_ex(self, delta: Any, last_update: int = 0, weight=None,
                  seq: Optional[int] = None, worker: Optional[int] = None,
                  window_s: Optional[float] = None) -> tuple:
        """Commit with the applied fold weight surfaced; returns
        ``(at_fold, weight)``. The delta is encoded ONCE, before the
        retry loop — a lossy codec's error-feedback state must not be
        double-charged by a re-send of the same logical commit."""
        header = {"op": "commit", "last_update": int(last_update),
                  "cid": self.cid,
                  "seq": int(seq) if seq is not None else self.next_seq()}
        if weight is not None:
            header["weight"] = float(weight)
        if worker is not None:
            header["worker"] = int(worker)
        if window_s is not None:
            header["window_s"] = float(window_s)
        resp, _ = self._roundtrip(header,
                                  self.codec.encode(delta, kind="commit"))
        return resp["at_fold"], resp.get("weight", 1.0)

    @property
    def num_updates(self) -> int:
        return self._control_roundtrip({"op": "clock"})["clock"]

    @property
    def model_version(self) -> int:
        """The published deployment version (serving/rollout.py) — a
        header-only control roundtrip, no center transfer."""
        return int(self._control_roundtrip({"op": "version"})["version"])

    def set_model_version(self, version: int) -> None:
        """Stamp a publish onto the remote center (WeightPublisher's
        remote leg); the server enforces monotonicity."""
        self._control_roundtrip({"op": "version", "set": int(version)})

    # -- elastic membership (coordinator shard only; DESIGN.md §13) -------
    def register(self, worker: int,
                 lease_s: Optional[float] = None) -> float:
        """Join the fleet; returns the granted lease in seconds (0.0 when
        the peer runs no membership plane)."""
        header = {"op": "register", "worker": int(worker)}
        if lease_s is not None:
            header["lease_s"] = float(lease_s)
        return float(self._control_roundtrip(header)["lease_s"])

    def renew_lease(self, worker: int) -> bool:
        """Heartbeat the lease; True means the coordinator has this
        worker marked evicted (its next commit will late-fold)."""
        return bool(self._control_roundtrip(
            {"op": "lease_renew", "worker": int(worker)})["evicted"])

    def deregister(self, worker: int) -> None:
        self._control_roundtrip({"op": "deregister", "worker": int(worker)})

    def shard_map(self) -> dict:
        """The fleet layout as the peer knows it:
        ``{shard, num_shards, addresses}`` (late-joiner bootstrap)."""
        return self._control_roundtrip({"op": "shard_map"})

    # -- coordinator failover (DESIGN.md §17) ------------------------------
    def coordinator_view(self) -> dict:
        """Who holds the coordinator lease, per this peer. Asking a
        STANDBY is the failure detector: a lapsed coordinator lease is
        noticed (and promotion performed) while this query is answered."""
        return self._control_roundtrip({"op": "coordinator"})

    def promote(self, force: bool = False) -> dict:
        """Ask a standby to promote (``force=True`` skips the lease-lapse
        check — deterministic handoffs in tests and failover drills).
        Returns ``{promoted, epoch, reason, address}``; a standby that
        already promoted rejects the second promotion."""
        return self._control_roundtrip({"op": "promote",
                                        "force": bool(force)})

    # -- end-of-run history barrier ---------------------------------------
    def put_history(self, pid: int, windows: list) -> None:
        self._roundtrip({"op": "history_put", "pid": int(pid),
                         "windows": [[int(c), float(s), steps]
                                     for c, s, steps in windows]})

    def get_history(self, timeout: float = 600):
        # reply deadline = the server-side barrier timeout plus transport
        # slack; a barrier failure arrives as a typed HistoryBarrierTimeout
        resp, blobs = self._roundtrip({"op": "history_get",
                                       "timeout": timeout},
                                      timeout=timeout + 30.0)
        return (resp["windows"], self.codec.decode(blobs, kind="pull"),
                resp["clock"])

    # -- fleet telemetry (collector on the coordinator shard) --------------
    def put_telemetry(self, pid: int, rows: list) -> dict:
        """Push this process's telemetry rows to the coordinator's
        collector. Best-effort BY DESIGN: telemetry must never fail a run,
        so an old peer (unknown op) or an unreachable service comes back
        as ``{"ok": False}`` instead of an exception."""
        try:
            resp, _ = self._roundtrip({"op": "telemetry_put",
                                       "pid": int(pid),
                                       "rows": list(rows)})
        except (PSUnavailable, RuntimeError):
            return {"ok": False, "accepted": 0, "dropped": 0}
        return resp

    def get_merged_telemetry(self) -> list:
        """The coordinator's merged fleet rows, each tagged with its
        origin ``pid``; [] when the peer mounts no collector."""
        resp, _ = self._roundtrip({"op": "telemetry_merged"})
        return resp.get("rows", [])

    def close(self) -> None:
        """Idempotent teardown (runner exit AND test teardown may both
        call it). The control connection is closed even if a control
        round-trip is in flight: the lock acquire is bounded, and closing
        the socket out from under the op fails it fast instead of holding
        close() hostage for the op's full timeout."""
        if self._closed:
            return
        self._closed = True
        with self._send_lock:
            self._teardown_locked()
        got = self._ctrl_lock.acquire(timeout=1.0)
        try:
            sock, self._ctrl_sock = self._ctrl_sock, None
        finally:
            if got:
                self._ctrl_lock.release()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # reference lifecycle no-ops (parity with ParameterServer)
    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


def share_service_address(ports,
                          token: Optional[str] = None,
                          error: bool = False) -> Tuple[str, Optional[str]]:
    """Agree on the service address AND auth token across processes:
    process 0 broadcasts ``host:port|token`` in a 512-byte payload;
    everyone returns the same ``(address, token)`` pair.

    ``ports`` may be a single port or a sequence of them (a shard fleet):
    the payload is then the full shard map, ``host:p0,host:p1,...|token``
    in shard order (one shard gives the single-server payload). Entries
    that are already strings pass through verbatim: spread placement's
    gathered ``host:port`` addresses, and the standby as a ``~host:port``
    entry. An EMPTY ``ports`` list broadcasts just the token
    (``|token``): the token-first handshake spread placement needs before
    any process can bind an authenticated service.

    ``error=True`` (process 0 only) broadcasts a failure sentinel
    instead, so that the peers RAISE here instead of blocking in this
    broadcast when process 0 could not bring the service up; process 0
    returns a dummy, its own exception being in flight. The bytes are the
    JAX package's for the same ports and token."""
    from distkeras_tpu_torch.parallel import distributed

    port_list = list(ports) if isinstance(ports, (list, tuple)) \
        else [ports]
    if distributed.process_count() == 1:
        return ",".join(e if isinstance(e, str) else f"127.0.0.1:{e}"
                        for e in port_list), token
    payload = np.zeros((512,), np.uint8)
    if distributed.process_index() == 0:
        payload = distributed.encode_payload(
            service_payload(port_list, token,
                            distributed.determine_host_address(), error))
    msg = distributed.decode_payload(
        distributed.broadcast_one_to_all(payload))
    if msg.startswith("!"):
        if distributed.process_index() == 0:
            return "", None  # the original exception is already in flight
        raise RuntimeError(f"parameter service never came up: {msg[1:]}")
    addr, _, tok = msg.partition("|")
    return addr, (tok or None)


def service_payload(port_list: Sequence, token: Optional[str], host: str,
                    error: bool = False) -> str:
    """The text process 0 broadcasts in :func:`share_service_address`."""
    if error:
        return "!service construction failed on process 0"
    return ",".join(e if isinstance(e, str) else f"{host}:{e}"
                    for e in port_list) + f"|{token or ''}"


__all__ = ["send_message", "recv_message", "check_token", "PSUnavailable",
           "HistoryBarrierTimeout", "CoordinatorFenced",
           "ParameterServerService", "RemoteParameterServer",
           "share_service_address"]
