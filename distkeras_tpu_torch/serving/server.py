"""Socket front end of the serving engines (port of
``distkeras_tpu/serving/server.py``): requests over TCP.

Thin by design: the engines own batching, buckets, deadlines and
backpressure; this module only moves rows and tokens across a socket. It
speaks the JAX package's wire byte for byte (the framing and the
shared-token check of :mod:`distkeras_tpu_torch.parallel.remote_ps`), so
a JAX :class:`ServingClient` drives a port server and the other way
round. No pickle: nothing on the wire can execute code.

Protocol (header JSON + raw blobs):

    {"op": "infer", "token": ..., "shape": [n, ...], "dtype": "float32",
     "timeout_ms": 50}            + blob: row-major request rows
    -> {"shape": [n, ...], "dtype": ...} + blob: row-major outputs
    -> {"error": "...", "kind": "deadline|queue_full|closed|bad_request"}

    {"op": "stats", "token": ...} -> {"counters": {...}, "gauges": {...}}
    {"op": "ping", "token": ...}  -> {"ok": true}

    {"op": "weights_put", "token": ..., "version": v,
     "target": "serving|generation|both"} + blobs: _TreeCodec leaves of
     a flax-layout tree
    -> {"ok": ..., "version": v, "staged": ...}   (live rollout)
    {"op": "version", "token": ...} -> {"model_version": v, ...}

    {"op": "kv_export", "token": ..., "length": n} + blob: int32 tokens
    -> {"found": true, "leaves": [[shape, dtype], ...], ...} + blobs:
       one raw host KV page blob per pool leaf (+ optional parked
       last-logits blob), or {"found": false}
    {"op": "kv_handoff", "token": ..., "length": n,
     "leaves": [[shape, dtype], ...], ...} + blobs: int32 tokens then
     the kv_export blobs verbatim -> {"ok": bool}  (False = refused: the
     caller prefills from scratch, never a half-install)

    {"op": "generate", "token": ..., "length": n, "max_new_tokens": m,
     "timeout_ms": ..., "eos_id": ...} + blob: int32 prompt tokens
    -> zero or more {"stream": true, "tokens": [...]} frames, then ONE
       typed final frame: {"done": true, "reason": "eos|length|max_len",
       "num_tokens": k, "dtype": "int32"} + blob: the full generated
       sequence, or {"error": "...", "kind": ...}. The final blob equals
       the concatenated stream frames.

plus the live-health introspection ops (``status`` / ``metrics-snapshot``
/ ``recent-spans`` / ``series``, :mod:`distkeras_tpu_torch.health.
endpoints`): the serving ``status`` digest includes both engines' state.

``weights_put`` decodes the flax-layout tree the JAX package publishes
and installs ``bridge.flax_to_state_dict(tree)``, so a JAX
``put_weights(flax_params)`` installs on a port server the weights it
installs on a JAX server. KV blobs carry torch's dtype names, which are
numpy's (and ml_dtypes') for float32, int8 and bfloat16.

``router=``: a :class:`~distkeras_tpu_torch.serving.fleet.FleetRouter`
(or JAX's) whose ``status_digest()`` the ``status`` op carries under
``"fleet"``, as in JAX.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.comms.retry import DEFAULT_RETRY
from distkeras_tpu_torch.health.endpoints import HEALTH_OPS, handle_health_op
from distkeras_tpu_torch.parallel.remote_ps import (_TreeCodec, check_token,
                                                    recv_message,
                                                    send_message)
from distkeras_tpu_torch.serving.batching import (DeadlineExceeded,
                                                  EngineClosed, QueueFull)
from distkeras_tpu_torch.serving.engine import ServingEngine
from distkeras_tpu_torch.serving.generation import GenerationResult
from distkeras_tpu_torch.serving.kv_cache import tree_leaves
from distkeras_tpu_torch.utils import bridge

# The serving error taxonomy: clients and tests dispatch on these strings.
ERROR_KINDS = ("auth", "bad_request", "closed", "deadline", "queue_full")


def _error_kind(exc: Exception) -> str:
    if isinstance(exc, DeadlineExceeded):
        return "deadline"
    if isinstance(exc, QueueFull):
        return "queue_full"
    if isinstance(exc, EngineClosed):
        return "closed"
    return "bad_request"


def _wire_dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _tensor(raw: bytes, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor of ``shape`` over a copy of ``raw`` (``dtype`` a
    torch dtype name)."""
    dt = getattr(torch, dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown wire dtype {dtype!r}")
    flat = (torch.frombuffer(bytearray(raw), dtype=torch.uint8) if raw
            else torch.empty(0, dtype=torch.uint8))
    return flat.view(dt).reshape([int(d) for d in shape])


def _tensor_bytes(t: torch.Tensor) -> memoryview:
    flat = t.detach().cpu().contiguous().reshape(-1)
    return memoryview(flat.view(torch.uint8).numpy())


class ServingServer:
    """Accept loop + a handler thread per connection, in front of a
    :class:`~distkeras_tpu_torch.serving.engine.ServingEngine` and
    optionally a :class:`~distkeras_tpu_torch.serving.generation.
    GenerationEngine` (``generator``, backing ``generate`` and the KV
    ops) and a :class:`~distkeras_tpu_torch.serving.rollout.
    RolloutController` (``rollout``: ``weights_put`` stages through it).

    ``token``: shared secret required in every request header; None
    disables auth (loopback development only). ``engine=None`` makes a
    generation-only server (a fleet replica): ``infer`` and a
    ``weights_put`` aimed at the one-shot engine are refused as
    ``bad_request``, and ``status``/``version`` carry the generation
    engine's fields only (the JAX server needs an engine).
    """

    def __init__(self, engine: Optional[ServingEngine],
                 host: str = "0.0.0.0",
                 port: int = 0, token: Optional[str] = None,
                 generator=None, rollout=None, router=None):
        self.engine = engine
        self.generator = generator
        self.rollout = rollout
        #: a fleet router whose digest rides the ``status`` op
        self.router = router
        self.token = token
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._running = False
        self._threads: list = []

    def start(self) -> None:
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="distkeras-serving-accept")
        t.start()
        self._threads.append(t)

    def stop(self, shutdown_engine: bool = False) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass
        if shutdown_engine and self.engine is not None:
            self.engine.shutdown(drain=True)

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve(self, conn: socket.socket):
        inflight = telemetry.gauge("serving.server.inflight_connections")
        inflight.add(1)
        try:
            with conn:
                while True:
                    try:
                        header, blobs = recv_message(conn)
                    except ConnectionError:
                        return
                    if not check_token(self.token, header):
                        telemetry.counter(
                            "serving.server.auth_failures").inc()
                        send_message(conn, {"error": "authentication failed",
                                            "kind": "auth"})
                        return  # drop the connection, not just the request
                    self._dispatch(conn, header, blobs)
        except Exception:
            if self._running:  # surface handler crashes, don't die silently
                raise
        finally:
            inflight.add(-1)

    def _dispatch(self, conn, header: dict, blobs: list):
        op = header.get("op")
        telemetry.counter("serving.server.requests", op=str(op)).inc()
        handlers = {"infer": self._infer, "generate": self._generate,
                    "weights_put": self._weights_put,
                    "kv_export": self._kv_export,
                    "kv_handoff": self._kv_handoff}
        if op in handlers:
            try:
                # infer and generate send their own frames; the others
                # return (header, blobs); a synchronous rejection arrives
                # before any frame, so the client sees one typed reply
                reply = handlers[op](conn, header, blobs)
                if reply is not None:
                    send_message(conn, *reply)
            except Exception as e:
                send_message(conn, {"error": str(e),
                                    "kind": _error_kind(e)})
        elif op == "version":
            send_message(conn, self._version())
        elif op == "stats":
            send_message(conn, self._stats())
        elif op == "ping":
            send_message(conn, {"ok": True})
        elif op in HEALTH_OPS:
            extra = {
                "service": "serving",
                "port": self.port,
                **(self.engine.health_status()
                   if self.engine is not None else {}),
            }
            if self.generator is not None:
                extra["decode"] = self.generator.health_status()
            if self.router is not None:
                extra["fleet"] = self.router.status_digest()
            send_message(conn, handle_health_op(op, header,
                                                extra_status=extra))
        else:
            send_message(conn, {"error": f"unknown op {op!r}",
                                "kind": "bad_request"})

    @staticmethod
    def _request_trace(header: dict, engine=None):
        """One trace per request: adopt the caller's wire context when
        the header carries one, else mint a root; the serving model
        version rides the baggage."""
        ctx = telemetry.extract(header)
        if ctx is None:
            ctx = telemetry.TraceContext.new_root()
        if engine is not None:
            ctx.baggage.setdefault("model_version",
                                   str(engine.model_version))
        return ctx

    def _require_generator(self):
        if self.generator is None:
            raise ValueError("no generation engine mounted on this server")

    def _require_engine(self):
        if self.engine is None:
            raise ValueError("no one-shot engine mounted on this server")

    def _weights_put(self, conn, header: dict, blobs: list):
        """Decode a published flax-layout weight tree and install its
        ``state_dict``: through the mounted RolloutController (canary and
        rollback rails) when one exists, a direct engine swap otherwise.
        A torn blob list fails decode or swap validation; it can never
        half-install."""
        version = int(header["version"])
        target = header.get("target", "serving")
        if target not in ("serving", "generation", "both"):
            raise ValueError(f"unknown weights_put target {target!r}")
        if target != "serving":
            self._require_generator()
        if target != "generation":
            self._require_engine()
        like = self.engine.params if target == "serving" \
            else self.generator._params
        template = bridge.state_dict_to_flax(like, shapes_only=True)
        tree = _TreeCodec(template).decode(blobs, kind="pull")
        params = bridge.flax_to_state_dict(tree)
        if self.rollout is not None:
            ok = self.rollout.stage(version, params)
            return ({"ok": bool(ok), "version": version,
                     "staged": self.rollout.candidate_version == version},)
        if target in ("serving", "both"):
            self.engine.swap_weights(params, version)
        if target in ("generation", "both"):
            self.generator.swap_weights(params, version)
        return ({"ok": True, "version": version, "staged": False},)

    def _version(self) -> dict:
        """What every engine on this server serves right now (plus the
        controller's state when mounted)."""
        out = {}
        if self.engine is not None:
            out["model_version"] = self.engine.model_version
            out["last_swap_time"] = self.engine.last_swap_time
        if self.generator is not None:
            out["decode_model_version"] = self.generator.model_version
            out["decode_live_versions"] = sorted(self.generator._versions)
        if self.rollout is not None:
            out["rollout"] = self.rollout.status()
        return out

    def _infer(self, conn, header: dict, blobs: list):
        self._require_engine()
        if len(blobs) != 1:
            raise ValueError(f"infer expects 1 blob, got {len(blobs)}")
        shape = tuple(int(d) for d in header["shape"])
        x = np.frombuffer(blobs[0],
                          dtype=np.dtype(header["dtype"])).reshape(shape)
        if shape[1:] != self.engine.input_shape:
            raise ValueError(
                f"rows of shape {shape[1:]} sent to an engine serving "
                f"{self.engine.input_shape}")
        timeout_ms = header.get("timeout_ms")
        with telemetry.use_trace(self._request_trace(header, self.engine)):
            with telemetry.span("trace.request", op="infer",
                                rows=int(shape[0])):
                futures = self.engine.submit_many(x, timeout_ms=timeout_ms)
                # bound for the blocking result() calls: the request's
                # deadline (if any) plus slack for the executing batch
                wait_s = (None if timeout_ms is None
                          else timeout_ms / 1e3 + 30.0)
                rows = [np.asarray(f.result(timeout=wait_s))
                        for f in futures]
        out = np.stack(rows) if rows else np.empty((0,), np.float32)
        send_message(conn, {"shape": list(out.shape), "dtype": str(out.dtype)},
                     [np.ascontiguousarray(out).tobytes()])

    def _generate(self, conn, header: dict, blobs: list):
        self._require_generator()
        if len(blobs) != 1:
            raise ValueError(f"generate expects 1 blob, got {len(blobs)}")
        prompt = np.frombuffer(blobs[0], np.int32)
        if prompt.size != int(header["length"]):
            raise ValueError(
                f"prompt blob holds {prompt.size} tokens, header declares "
                f"{header['length']}")
        kw = {}
        if header.get("max_new_tokens") is not None:
            kw["max_new_tokens"] = int(header["max_new_tokens"])
        if header.get("eos_id") is not None:
            kw["eos_id"] = int(header["eos_id"])
        if header.get("timeout_ms") is not None:
            kw["timeout_ms"] = float(header["timeout_ms"])
        ctx = self._request_trace(header, self.generator)
        q: "queue.SimpleQueue[int]" = queue.SimpleQueue()
        fut = self.generator.generate(prompt, stream=q.put, trace=ctx, **kw)
        while True:
            try:
                chunk = [q.get(timeout=0.05)]
            except queue.Empty:
                # the scheduler streams before completing the future, so
                # done-then-empty means no frame can still arrive
                if fut.done() and q.empty():
                    break
                continue
            while True:
                try:
                    chunk.append(q.get_nowait())
                except queue.Empty:
                    break
            t0 = time.perf_counter()
            send_message(conn, {"stream": True, "tokens": chunk})
            telemetry.record_trace_span(
                ctx, "trace.stream_flush", t0, time.perf_counter() - t0,
                tokens=len(chunk))
        exc = fut.exception()
        if exc is not None:
            send_message(conn, {"error": str(exc),
                                "kind": _error_kind(exc)})
            return
        res = fut.result()
        out = np.ascontiguousarray(res.tokens)
        send_message(conn, {"done": True, "reason": res.reason,
                            "num_tokens": int(out.size),
                            "dtype": str(out.dtype)}, [out.tobytes()])

    def _tokens(self, header: dict, blob) -> np.ndarray:
        tokens = np.frombuffer(blob, np.int32)
        if tokens.size != int(header["length"]):
            raise ValueError(
                f"token blob holds {tokens.size} tokens, header declares "
                f"{header['length']}")
        return tokens

    def _kv_export(self, conn, header: dict, blobs: list):
        """The parked prompt KV pages (+ last logits) for exactly the
        given token sequence, as raw host blobs: one per pool leaf in
        :func:`~distkeras_tpu_torch.serving.kv_cache.tree_leaves` order,
        with ``(shape, dtype)`` in the header; bitwise lossless."""
        self._require_generator()
        if len(blobs) != 1:
            raise ValueError(f"kv_export expects 1 blob, got {len(blobs)}")
        got = self.generator.export_prefix(self._tokens(header, blobs[0]))
        if got is None:
            return {"found": False}, []
        data, last_logits = got
        leaves = tree_leaves(data)
        out = {"found": True,
               "model_version": self.generator.model_version,
               "leaves": [[list(l.shape), _wire_dtype(l)] for l in leaves],
               "has_logits": last_logits is not None}
        payload = [_tensor_bytes(l) for l in leaves]
        if last_logits is not None:
            ll = np.ascontiguousarray(np.asarray(last_logits))
            out["logits_shape"] = list(ll.shape)
            out["logits_dtype"] = str(ll.dtype)
            payload.append(ll.tobytes())
        return out, payload

    def _kv_handoff(self, conn, header: dict, blobs: list):
        """Install shipped prefill KV pages into this server's decode
        engine. Blob 0 is the int32 token sequence; the rest are the
        ``kv_export`` payload verbatim. The engine checks leaf count,
        shape and dtype against its own pool and refuses the whole entry
        on any mismatch: ``ok: false`` means the caller prefills."""
        self._require_generator()
        meta = header.get("leaves")
        if not isinstance(meta, list):
            raise ValueError("kv_handoff header missing leaves metadata")
        want = 1 + len(meta) + (1 if header.get("has_logits") else 0)
        if len(blobs) != want:
            raise ValueError(
                f"kv_handoff expects {want} blobs, got {len(blobs)}")
        tokens = self._tokens(header, blobs[0])
        leaves = [_tensor(raw, dtype, shape) for (shape, dtype), raw
                  in zip(meta, blobs[1:1 + len(meta)])]
        last_logits = None
        if header.get("has_logits"):
            last_logits = np.frombuffer(
                blobs[-1], np.dtype(header["logits_dtype"])).reshape(
                    [int(d) for d in header["logits_shape"]])
        ok = self.generator.import_prefix(tokens, leaves,
                                          last_logits=last_logits)
        return ({"ok": bool(ok)},)

    def _stats(self) -> dict:
        reg = telemetry.get_registry()
        if reg is None:
            return {"counters": {}, "gauges": {}}
        snap = reg.snapshot()
        pick = lambda d: {k: v for k, v in d.items()  # noqa: E731
                          if k.startswith("serving.")}
        return {"counters": pick(snap["counters"]),
                "gauges": pick(snap["gauges"])}


class ServingClient:
    """Blocking client for the serving wire: ``infer(rows) -> outputs``,
    ``generate(prompt) -> GenerationResult`` and the control ops.

    One connection; callers on several threads serialize behind a lock.
    A dropped connection is retried through ``retry`` (a
    :class:`~distkeras_tpu_torch.comms.retry.RetryPolicy`): the client
    reconnects and resends the whole request. A ``generate`` that already
    streamed tokens raises instead, because a replay could emit twice.
    ``retry=None`` fails fast."""

    def __init__(self, address: str, token: Optional[str] = None,
                 timeout: float = 60.0, retry=DEFAULT_RETRY):
        host, port = address.rsplit(":", 1)
        self.token = token
        self._addr = (host, int(port))
        self._timeout = timeout
        self._retry = retry
        self._sock = socket.create_connection(self._addr, timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def _reconnect(self, attempt: int) -> None:
        """Replace the dead socket after the policy's backoff delay.
        Caller holds ``self._lock`` and owns the retry budget."""
        try:
            self._sock.close()
        except OSError:
            pass
        time.sleep(self._retry.delay(attempt))
        self._sock = socket.create_connection(self._addr,
                                              timeout=self._timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        telemetry.counter("serving.client.reconnects").inc()

    def _roundtrip(self, header: dict, blobs=()) -> Tuple[dict, list]:
        header = telemetry.inject(dict(header))
        if self.token is not None:
            header["token"] = self.token
        # by-design: the lock held over send+recv serializes callers on
        # the single shared connection (documented contention profile)
        with self._lock:
            attempts = self._retry.max_retries if self._retry else 0
            for attempt in range(attempts + 1):
                try:
                    send_message(self._sock, header, blobs)  # dktlint: disable=lock-blocking-call
                    return recv_message(self._sock)  # dktlint: disable=lock-blocking-call
                except (ConnectionError, OSError):
                    if attempt >= attempts:
                        raise
                    telemetry.counter("serving.client.retries").inc()
                    self._reconnect(attempt + 1)

    @staticmethod
    def _check(resp: dict) -> dict:
        if "error" in resp:
            raise RuntimeError(
                f"serving ({resp.get('kind', '?')}): {resp['error']}")
        return resp

    def infer(self, rows, timeout_ms: Optional[float] = None) -> np.ndarray:
        x = np.ascontiguousarray(np.asarray(rows))
        header = {"op": "infer", "shape": list(x.shape),
                  "dtype": str(x.dtype)}
        if timeout_ms is not None:
            header["timeout_ms"] = float(timeout_ms)
        resp, blobs = self._roundtrip(header, [x.tobytes()])
        self._check(resp)
        return np.frombuffer(blobs[0], np.dtype(resp["dtype"])).reshape(
            resp["shape"])

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 on_token=None) -> GenerationResult:
        """Stream one generation; returns the final
        :class:`GenerationResult`. ``on_token`` (if given) is called with
        each token as its stream frame arrives. Raises if the stream
        frames disagree with the final blob."""
        p = np.ascontiguousarray(np.asarray(prompt, np.int32).reshape(-1))
        header = {"op": "generate", "length": int(p.size)}
        if max_new_tokens is not None:
            header["max_new_tokens"] = int(max_new_tokens)
        if timeout_ms is not None:
            header["timeout_ms"] = float(timeout_ms)
        if eos_id is not None:
            header["eos_id"] = int(eos_id)
        header = telemetry.inject(header)
        if self.token is not None:
            header = dict(header, token=self.token)
        streamed = []
        # one generation owns the connection until its final frame;
        # retries cover the send and the first frame only
        with self._lock:
            attempts = self._retry.max_retries if self._retry else 0
            for attempt in range(attempts + 1):
                try:
                    send_message(self._sock, header, [p.tobytes()])  # dktlint: disable=lock-blocking-call
                    resp, blobs = recv_message(self._sock)  # dktlint: disable=lock-blocking-call
                    break
                except (ConnectionError, OSError):
                    if attempt >= attempts:
                        raise
                    telemetry.counter("serving.client.retries").inc()
                    self._reconnect(attempt + 1)
            while resp.get("stream"):
                for t in resp["tokens"]:
                    streamed.append(int(t))
                    if on_token is not None:
                        on_token(int(t))
                resp, blobs = recv_message(self._sock)  # dktlint: disable=lock-blocking-call
        self._check(resp)
        tokens = np.frombuffer(blobs[0], np.dtype(resp["dtype"]))
        if streamed != tokens.tolist():
            raise RuntimeError(
                f"stream frames ({len(streamed)} tokens) disagree with the "
                f"final frame ({tokens.size} tokens)")
        return GenerationResult(tokens, resp["reason"])

    def put_weights(self, params, version: int,
                    target: str = "serving") -> dict:
        """Push weights as ``version``: a ``state_dict`` (sent in the flax
        layout, as the JAX client sends its params) or a flax-layout
        tree. The server installs them into its engines (through the
        rollout controller's canary rails when one is mounted).
        ``target``: ``"serving"`` | ``"generation"`` | ``"both"``."""
        tree = params
        if any(isinstance(v, torch.Tensor) for v in params.values()):
            tree = bridge.state_dict_to_flax(params)
        header = {"op": "weights_put", "version": int(version),
                  "target": target}
        resp, _ = self._roundtrip(header,
                                  _TreeCodec(tree).encode(tree, kind="pull"))
        return self._check(resp)

    def version(self) -> dict:
        """The server's live version digest."""
        resp, _ = self._roundtrip({"op": "version"})
        return self._check(resp)

    def stats(self) -> dict:
        resp, _ = self._roundtrip({"op": "stats"})
        return resp

    def status(self) -> dict:
        """The server's live health ``status`` digest."""
        resp, _ = self._roundtrip({"op": "status"})
        return self._check(resp)

    def kv_export(self, tokens):
        """Fetch the parked prompt KV for ``tokens`` from the server's
        prefix cache: the raw ``(header, blobs)`` wire payload
        (``header["found"]`` False when there is no such entry), to pass
        to another server's :meth:`kv_handoff` verbatim."""
        t = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
        resp, blobs = self._roundtrip(
            {"op": "kv_export", "length": int(t.size)}, [t.tobytes()])
        return self._check(resp), blobs

    def kv_handoff(self, tokens, export_header: dict,
                   export_blobs) -> bool:
        """Install a :meth:`kv_export` payload into the server's prefix
        cache. False means the server refused the entry (shape or dtype
        mismatch) and the caller should prefill from scratch."""
        t = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
        header = {"op": "kv_handoff", "length": int(t.size),
                  "leaves": export_header["leaves"],
                  "has_logits": export_header.get("has_logits", False)}
        if header["has_logits"]:
            header["logits_shape"] = export_header["logits_shape"]
            header["logits_dtype"] = export_header["logits_dtype"]
        resp, _ = self._roundtrip(header, [t.tobytes()] + list(export_blobs))
        return bool(self._check(resp).get("ok"))

    def ping(self) -> bool:
        resp, _ = self._roundtrip({"op": "ping"})
        return bool(self._check(resp).get("ok"))

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


__all__ = ["ERROR_KINDS", "ServingClient", "ServingServer"]
