"""ServingEngine (port of ``distkeras_tpu/serving/engine.py``): online
inference through a dynamically formed micro-batch.

    submit(x) -> bounded RequestQueue -> batcher thread coalesces
    (max_batch_size rows | max_wait_ms, whichever first) -> pad to the
    smallest declared bucket -> that bucket's CUDA graph -> scatter rows
    back to waiting Futures

The queue, the bucket ladder, deadlines and the typed errors
(:class:`QueueFull`, :class:`EngineClosed`, ``DeadlineExceeded``) keep
the JAX engine's semantics. The forward is
:func:`distkeras_tpu_torch.predictors.make_forward_fn`: ``model(x)`` in
eval mode.

**One CUDA graph a bucket over one weight bank.** The JAX engine
compiles one executable a bucket and passes the weights as an argument,
so a swap is a reference flip. A captured graph reads fixed tensor
addresses instead, so the engine serves a copy of the model (for a
:class:`~distkeras_tpu_torch.models.gpt.CausalLM`, its
:func:`~distkeras_tpu_torch.models.gpt.inference_copy`), the weight
bank, with one graph per bucket captured in ``__init__`` on the engine's
stream into one memory pool. :meth:`swap_weights` copies the new float32
masters to the card off every lock, then casts them into the bank in
place and sets the version under ``_run_lock``, which the batcher holds
for a whole replay and fetch: every batch is on one version.
:meth:`shadow_forward` of a candidate casts it into the bank, replays,
and casts the installed masters back under the same lock (the cast is
deterministic, so the restore is bit-identical). Replays, fetches and
bank loads are serialised under ``_run_lock``: the graphs share one
memory pool, so a graph's output holds only until the next replay and
is fetched first. A replay adds the kernel calls its graph captured (the
flash forward under ``CausalLM(attention="flash")``, one a layer) to the
wrappers' ``launches``. On the CPU, used only when the caller names it,
the buckets run eagerly on the same static buffers.

**Over a mesh** (``mesh=``, the JAX engine's worker-sharded forward):
every padded micro-batch splits evenly over the mesh's worker devices
(a bucket that does not divide by their count raises ValueError, as
in JAX), each distinct worker device holds one weight bank (the weights
replicated) and each (bucket, worker shard) one graph, all captured in
``__init__`` on that shard's stream into that shard's pool, and the
shards' rows are gathered back in order. A mesh may repeat a device
(``Mesh(["cuda:0"] * 2)`` on a one-card host): the shards then share
that device's bank and run in turn on the one card.

Telemetry (the JAX engine's): ``serving.queue_depth``,
``serving.batch_size``, ``serving.batch_wait_s``,
``serving.padding_rows``, ``serving.execute_s``,
``serving.request_latency_s``, counters ``serving.submitted``/
``completed``/``rejected``/``deadline_exceeded``/``batches``/``compiles``/
``batch_errors``, and the ``rollout.*`` swap metrics.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.models import gpt
from distkeras_tpu_torch.predictors import make_forward_fn
from distkeras_tpu_torch.serving.batching import (EngineClosed, QueueFull,
                                                  Request, RequestQueue)
from distkeras_tpu_torch.serving.buckets import DEFAULT_BUCKETS, BucketSpec
from distkeras_tpu_torch.serving.generation import _StepRunner


def _serving_copy(model: torch.nn.Module) -> torch.nn.Module:
    """The weight bank: a module of its own, with a causal LM's Dense and
    embedding weights stored in the compute dtype."""
    if isinstance(model, gpt.CausalLM):
        return gpt.inference_copy(model, new=True)
    return copy.deepcopy(model)


class ServingEngine:
    """Online micro-batching inference engine over CUDA graphs.

    Args:
      model: a ``torch.nn.Module`` holding its weights (the JAX engine
        takes ``model, params``); the engine moves it to ``device`` and
        serves a copy of it (the weight bank).
      input_shape: per-ROW feature shape (no batch dim), e.g. ``(128,)``
        token ids for a causal LM.
      input_dtype: row dtype; integer dtypes pass through un-cast.
      buckets: declared micro-batch sizes to pad up to; one CUDA graph a
        bucket. ``max_batch_size`` defaults to the largest bucket
        and may not exceed it.
      max_wait_ms: how long the batcher waits past the first queued
        request before flushing a partial batch.
      queue_capacity: bounded queue size; beyond it ``submit`` raises
        :class:`QueueFull`.
      default_timeout_ms: per-request deadline applied when ``submit``
        is not given one; ``None`` = no deadline.
      mesh: optional :class:`~distkeras_tpu_torch.parallel.mesh.Mesh`
        to shard micro-batches over its worker devices (every bucket
        must divide evenly); ``device`` places a single-device engine.
      device: ``None`` is ``cuda:0``; the CPU only when named.
      warmup: replay every bucket once after the captures.
      telemetry_path: if set, ``shutdown()`` dumps the telemetry
        registry to this JSONL path.
    """

    def __init__(self, model, input_shape: Sequence[int], *,
                 input_dtype=np.float32,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_batch_size: Optional[int] = None,
                 max_wait_ms: float = 2.0,
                 queue_capacity: int = 1024,
                 default_timeout_ms: Optional[float] = None,
                 mesh=None, device=None,
                 warmup: bool = True,
                 telemetry_path: Optional[str] = None):
        self.model = model
        self.input_shape = tuple(int(d) for d in input_shape)
        self.input_dtype = np.dtype(input_dtype)
        self.spec = BucketSpec(buckets)
        self.max_batch_size = int(max_batch_size if max_batch_size is not None
                                  else self.spec.max_size)
        if self.max_batch_size > self.spec.max_size:
            raise ValueError(
                f"max_batch_size={self.max_batch_size} exceeds the largest "
                f"declared bucket {self.spec.max_size}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.default_timeout_s = (None if default_timeout_ms is None
                                  else float(default_timeout_ms) / 1e3)
        self.telemetry_path = telemetry_path
        if mesh is not None:
            from distkeras_tpu_torch.parallel import mesh as mesh_lib

            shards = mesh.shape[mesh_lib.WORKER_AXIS]
            bad = [b for b in self.spec if b % shards]
            if bad:
                raise ValueError(
                    f"buckets {bad} not divisible by the mesh's "
                    f"{shards} worker shards; every padded batch must "
                    f"split evenly across the mesh")
            #: the worker shards' devices, in row order
            self.devices = [resolve_device(d) for d in mesh.devices]
        else:
            self.devices = [resolve_device(device)]
        self.mesh = mesh
        self.device = self.devices[0]
        model.to(self.device).eval()

        # live-rollout state (serving/rollout.py): the float32 masters and
        # version in the bank, the tap, and the lock that serialises bank
        # loads with replays (a batch reads one version)
        self.params = dict(model.state_dict())
        self.model_version = 0
        self.last_swap_time: Optional[float] = None
        self.mirror_sink = None     # callable(np.ndarray rows) or None
        self._run_lock = threading.Lock()

        self._capture()
        # bucket -> reusable host staging buffer, owned by the batcher
        # thread (single consumer)
        self._staging: dict = {}
        self._queue = RequestQueue(queue_capacity)
        self._submitted = telemetry.counter("serving.submitted")
        self._completed = telemetry.counter("serving.completed")
        self._batches = telemetry.counter("serving.batches")
        self._batch_errors = telemetry.counter("serving.batch_errors")
        self._padding = telemetry.histogram("serving.padding_rows")
        self._execute_h = telemetry.histogram("serving.execute_s")
        self._latency_h = telemetry.histogram("serving.request_latency_s")
        self._shutdown_lock = threading.Lock()
        self._shut = False
        if warmup:
            self.warmup()
        self._thread = threading.Thread(target=self._batcher_loop,
                                        daemon=True,
                                        name="distkeras-serving-batcher")
        self._thread.start()

    # -- one CUDA graph a bucket ------------------------------------------

    def _capture(self) -> None:
        """Make one weight bank a distinct device and one runner per
        (bucket, shard) (a CUDA graph on the card, captured on the shard's
        stream into its pool), counting each on ``serving.compiles``."""
        cuda = self.device.type == "cuda"
        #: one stream a shard: every capture and replay of the shard runs
        #: on it, a bank loads on its device's first shard's (``stream`` is
        #: the first shard's)
        self.streams = [torch.cuda.Stream(d) if cuda else None
                        for d in self.devices]
        self.stream = self.streams[0]
        pools = [torch.cuda.graph_pool_handle() if cuda else None
                 for _ in self.devices]
        by_device = {}
        for d, stream in zip(self.devices, self.streams):
            if d not in by_device:
                by_device[d] = (_serving_copy(self.model).to(d), stream)
        #: one weight bank a distinct device, with the stream that loads
        #: it: the shards on one device share its bank
        self._banks = list(by_device.values())
        self._bank = self._banks[0][0]
        forwards = [make_forward_fn(by_device[d][0]) for d in self.devices]
        self._runs = {}
        shards = len(self.devices)
        for bucket in self.spec:
            x = np.zeros((bucket // shards,) + self.input_shape,
                         self.input_dtype)
            runs = []
            for forward, dev, stream, pool in zip(forwards, self.devices,
                                                  self.streams, pools):
                with telemetry.span("serving.compile", bucket=bucket):
                    runs.append(_StepRunner(
                        lambda _pool, x, f=forward: f(x), None, {"x": x},
                        dev, stream, pool))
                telemetry.counter("serving.compiles").inc()
            self._runs[bucket] = runs

    def warmup(self) -> Tuple[int, ...]:
        """Replay every bucket once, so no request pays a first replay's
        costs. Returns the declared buckets."""
        with telemetry.span("serving.warmup"):
            with self._run_lock:
                for runs in self._runs.values():
                    for run in runs:
                        run.warm()
        return self.compiled_buckets

    @property
    def compiled_buckets(self) -> Tuple[int, ...]:
        """The buckets captured in ``__init__``: exactly the declared
        ladder, never grown by traffic or swaps."""
        return tuple(sorted(self._runs))

    @property
    def captures(self) -> int:
        """The runners made in ``__init__``: buckets x worker shards."""
        return sum(len(runs) for runs in self._runs.values())

    def _replay(self, x: np.ndarray, n: int) -> np.ndarray:
        """Run the bucket of ``len(x)``, each worker shard on its slice of
        the rows, and fetch the first ``n`` output rows, in order (caller
        holds ``_run_lock``)."""
        runs = self._runs[len(x)]
        m = len(x) // len(runs)
        for i, run in enumerate(runs):
            run(x=x[i * m:(i + 1) * m])
        outs = []
        for i, run in enumerate(runs[:-(-n // m)]):
            rows = min(m, n - i * m)
            if self.streams[i] is None:
                outs.append(run.out[:rows].detach().numpy().copy())
                continue
            with torch.cuda.stream(self.streams[i]):
                outs.append(run.out[:rows].cpu().numpy())
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    # -- live weight rollout (serving/rollout.py) ---------------------------

    def _stage(self, params) -> dict:
        """The float32 masters on the engine's device (a copy from the
        host, finished before this returns)."""
        staged = {k: torch.as_tensor(v).to(self.device)
                  for k, v in params.items()}
        if self.stream is not None:
            torch.cuda.current_stream(self.device).synchronize()
        return staged

    def _load(self, staged: dict) -> None:
        """Cast ``staged`` into every bank's tensors in place, each on its
        stream, finished before this returns (caller holds
        ``_run_lock``)."""
        for bank, stream in self._banks:
            if stream is None:
                gpt.load_weights(bank, staged)
                continue
            with torch.cuda.stream(stream):
                gpt.load_weights(bank, staged)
            stream.synchronize()

    def swap_weights(self, params, version: int) -> None:
        """Atomically install ``params`` (a ``state_dict`` of float32
        masters) as ``version``. Validation (names, shapes, dtypes
        against the incumbent) runs FIRST, so a torn or mismatched dict
        raises ValueError with engine state untouched. The host-to-card
        copy runs off every lock; the cast into the bank and the version
        flip run together under ``_run_lock``, which the batcher holds
        for a whole batch: every batch is entirely version N or N+1.
        Nothing is captured."""
        from distkeras_tpu_torch.serving.rollout import validate_tree_like

        t0 = time.perf_counter()
        try:
            validate_tree_like(params, self.params)
        except ValueError:
            telemetry.counter("rollout.torn_swaps_blocked",
                              engine="serving").inc()
            raise
        staged = self._stage(params)
        with self._run_lock:
            self._load(staged)
            self.params = params
            self.model_version = int(version)
            self.last_swap_time = time.time()
        dt = time.perf_counter() - t0
        telemetry.counter("rollout.swaps", engine="serving").inc()
        telemetry.histogram("rollout.swap_s", engine="serving").record(dt)
        telemetry.gauge("rollout.model_version", engine="serving").set(
            int(version))
        telemetry.gauge("rollout.last_swap_time",
                        engine="serving").set(self.last_swap_time)
        telemetry.record_event("rollout", action="swap", engine="serving",
                               version=int(version), seconds=dt)
        from distkeras_tpu_torch.health import recorder as flight_recorder

        flight_recorder.configure(serving_model_version=int(version))

    def shadow_forward(self, params, rows: np.ndarray) -> np.ndarray:
        """Run ``rows`` through the bucket graphs under ``params`` (canary
        scoring: candidate against incumbent on mirrored traffic) without
        touching the live version: when ``params`` is not the installed
        dict, it is cast into the bank for these replays and the
        installed masters are cast back after, all under ``_run_lock``,
        so no live batch sees the candidate. Never captures. Returns the
        stacked output rows as a host array."""
        rows = np.asarray(rows, dtype=self.input_dtype)
        staged = restore = live = None
        if params is not self.params:
            from distkeras_tpu_torch.serving.rollout import \
                validate_tree_like

            validate_tree_like(params, self.params)
            staged = self._stage(params)
            live = self.params
            restore = self._stage(live)
        outs = []
        with self._run_lock:
            if staged is not None:
                if self.params is not live:  # a swap landed meanwhile
                    restore = self._stage(self.params)
                self._load(staged)
            try:
                for start in range(0, len(rows), self.max_batch_size):
                    chunk = rows[start:start + self.max_batch_size]
                    n = len(chunk)
                    x = np.zeros((self.spec.bucket_for(n),)
                                 + self.input_shape, self.input_dtype)
                    x[:n] = chunk
                    outs.append(self._replay(x, n))
            finally:
                if staged is not None:
                    self._load(restore)
        return np.concatenate(outs, axis=0) if outs else \
            np.zeros((0,), self.input_dtype)

    # -- submission API ---------------------------------------------------

    def _make_request(self, x, timeout_ms, now: float) -> Request:
        row = np.asarray(x, dtype=self.input_dtype)
        if row.shape != self.input_shape:
            raise ValueError(
                f"request row has shape {row.shape}, engine serves "
                f"{self.input_shape}")
        timeout_s = (self.default_timeout_s if timeout_ms is None
                     else float(timeout_ms) / 1e3)
        deadline = None if timeout_s is None else now + timeout_s
        return Request(row, now, deadline,
                       trace=telemetry.current_trace())

    def submit(self, x, timeout_ms: Optional[float] = None):
        """Enqueue one row; returns a ``concurrent.futures.Future`` of
        that row's model output. Raises :class:`QueueFull` under
        backpressure and :class:`EngineClosed` after shutdown; the future
        fails with ``DeadlineExceeded`` if the deadline passes before
        execution starts."""
        now = time.monotonic()
        req = self._make_request(x, timeout_ms, now)
        self._queue.put(req)
        self._submitted.inc()
        return req.future

    def submit_many(self, xs, timeout_ms: Optional[float] = None) -> list:
        """Enqueue rows atomically (all admitted or QueueFull); returns
        one Future per row."""
        now = time.monotonic()
        reqs = [self._make_request(x, timeout_ms, now) for x in xs]
        self._queue.put_many(reqs)
        self._submitted.inc(len(reqs))
        return [r.future for r in reqs]

    # -- batcher / executor -----------------------------------------------

    def _batcher_loop(self):
        while True:
            batch = self._queue.next_batch(self.max_batch_size,
                                           self.max_wait_s)
            if batch is None:
                return  # closed and drained
            self._refresh_queue_gauges()
            if not batch:
                continue  # every popped request had expired
            try:
                self._execute(batch)
            except Exception as e:  # a bad batch must not kill the engine
                self._batch_errors.inc()
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

    def _execute(self, batch):
        n = len(batch)
        bucket = self.spec.bucket_for(n)
        x = self._staging.get(bucket)
        if x is None:
            x = np.zeros((bucket,) + self.input_shape, self.input_dtype)
            self._staging[bucket] = x
        else:
            x[n:] = 0  # zero only the padded tail
        for i, req in enumerate(batch):
            x[i] = req.x
        self._padding.record(bucket - n)
        t0 = time.perf_counter()
        for req in batch:
            if req.trace is not None:
                telemetry.record_trace_span(req.trace, "trace.queue_wait",
                                            req.t_perf, t0 - req.t_perf)
        with self._run_lock:
            # a swap loads the bank and sets the version under the same
            # lock, so the label names the weights used
            version = self.model_version
            y_host = self._replay(x, n)
        dt = time.perf_counter() - t0
        self._execute_h.record(dt)
        for req in batch:
            if req.trace is not None:
                telemetry.record_trace_span(req.trace, "trace.compute",
                                            t0, dt, bucket=bucket,
                                            model_version=version)
        self._batches.inc()
        sink = self.mirror_sink
        if sink is not None:
            # shadow tap for canary scoring: live rows only, copied (the
            # staging buffer is reused by the next batch)
            try:
                sink(np.array(x[:n]))
            except Exception:  # the canary must never break serving
                telemetry.counter("rollout.mirror_errors").inc()
        now = time.monotonic()
        for i, req in enumerate(batch):
            req.future.set_result(y_host[i])
            self._latency_h.record(now - req.t_submit)
        self._completed.inc(n)

    # -- health -----------------------------------------------------------

    def _refresh_queue_gauges(self) -> Tuple[int, Optional[float]]:
        depth = len(self._queue)
        age = self._queue.oldest_age()
        telemetry.gauge("serving.queue_depth").set(depth)
        telemetry.gauge("serving.oldest_request_age_s").set(
            0.0 if age is None else age)
        return depth, age

    def health_status(self) -> dict:
        """Live queue state for the health plane: depth, head-of-line
        age, the captured buckets and the installed version."""
        depth, age = self._refresh_queue_gauges()
        return {
            "queue_depth": depth,
            "oldest_request_age_s": age,
            "queue_capacity": self._queue.capacity,
            "compiled_buckets": list(self.compiled_buckets),
            "model_version": self.model_version,
            "last_swap_time": self.last_swap_time,
            "shut": self._shut,
        }

    # -- lifecycle --------------------------------------------------------

    def shutdown(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the engine. ``drain=True`` serves everything already
        queued before the batcher exits; ``drain=False`` fails queued
        requests with :class:`EngineClosed`. Idempotent."""
        with self._shutdown_lock:
            if self._shut:
                return
            self._shut = True
        self._queue.close()
        if not drain:
            self._queue.fail_pending(
                EngineClosed("engine shut down without draining"))
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            telemetry.counter("serving.shutdown_timeouts").inc()
            telemetry.record_event("serving", outcome="shutdown_timeout",
                                   timeout_s=timeout)
            self._queue.fail_pending(EngineClosed(
                f"batcher thread still running after {timeout}s "
                f"shutdown join"))
        if self.telemetry_path:
            reg = telemetry.get_registry()
            if reg is not None:
                reg.dump_jsonl(self.telemetry_path)

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))


__all__ = ["ServingEngine", "QueueFull", "EngineClosed"]
