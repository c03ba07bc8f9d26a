"""Continuous-batching generative serving over a paged KV pool (port of
``distkeras_tpu/serving/generation.py``, paged greedy mode).

- **prefill**: one bucketed call (the :class:`BucketSpec` ladder over
  prompt lengths) writes the prompt's K/V into the slot's pages and
  yields the first token;
- **decode**: every iteration advances ALL in-flight sequences by one
  token in a single step, the batch padded up to a **slot ladder**
  entry; each lane feeds ``[token, GHOST_TOKEN]`` at positions
  ``[len, len + 1]`` (the JAX package's ghost position, kept so that both
  packages run the same shapes); the ghost's output is discarded and its
  cell is overwritten by the next real token before it is ever visible;
- **iteration-level scheduling**: queued requests are admitted between
  decode steps and finished ones (EOS / ``max_new_tokens`` / deadline /
  context full) retire mid-flight, freeing their slot and pages.

One step function, :func:`make_paged_step_fn`, serves every phase:
prefill is ``n=1, T=bucket``, decode ``T=2``. Its attention runs the
hand-written paged kernel on the card. Every shape (one per prefill
bucket, one per ladder entry) is run once in ``__init__`` against the
scratch page, so the kernel is built and no request pays first-call
costs; :attr:`GenerationEngine.compiled_executables` lists them. The
page pool is updated in place by each step.

Backpressure and deadlines keep the JAX package's semantics and typed
errors: a bounded admission queue (:class:`QueueFull`), page exhaustion
leaves the request at the queue head until pages return, deadlines are
checked at admission and between decode steps
(:class:`DeadlineExceeded`), :class:`EngineClosed` after shutdown.

Not ported yet (each raises NotImplementedError naming its ROADMAP.md
Queue A item): the rectangular pool (``page_size=None``), the prefix
cache, speculative decoding, chunked prefill, int8 KV pages, sampling.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import gpt
from distkeras_tpu_torch.serving.batching import (DeadlineExceeded,
                                                  EngineClosed, QueueFull)
from distkeras_tpu_torch.serving.buckets import BucketSpec
from distkeras_tpu_torch.serving.kv_cache import PagedKVCachePool

#: token id fed at the decode step's ghost position (its output is
#: discarded, so any valid id works)
GHOST_TOKEN = 0


def _default_ladder(num_slots: int) -> Tuple[int, ...]:
    """Powers of two up to ``num_slots``, always ending at ``num_slots``
    so every possible in-flight count has a lane bucket."""
    sizes = set()
    n = 1
    while n < num_slots:
        sizes.add(n)
        n *= 2
    sizes.add(num_slots)
    return tuple(sorted(sizes))


def make_paged_step_fn(model):
    """``(pages, page_tables[n, Pmax], tokens[n, T], lengths[n]) ->
    (pages, logits[n, T, V])`` for every paged phase: prefill is
    ``n=1, T=bucket`` at ``lengths=[start]``, decode ``T=2`` (token +
    ghost). ``pages`` is updated in place and returned; ``page_tables``
    and ``lengths`` are int32 tensors on the model's device."""

    @torch.no_grad()
    def step(pages, page_tables, tokens, lengths):
        logits, pages = model(tokens, cache=pages, cache_index=lengths,
                              page_table=page_tables)
        return pages, logits

    return step


class GenerationResult:
    """Terminal value of a finished generation.

    ``tokens``: int32 array of generated tokens (includes the EOS token
    when ``reason == "eos"``). ``reason``: ``"eos"`` | ``"length"``
    (hit ``max_new_tokens``) | ``"max_len"`` (context window full).
    """

    __slots__ = ("tokens", "reason")

    def __init__(self, tokens: np.ndarray, reason: str):
        self.tokens = tokens
        self.reason = reason

    def __repr__(self) -> str:
        return (f"GenerationResult(tokens={self.tokens.tolist()}, "
                f"reason={self.reason!r})")


class _GenRequest:
    __slots__ = ("prompt", "max_new_tokens", "eos_id", "stream", "future",
                 "t_submit", "deadline", "generated", "last_token", "trace",
                 "t_perf")

    def __init__(self, prompt, max_new_tokens, eos_id, stream,
                 t_submit, deadline, trace=None):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.stream = stream
        self.future: Future = Future()
        self.t_submit = t_submit
        self.deadline = deadline
        self.generated: list = []
        self.last_token: int = 0
        #: TraceContext this request's spans chain under (None = untraced);
        #: t_perf is the submit instant on the span time base
        self.trace = trace
        self.t_perf = time.perf_counter()


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue A, item {item})")


class GenerationEngine:
    """Iteration-level continuous-batching decode loop over a paged pool.

    ``generate()`` is thread-safe and returns a Future of
    :class:`GenerationResult`; an optional ``stream`` callback receives
    each token as it is emitted (called on the scheduler thread — it
    must not block). One scheduler thread owns the pool, the model and
    all host-side accounting.

    ``model`` is a :class:`~distkeras_tpu_torch.models.gpt.CausalLM`
    holding its weights; the engine moves it to ``device`` (default
    ``cuda:0``; ``"cpu"`` only when asked) and puts it in eval mode.
    """

    def __init__(self, model, *, num_slots: int = 4,
                 slot_ladder: Optional[Sequence[int]] = None,
                 prefill_buckets: Sequence[int] = (8, 32),
                 queue_capacity: int = 64,
                 default_max_new_tokens: int = 32,
                 eos_id: Optional[int] = None,
                 device=None, dtype=None, hbm_fraction: float = 0.8,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache_bytes: int = 0,
                 draft=None, spec_k: int = 0,
                 prefill_chunk: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 sampling: bool = False):
        if page_size is None:
            raise _not_ported("the rectangular KV pool (page_size=None)", 1)
        if prefix_cache_bytes:
            raise _not_ported("the prefix cache (prefix_cache_bytes)", 2)
        if draft is not None or spec_k:
            raise _not_ported("speculative decoding (draft/spec_k)", 3)
        if prefill_chunk is not None:
            raise _not_ported("chunked prefill (prefill_chunk)", 4)
        if kv_dtype == "int8":
            raise _not_ported("int8 KV pages (kv_dtype='int8')", 5)
        if sampling:
            raise _not_ported("temperature sampling (sampling=True)", 6)
        self.model = model
        self.max_len = int(model.max_len)
        self._buckets = BucketSpec(prefill_buckets)
        if self._buckets.sizes[0] < 2:
            raise ValueError(
                f"prefill buckets must be >= 2, got {self._buckets.sizes}")
        if self._buckets.max_size > self.max_len:
            raise ValueError(
                f"largest prefill bucket {self._buckets.max_size} exceeds "
                f"model max_len {self.max_len}")
        self._ladder = BucketSpec(
            _default_ladder(num_slots) if slot_ladder is None
            else slot_ladder)
        if self._ladder.max_size != num_slots:
            raise ValueError(
                f"slot ladder {self._ladder.sizes} must top out at "
                f"num_slots={num_slots} so every in-flight count has a "
                f"lane width")
        self.pool = PagedKVCachePool(
            model, num_slots, page_size=page_size, num_pages=num_pages,
            device=device, dtype=dtype, kv_dtype=kv_dtype,
            hbm_fraction=hbm_fraction)
        self.device = self.pool.device
        model.to(self.device).eval()
        # one compute-dtype copy of the weights, made once, instead of a
        # cast per weight per call on this host-bound loop
        self._step = make_paged_step_fn(gpt.inference_copy(model))
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.eos_id = eos_id
        self.queue_capacity = int(queue_capacity)
        self._dq: "collections.deque[_GenRequest]" = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._drain = True

        self._admitted_c = telemetry.counter("serving.decode.admitted")
        self._rejected_c = telemetry.counter("serving.decode.rejected")
        self._expired_c = telemetry.counter("serving.decode.deadline_exceeded")
        self._prefills_c = telemetry.counter("serving.decode.prefills")
        self._steps_c = telemetry.counter("serving.decode.steps")
        self._tokens_c = telemetry.counter("serving.decode.tokens")
        self._stream_err_c = telemetry.counter("serving.decode.stream_errors")
        self._loop_err_c = telemetry.counter("serving.decode.loop_errors")
        self._prefill_h = telemetry.histogram("serving.decode.prefill_s")
        self._step_h = telemetry.histogram("serving.decode.step_s")
        self._ttft_h = telemetry.histogram("serving.decode.ttft_s")
        self._padded_h = telemetry.histogram("serving.decode.padded_lanes")
        self._tps_g = telemetry.gauge("serving.decode.tokens_per_s")
        self._active_g = telemetry.gauge("serving.decode.slots_active")
        self._depth_g = telemetry.gauge("serving.decode.queue_depth")

        self._warmup()
        self._thread = threading.Thread(target=self._scheduler_loop,
                                        name="generation-scheduler",
                                        daemon=True)
        self._thread.start()

    # -- device calls ------------------------------------------------------

    def _run(self, page_tables: np.ndarray, tokens: np.ndarray,
             lengths: np.ndarray) -> torch.Tensor:
        """One step on the device; the pool's pages update in place."""
        dev = self.device
        _, logits = self._step(self.pool.pool,
                               torch.from_numpy(page_tables).to(dev),
                               torch.from_numpy(tokens).to(dev),
                               torch.from_numpy(lengths).to(dev))
        return logits

    def _warmup(self) -> None:
        """Run every shape once against the scratch slot/page (scratch
        garbage is fine: reads are masked by per-slot lengths)."""
        with telemetry.span("serving.decode.warmup"):
            spt = self.pool.page_tables[self.pool.scratch_slot]
            for lb in self._buckets:
                self._run(spt[None, :], np.zeros((1, lb), np.int32),
                          np.zeros(1, np.int32))
            for n in self._ladder:
                self._run(np.tile(spt, (n, 1)), np.zeros((n, 2), np.int32),
                          np.zeros(n, np.int32))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._warmed = {"prefill": tuple(self._buckets),
                        "decode": tuple(self._ladder)}

    @property
    def compiled_executables(self):
        """{"prefill": bucket sizes, "decode": lane widths} warmed in
        ``__init__`` — the only shapes any request runs."""
        return dict(self._warmed)

    # -- client API --------------------------------------------------------

    def generate(self, prompt, *, max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 stream=None, trace=None) -> Future:
        """Queue one prompt; returns a Future of :class:`GenerationResult`.

        Raises :class:`QueueFull` when the admission queue is at
        capacity and :class:`EngineClosed` after shutdown. ``trace``: a
        :class:`~distkeras_tpu_torch.telemetry.TraceContext` the
        request's spans chain under (default: the caller's current one).
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if prompt.size > self._buckets.max_size:
            raise ValueError(
                f"prompt length {prompt.size} exceeds the largest prefill "
                f"bucket {self._buckets.max_size}")
        mnt = (self.default_max_new_tokens if max_new_tokens is None
               else int(max_new_tokens))
        if mnt < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {mnt}")
        if prompt.size + mnt > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({mnt}) exceeds "
                f"max_len {self.max_len}")
        now = time.monotonic()
        deadline = None if timeout_ms is None else now + timeout_ms / 1e3
        req = _GenRequest(prompt, mnt,
                          self.eos_id if eos_id is None else eos_id,
                          stream, now, deadline,
                          trace=telemetry.current_trace()
                          if trace is None else trace)
        with self._cv:
            if self._closed:
                raise EngineClosed("engine is shut down; no new requests")
            if len(self._dq) >= self.queue_capacity:
                self._rejected_c.inc()
                telemetry.record_event("serving", outcome="rejected",
                                       depth=len(self._dq),
                                       capacity=self.queue_capacity)
                raise QueueFull(
                    f"generation queue at {len(self._dq)}/"
                    f"{self.queue_capacity}")
            self._dq.append(req)
            self._depth_g.set(len(self._dq))
            self._cv.notify()
        return req.future

    # -- scheduler ---------------------------------------------------------

    def _scheduler_loop(self) -> None:
        active = {}  # slot -> _GenRequest
        pending: list = []
        try:
            while True:
                with self._cv:
                    while not self._dq and not active \
                            and not self._closed:
                        self._cv.wait()
                    if self._closed and not self._drain:
                        pending = list(self._dq)
                        self._dq.clear()
                        self._depth_g.set(0)
                        break
                    if self._closed and not self._dq and not active:
                        return
                self._admit(active)
                self._expire(active)
                if active:
                    self._decode_group(active, sorted(active))
                    self._active_g.set(len(active))
        except BaseException as e:  # scheduler must never die silently
            self._loop_err_c.inc()
            telemetry.record_event("serving", outcome="loop_error",
                                   error=type(e).__name__,
                                   message=str(e)[:200])
            with self._cv:
                self._closed = True
                pending = list(self._dq)
                self._dq.clear()
                self._depth_g.set(0)
            err = EngineClosed(f"generation scheduler failed: {e!r}")
            for req in pending + list(active.values()):
                req.future.set_exception(err)
            for slot in list(active):
                self.pool.free(slot)
            raise
        # non-draining shutdown: fail everything still in flight
        err = EngineClosed("engine shut down without draining")
        for req in pending + list(active.values()):
            req.future.set_exception(err)
        for slot in list(active):
            self.pool.free(slot)
        self._active_g.set(0)

    def _admit(self, active) -> None:
        """Move queued requests into free slots (prefill each). Runs
        every iteration — admission interleaves with in-flight decode."""
        while self.pool.num_free > 0:
            with self._cv:
                if not self._dq:
                    return
                req = self._dq.popleft()
                self._depth_g.set(len(self._dq))
            now = time.monotonic()
            if req.deadline is not None and now > req.deadline:
                self._expired_c.inc()
                req.future.set_exception(DeadlineExceeded(
                    f"deadline passed {1e3 * (now - req.deadline):.1f} ms "
                    f"before admission"))
                continue
            if req.trace is not None:
                telemetry.record_trace_span(
                    req.trace, "trace.queue_wait", req.t_perf,
                    time.perf_counter() - req.t_perf)
            slot = self.pool.allocate()
            if not self.pool.reserve(
                    slot, min(req.prompt.size + req.max_new_tokens,
                              self.max_len)):
                # page exhaustion: leave the request at the queue head;
                # retiring sequences return pages and the next iteration
                # retries
                self.pool.free(slot)
                with self._cv:
                    self._dq.appendleft(req)
                    self._depth_g.set(len(self._dq))
                return
            self._prefill_paged(req, slot)
            self._admitted_c.inc()
            if self._emit(req, slot) is None:
                active[slot] = req
            self._active_g.set(len(active))

    def _prefill_paged(self, req: _GenRequest, slot: int) -> None:
        """One bucketed prefill call over the slot's pages; emits the
        first token."""
        n = req.prompt.size
        t0 = time.monotonic()
        tp0 = time.perf_counter()
        lb = self._buckets.bucket_for(n)
        ids = np.zeros((1, lb), np.int32)
        ids[0, :n] = req.prompt
        logits = self._run(self.pool.page_table_row(slot)[None, :], ids,
                           np.zeros(1, np.int32))
        row = logits[0, n - 1].float().cpu().numpy()
        self.pool.lengths[slot] = n
        tok = int(np.argmax(row))
        now = time.monotonic()
        self._prefills_c.inc()
        self._prefill_h.record(now - t0)
        self._ttft_h.record(now - req.t_submit)
        if req.trace is not None:
            telemetry.record_trace_span(
                req.trace, "trace.prefill", tp0,
                time.perf_counter() - tp0, bucket=lb, slot=slot)
        req.generated.append(tok)
        req.last_token = tok
        self._stream_token(req, tok)

    def _decode_group(self, active, slots) -> None:
        """Advance ``slots`` one token in one ladder-padded step. Padded
        lanes use the scratch slot (all-scratch page table, length 0)."""
        n = len(slots)
        lane = self._ladder.bucket_for(n)
        slot_ids = np.full(lane, self.pool.scratch_slot, np.int32)
        tokens = np.full((lane, 2), GHOST_TOKEN, np.int32)
        lengths = np.zeros(lane, np.int32)
        for i, s in enumerate(slots):
            slot_ids[i] = s
            tokens[i, 0] = active[s].last_token
            lengths[i] = self.pool.lengths[s]
        t0 = time.monotonic()
        tp0 = time.perf_counter()
        logits = self._run(self.pool.page_tables[slot_ids], tokens, lengths)
        rows = logits[:n, 0].float().cpu().numpy()  # waits for the step
        dt = time.monotonic() - t0
        dt_p = time.perf_counter() - tp0
        self._steps_c.inc()
        self._tokens_c.inc(n)
        self._step_h.record(dt)
        self._padded_h.record(lane - n)
        if dt > 0:
            self._tps_g.set(n / dt)
        for i, s in enumerate(slots):
            req = active[s]
            self.pool.lengths[s] += 1  # the fed token is now cached
            tok = int(np.argmax(rows[i]))
            req.generated.append(tok)
            req.last_token = tok
            if req.trace is not None:
                # one step serves every lane, so each traced request gets
                # the SHARED step interval
                telemetry.record_trace_span(
                    req.trace, "trace.decode", tp0, dt_p,
                    step=len(req.generated), lanes=lane)
            self._stream_token(req, tok)
            if self._emit(req, s) is not None:
                del active[s]

    def _emit(self, req: _GenRequest, slot: int) -> Optional[str]:
        """After a token lands, decide retirement. Returns the reason
        when the sequence finished (slot already freed), else None."""
        tok = req.last_token
        if req.eos_id is not None and tok == req.eos_id:
            reason = "eos"
        elif len(req.generated) >= req.max_new_tokens:
            reason = "length"
        elif self.pool.lengths[slot] >= self.max_len:
            # next feed would write at position max_len — context full
            reason = "max_len"
        else:
            return None
        self.pool.free(slot)
        telemetry.counter("serving.decode.retired", reason=reason).inc()
        if req.trace is not None:
            telemetry.record_trace_span(
                req.trace, "trace.request", req.t_perf,
                time.perf_counter() - req.t_perf, reason=reason,
                tokens=len(req.generated))
        req.future.set_result(
            GenerationResult(np.asarray(req.generated, np.int32), reason))
        return reason

    def _expire(self, active) -> None:
        """Fail in-flight sequences whose deadline passed mid-generation;
        their slots free immediately."""
        now = time.monotonic()
        for slot in list(active):
            req = active[slot]
            if req.deadline is not None and now > req.deadline:
                del active[slot]
                self.pool.free(slot)
                self._expired_c.inc()
                telemetry.counter("serving.decode.retired",
                                  reason="deadline").inc()
                if req.trace is not None:
                    telemetry.record_trace_span(
                        req.trace, "trace.request", req.t_perf,
                        time.perf_counter() - req.t_perf,
                        reason="deadline", tokens=len(req.generated))
                req.future.set_exception(DeadlineExceeded(
                    f"deadline passed after {len(req.generated)} tokens"))
        self._active_g.set(len(active))

    def _stream_token(self, req: _GenRequest, tok: int) -> None:
        if req.stream is None:
            return
        try:
            req.stream(tok)
        except Exception:
            # a broken consumer must not stall every in-flight sequence
            self._stream_err_c.inc()
            req.stream = None

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self, drain: bool = True, timeout: float = 60.0) -> None:
        with self._cv:
            self._closed = True
            self._drain = drain
            self._cv.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            telemetry.counter("serving.shutdown_timeouts").inc()
            with self._cv:
                pending = list(self._dq)
                self._dq.clear()
                self._depth_g.set(0)
            err = EngineClosed(
                f"scheduler still running after {timeout}s shutdown join")
            for req in pending:
                req.future.set_exception(err)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
