"""Continuous-batching generative serving (port of
``distkeras_tpu/serving/generation.py``).

- **prefill**: one bucketed call (the :class:`BucketSpec` ladder over
  prompt lengths) writes the prompt's K/V into the slot's cache and
  yields the first token; under ``prefill_chunk=`` (paged only) a prompt
  is instead fed one chunk a scheduler iteration, between decode steps;
- **decode**: every iteration advances ALL in-flight sequences by one
  token in a single step, the batch padded up to a **slot ladder**
  entry; each lane feeds ``[token, GHOST_TOKEN]`` at positions
  ``[len, len + 1]`` (the JAX package's ghost position, kept so that both
  packages run the same shapes); the ghost's output is discarded and its
  cell is dropped (rectangular pool) or overwritten by the next real
  token before it is ever visible (paged pool);
- **iteration-level scheduling**: queued requests are admitted between
  decode steps and finished ones (EOS / ``max_new_tokens`` / deadline /
  context full) retire mid-flight, freeing their slot and pages;
- **token choice**: greedy argmax, or under ``sampling=True`` one
  inverse-CDF draw from the host float64 tempered softmax on the
  request's own stream, ``np.random.default_rng([seed, submission
  index])``, so two engines fed the same requests in the same order draw
  the same tokens.

Two pools, as in the JAX package: the rectangular
:class:`~distkeras_tpu_torch.serving.kv_cache.KVCachePool` (the default,
``page_size=None``), stepped by :func:`make_prefill_fn` and
:func:`make_decode_fn`, whose attention is the plain masked softmax over
the whole row; and the paged
:class:`~distkeras_tpu_torch.serving.kv_cache.PagedKVCachePool`, stepped
by :func:`make_paged_step_fn` (prefill ``n=1, T=bucket``, a chunk ``n=1,
T=prefill_chunk``, decode ``T=2``) through the hand-written paged
kernel. Every step updates the pool in place.

**One CUDA graph per declared shape** (the counterpart of the JAX
engine's ``_compile_all``: nothing compiles after ``__init__``). The
constructor makes one runner per prefill bucket, per ladder entry and
for the chunk width (unless a bucket has that width, whose runner it
shares), each counted on ``serving.decode.compiles`` under a
``serving.decode.compile`` span. A runner holds the step's static
device inputs; on a CUDA device it also holds pinned host staging
buffers and the graph, captured on the engine's own stream after one
eager run there (which builds the kernel; the paged kernel's arrival
counters for that stream are reserved before the first capture). The
engine's graphs share one memory pool, since they run in turn. A call
copies the host arrays into the static inputs, replays the graph, and
copies to the host only the logits rows the token choice needs, before
the next replay. A replay adds the paged calls its graph captured to
``paged_flash_attention.launches``. A capture that fails raises
out of the constructor; nothing falls back to eager launches. On the
CPU, used only when the caller names it, a runner calls the step eagerly
on the same static buffers. :attr:`GenerationEngine.compiled_executables`
lists the shapes; no other shape can occur, because the ladder covers
every in-flight count.

Backpressure and deadlines keep the JAX package's semantics and typed
errors: a bounded admission queue (:class:`QueueFull`), page exhaustion
leaves the request at the queue head until pages return, deadlines are
checked at admission and between decode steps
(:class:`DeadlineExceeded`), :class:`EngineClosed` after shutdown.

Not ported yet (each raises NotImplementedError naming its ROADMAP.md
Queue A item): the prefix cache, speculative decoding, int8 KV pages.
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
from distkeras_tpu_torch.ops.kernels import flash_attention as fa
from distkeras_tpu_torch.serving.batching import (DeadlineExceeded,
                                                  EngineClosed, QueueFull)
from distkeras_tpu_torch.serving.buckets import BucketSpec
from distkeras_tpu_torch.serving.kv_cache import (KVCachePool,
                                                  PagedKVCachePool)

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


def make_prefill_fn(model):
    """``(pool, ids[1, Lb], slot[1] int64, length[1] int32) ->
    last_logits[V]``: run the prompt through a zeroed cache row at
    ``cache_index=0``, copy the row into pool row ``slot`` IN PLACE, and
    return the logits at position ``length - 1`` (the first-token
    distribution), gathered on the device so that one shape serves every
    length. Bucket padding beyond ``length`` writes cells the length
    mask hides until real tokens overwrite them."""

    @torch.no_grad()
    def prefill(pool, ids, slot, length):
        row = tuple({name: torch.zeros((1,) + a.shape[1:], dtype=a.dtype,
                                       device=a.device)
                     for name, a in layer.items()} for layer in pool)
        zero = torch.zeros(1, dtype=torch.int32, device=ids.device)
        logits, row = model(ids, cache=row, cache_index=zero)
        for layer, new in zip(pool, row):
            for name, a in layer.items():
                a.index_copy_(0, slot, new[name])
        return logits[0].index_select(0, length.long() - 1)[0]

    return prefill


def make_decode_fn(model):
    """``(pool, slot_ids[n], tokens[n], lengths[n]) -> logits[n, V]``:
    advance ``n`` lanes one token. Each lane's row is gathered
    (``pool[slot_ids]``, the JAX package's data movement) and fed
    ``[token, GHOST_TOKEN]`` at positions ``[len, len + 1]``; only the
    real cell ``[slot, len]`` is scattered back IN PLACE (dropped at
    ``len >= max_len``), and only its logits returned. Padded lanes
    point at the scratch row with length 0; their writes land there and
    their outputs are discarded by the caller."""

    @torch.no_grad()
    def decode(pool, slot_ids, tokens, lengths):
        rows_of = slot_ids.long()
        rows = tuple({name: a[rows_of] for name, a in layer.items()}
                     for layer in pool)
        ids = torch.stack([tokens, torch.full_like(tokens, GHOST_TOKEN)],
                          dim=1)
        logits, rows = model(ids, cache=rows, cache_index=lengths)
        max_len = pool[0]["k"].shape[1]
        lane = torch.arange(slot_ids.shape[0], device=slot_ids.device)
        col = lengths.long().clamp(max=max_len - 1)
        real = (lengths.long() < max_len)[:, None, None]
        for layer, new in zip(pool, rows):
            for name, a in layer.items():
                a[rows_of, col] = torch.where(real, new[name][lane, col],
                                              a[rows_of, col])
        return logits[:, 0]

    return decode


def make_paged_step_fn(model):
    """``(pages, page_tables[n, Pmax], tokens[n, T], lengths[n]) ->
    (pages, logits[n, T, V])`` for every paged phase: prefill is
    ``n=1, T=bucket`` at ``lengths=[start]``, a chunk ``n=1,
    T=prefill_chunk`` at ``lengths=[cursor]``, decode ``T=2`` (token +
    ghost). ``pages`` is updated in place and returned; ``page_tables``
    and ``lengths`` are int32 tensors on the model's device."""

    @torch.no_grad()
    def step(pages, page_tables, tokens, lengths):
        logits, pages = model(tokens, cache=pages, cache_index=lengths,
                              page_table=page_tables)
        return pages, logits

    return step


class _StepRunner:
    """One declared shape of a step (module docstring): ``fn(pool,
    **inputs) -> out`` over static input tensors made from ``inputs``
    (numpy arrays that point every lane at the scratch slot or page, so
    that the eager run before the capture and :meth:`warm` touch no
    live cell). With a ``stream`` (a CUDA device) the graph is captured
    here, its memory drawn from ``graph_pool``, which the engine's
    graphs share: ``out`` then holds until the engine's next replay,
    which may reuse its memory, so the caller fetches what it needs of
    it first. Without a stream (the CPU) each call runs ``fn``
    eagerly."""

    def __init__(self, fn, pool, inputs: dict, device, stream=None,
                 graph_pool=None):
        self._fn = fn
        self._pool = pool
        self._inputs = inputs
        self._static = {k: torch.from_numpy(v.copy()).to(device)
                        for k, v in inputs.items()}
        self._stream = stream
        self._graph = None
        #: paged-kernel calls one replay makes (counted at the capture)
        self.launches = 0
        self.out = None
        if stream is None:
            return
        self._host = {k: torch.from_numpy(v.copy()).pin_memory()
                      for k, v in inputs.items()}
        self._copied = torch.cuda.Event()
        torch.cuda.synchronize(device)  # the static inputs have landed
        with torch.cuda.stream(stream):
            fn(pool, **self._static)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        before = fa.paged_flash_attention.captured
        # thread_local: other threads' CUDA calls (another engine's
        # scheduler) stay legal while this thread captures
        with torch.cuda.graph(graph, pool=graph_pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.out = fn(pool, **self._static)
        # a capture launches nothing: its calls are counted per replay
        self.launches = fa.paged_flash_attention.captured - before
        self._graph = graph

    def __call__(self, **arrays) -> torch.Tensor:
        if self._graph is None:
            for k, a in arrays.items():
                self._static[k].copy_(torch.from_numpy(a))
            self.out = self._fn(self._pool, **self._static)
            return self.out
        # the previous call's copies must have read the staging buffers
        self._copied.synchronize()
        with torch.cuda.stream(self._stream):
            for k, a in arrays.items():
                self._host[k].numpy()[...] = a
                self._static[k].copy_(self._host[k], non_blocking=True)
            self._copied.record()
            self._graph.replay()
        fa.paged_flash_attention.launches += self.launches
        return self.out

    def fetch(self, index) -> np.ndarray:
        """``out[index]`` on the host as float32, once the step has run."""
        if self._graph is None:
            return self.out[index].float().numpy()
        with torch.cuda.stream(self._stream):
            return self.out[index].float().cpu().numpy()

    def warm(self) -> None:
        """One call on the scratch inputs, so no request pays a first
        replay's costs."""
        self(**self._inputs)
        if self._stream is not None:
            self._stream.synchronize()


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
                 "t_perf", "rng", "prefill_pos")

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
        #: the request's sampling stream (sampling=True only)
        self.rng = None
        #: chunked prefill cursor: prompt tokens already cached
        self.prefill_pos = 0


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue A, item {item})")


class GenerationEngine:
    """Iteration-level continuous-batching decode loop.

    ``generate()`` is thread-safe and returns a Future of
    :class:`GenerationResult`; an optional ``stream`` callback receives
    each token as it is emitted (called on the scheduler thread — it
    must not block). One scheduler thread owns the pool, the runners and
    all host-side accounting.

    ``model`` is a :class:`~distkeras_tpu_torch.models.gpt.CausalLM`
    holding its weights; the engine moves it to ``device`` (default
    ``cuda:0``; ``"cpu"`` only when asked) and puts it in eval mode.
    ``page_size=None`` (the default) serves from the rectangular pool,
    an int from the paged pool. ``warmup`` runs every declared shape
    once after its capture.
    """

    def __init__(self, model, *, num_slots: int = 4,
                 slot_ladder: Optional[Sequence[int]] = None,
                 prefill_buckets: Sequence[int] = (8, 32),
                 queue_capacity: int = 64,
                 default_max_new_tokens: int = 32,
                 eos_id: Optional[int] = None,
                 device=None, dtype=None, hbm_fraction: float = 0.8,
                 warmup: bool = True,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache_bytes: int = 0,
                 draft=None, spec_k: int = 0,
                 prefill_chunk: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 sampling: bool = False, temperature: float = 1.0,
                 seed: int = 0):
        if prefix_cache_bytes:
            raise _not_ported("the prefix cache (prefix_cache_bytes)", 2)
        if draft is not None or spec_k:
            raise _not_ported("speculative decoding (draft/spec_k)", 3)
        if kv_dtype == "int8":
            raise _not_ported("int8 KV pages (kv_dtype='int8')", 5)
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
        self._paged = page_size is not None
        self._chunk = None if prefill_chunk is None else int(prefill_chunk)
        if self._chunk is not None:
            if not self._paged:
                raise ValueError(
                    "prefill_chunk requires page_size: chunked prefill "
                    "rides the paged step family's mid-sequence prefill")
            if self._chunk < 2:
                raise ValueError(
                    f"prefill_chunk must be >= 2, got {prefill_chunk}")
            if self._chunk > self.max_len:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} exceeds model "
                    f"max_len {self.max_len}")
        if kv_dtype is not None and not self._paged:
            raise ValueError(
                "kv_dtype requires page_size: quantized KV is a "
                "page-pool format")
        self._sampling = bool(sampling)
        self._temperature = float(temperature)
        if self._sampling and self._temperature <= 0:
            raise ValueError(
                f"temperature must be > 0, got {temperature}")
        self._seed = int(seed)
        self._req_seq = 0  # submission index: per-request stream ids
        if self._paged:
            self.pool = PagedKVCachePool(
                model, num_slots, page_size=page_size, num_pages=num_pages,
                device=device, dtype=dtype, kv_dtype=kv_dtype,
                hbm_fraction=hbm_fraction)
        else:
            self.pool = KVCachePool(model, num_slots, device=device,
                                    dtype=dtype, hbm_fraction=hbm_fraction)
        self.device = self.pool.device
        model.to(self.device).eval()
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
        if self._chunk is not None:
            # created only when chunking is on, as in the JAX engine
            self._chunk_admits_c = telemetry.counter(
                "serving.decode.chunk.admitted")
            self._chunk_steps_c = telemetry.counter(
                "serving.decode.chunk.steps")
            self._chunk_depth_g = telemetry.gauge(
                "serving.decode.chunk.queue_depth")
            self._chunk_depth_g.set(0)

        self._compile_all(gpt.inference_copy(model))
        if warmup:
            self._warmup()
        self._thread = threading.Thread(target=self._scheduler_loop,
                                        name="generation-scheduler",
                                        daemon=True)
        self._thread.start()

    # -- one runner (a CUDA graph on the card) per declared shape ----------

    def _compile_all(self, serve_model) -> None:
        """Make exactly one runner per prefill bucket, one per ladder
        entry and one for the chunk width (shared with a bucket of that
        width), up front (module docstring). On a CUDA device each
        captures its graph on the engine's stream; ``graph_pool_bytes``
        is the device memory the runners then hold (the graphs' pools and
        the static inputs)."""
        cuda = self.device.type == "cuda"
        #: the stream every capture and replay of this engine runs on
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        #: the memory pool the engine's graphs share (they run in turn)
        graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved(self.device)
            if self._paged:
                # the paged kernel's arrival counters for this stream,
                # sized for its widest call, before any capture
                h = self.model.num_heads
                widths = list(self._buckets) + [self._chunk or 0]
                fa.reserve_counters(self.device, self.stream.cuda_stream, max(
                    [fa.counters_needed(1, w, h) for w in widths]
                    + [fa.counters_needed(n, 2, h) for n in self._ladder]))
        compiles = telemetry.counter("serving.decode.compiles")
        scratch = self.pool.scratch_slot

        def runner(fn, **inputs):
            return _StepRunner(fn, self.pool.pool, inputs, self.device,
                               self.stream, graph_pool)

        self._prefill_runs = {}
        self._decode_runs = {}
        self._chunk_run = None
        if self._paged:
            step = make_paged_step_fn(serve_model)
            fn = lambda pool, **kw: step(pool, **kw)[1]  # noqa: E731
            spt = self.pool.page_tables[scratch]
            paged = lambda n, t: runner(  # noqa: E731
                fn, page_tables=np.tile(spt, (n, 1)),
                tokens=np.zeros((n, t), np.int32),
                lengths=np.zeros(n, np.int32))
            for lb in self._buckets:
                with telemetry.span("serving.decode.compile", prefill=lb):
                    self._prefill_runs[lb] = paged(1, lb)
                compiles.inc()
            if self._chunk is not None:
                if self._chunk in self._prefill_runs:
                    # a chunk the width of a bucket is the same shape
                    self._chunk_run = self._prefill_runs[self._chunk]
                else:
                    with telemetry.span("serving.decode.compile",
                                        prefill_chunk=self._chunk):
                        self._chunk_run = paged(1, self._chunk)
                    compiles.inc()
            for n in self._ladder:
                with telemetry.span("serving.decode.compile", lanes=n):
                    self._decode_runs[n] = paged(n, 2)
                compiles.inc()
        else:
            prefill = make_prefill_fn(serve_model)
            decode = make_decode_fn(serve_model)
            for lb in self._buckets:
                with telemetry.span("serving.decode.compile", prefill=lb):
                    self._prefill_runs[lb] = runner(
                        prefill, ids=np.zeros((1, lb), np.int32),
                        slot=np.full(1, scratch, np.int64),
                        length=np.full(1, lb, np.int32))
                compiles.inc()
            for n in self._ladder:
                with telemetry.span("serving.decode.compile", lanes=n):
                    self._decode_runs[n] = runner(
                        decode, slot_ids=np.full(n, scratch, np.int32),
                        tokens=np.zeros(n, np.int32),
                        lengths=np.zeros(n, np.int32))
                compiles.inc()
        self.graph_pool_bytes = 0
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            self.graph_pool_bytes = (torch.cuda.memory_reserved(self.device)
                                     - reserved0)

    def _warmup(self) -> None:
        """Run every shape once against the scratch slot/page (scratch
        garbage is fine: reads are masked by per-slot lengths)."""
        with telemetry.span("serving.decode.warmup"):
            for run in self._runners():
                run.warm()

    def _runners(self):
        runs = list(self._prefill_runs.values())
        runs += list(self._decode_runs.values())
        if self._chunk_run is not None \
                and self._chunk not in self._prefill_runs:
            runs.append(self._chunk_run)
        return runs

    @property
    def compiled_executables(self):
        """{"prefill": bucket sizes, "decode": lane widths}, plus
        ``"prefill_chunk"`` under chunked prefill: the shapes made in
        ``__init__`` (CUDA graphs on the card), the only ones any
        request runs. Never grows."""
        execs = {"prefill": tuple(sorted(self._prefill_runs)),
                 "decode": tuple(sorted(self._decode_runs))}
        if self._chunk_run is not None:
            execs["prefill_chunk"] = (self._chunk,)
        return execs

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
            if self._sampling:
                # stream id = (engine seed, submission index): two
                # engines fed the same requests in the same order draw
                # identical streams
                req.rng = np.random.default_rng([self._seed,
                                                 self._req_seq])
                self._req_seq += 1
            self._dq.append(req)
            self._depth_g.set(len(self._dq))
            self._cv.notify()
        return req.future

    # -- scheduler ---------------------------------------------------------

    def _scheduler_loop(self) -> None:
        active = {}      # slot -> _GenRequest (decoding)
        prefilling = {}  # slot -> _GenRequest (chunked prefill cursor)
        pending: list = []
        try:
            while True:
                with self._cv:
                    while not self._dq and not active and not prefilling \
                            and not self._closed:
                        self._cv.wait()
                    if self._closed and not self._drain:
                        pending = list(self._dq)
                        self._dq.clear()
                        self._depth_g.set(0)
                        break
                    if self._closed and not self._dq and not active \
                            and not prefilling:
                        return
                self._admit(active, prefilling)
                self._expire(active, prefilling)
                if prefilling:
                    self._chunk_step(active, prefilling)
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
            self._fail_all(EngineClosed(f"generation scheduler failed: "
                                        f"{e!r}"), pending, active,
                           prefilling)
            raise
        # non-draining shutdown: fail everything still in flight
        self._fail_all(EngineClosed("engine shut down without draining"),
                       pending, active, prefilling)
        self._active_g.set(0)

    def _fail_all(self, err, pending, active, prefilling) -> None:
        for req in (pending + list(active.values())
                    + list(prefilling.values())):
            req.future.set_exception(err)
        for slot in list(active) + list(prefilling):
            self.pool.free(slot)

    def _admit(self, active, prefilling) -> None:
        """Move queued requests into free slots (prefill each). Runs
        every iteration — admission interleaves with in-flight decode.
        Under chunked prefill a request parks in ``prefilling`` with a
        cursor instead of paying its whole prefill here."""
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
            if self._paged and not self.pool.reserve(
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
            self._admitted_c.inc()
            if self._chunk is not None:
                self.pool.lengths[slot] = 0
                req.prefill_pos = 0
                prefilling[slot] = req
                self._chunk_admits_c.inc()
                self._chunk_depth_g.set(len(prefilling))
                continue
            if self._paged:
                self._prefill_paged(req, slot)
            else:
                self._prefill(req, slot)
            if self._emit(req, slot) is None:
                active[slot] = req
            self._active_g.set(len(active))

    def _bucket_ids(self, tokens) -> Tuple[int, np.ndarray]:
        lb = self._buckets.bucket_for(tokens.size)
        ids = np.zeros((1, lb), np.int32)
        ids[0, :tokens.size] = tokens
        return lb, ids

    def _prefill(self, req: _GenRequest, slot: int) -> None:
        """Rectangular admission: one bucketed prefill into ``slot``'s
        row; emits the first token."""
        n = req.prompt.size
        t0 = time.monotonic()
        tp0 = time.perf_counter()
        lb, ids = self._bucket_ids(req.prompt)
        run = self._prefill_runs[lb]
        run(ids=ids, slot=np.full(1, slot, np.int64),
            length=np.full(1, n, np.int32))
        self._finish_prefill(req, slot, run.fetch(...), t0, tp0, bucket=lb)

    def _prefill_paged(self, req: _GenRequest, slot: int) -> None:
        """Paged admission: one bucketed prefill call over the slot's
        pages; emits the first token."""
        n = req.prompt.size
        t0 = time.monotonic()
        tp0 = time.perf_counter()
        lb, ids = self._bucket_ids(req.prompt)
        run = self._prefill_runs[lb]
        run(page_tables=self.pool.page_table_row(slot)[None, :],
            tokens=ids, lengths=np.zeros(1, np.int32))
        self._finish_prefill(req, slot, run.fetch((0, n - 1)), t0, tp0,
                             bucket=lb)

    def _finish_prefill(self, req: _GenRequest, slot: int, logits_row,
                        t0: float, tp0: float, **span) -> None:
        """Shared tail of every prefill path (one-shot, chunked): the
        first-token pick, TTFT accounting, stream."""
        self.pool.lengths[slot] = req.prompt.size
        tok = self._pick_token(req, logits_row)
        now = time.monotonic()
        self._prefills_c.inc()
        self._prefill_h.record(now - t0)
        self._ttft_h.record(now - req.t_submit)
        if req.trace is not None:
            telemetry.record_trace_span(
                req.trace, "trace.prefill", tp0,
                time.perf_counter() - tp0, slot=slot, **span)
        req.generated.append(tok)
        req.last_token = tok
        self._stream_token(req, tok)

    def _chunk_step(self, active, prefilling) -> None:
        """Advance every partially-prefilled slot by ONE chunk: a
        ``T=prefill_chunk`` paged call at the slot's cursor
        (``lengths=[cursor]``), so a long prompt costs each in-flight
        decoder one chunk of latency per iteration instead of the whole
        prefill at once. A slot enters the decode set only when its
        cursor covers the prompt; the final chunk's row at the last
        prompt token is the first-token distribution."""
        for slot in sorted(prefilling):
            req = prefilling[slot]
            n = req.prompt.size
            pos = req.prefill_pos
            t0 = time.monotonic()
            tp0 = time.perf_counter()
            chunk = req.prompt[pos:pos + self._chunk]
            ids = np.zeros((1, self._chunk), np.int32)
            ids[0, :chunk.size] = chunk
            self._chunk_run(page_tables=self.pool.page_table_row(slot)[None],
                            tokens=ids, lengths=np.full(1, pos, np.int32))
            self._chunk_steps_c.inc()
            req.prefill_pos = pos + chunk.size
            self.pool.lengths[slot] = req.prefill_pos
            if req.prefill_pos >= n:
                del prefilling[slot]
                self._finish_prefill(
                    req, slot, self._chunk_run.fetch((0, n - pos - 1)), t0,
                    tp0, chunk=self._chunk)
                if self._emit(req, slot) is None:
                    active[slot] = req
                self._active_g.set(len(active))
        self._chunk_depth_g.set(len(prefilling))

    def _pick_token(self, req: _GenRequest, logits_row) -> int:
        """Greedy argmax, or under ``sampling=True`` ONE inverse-CDF draw
        from the tempered softmax on the request's own seeded stream
        (one uniform per emitted token, in emission order). The host
        float64 softmax and cumsum keep the CDF deterministic across
        engines fed the same float32 logits."""
        if not self._sampling:
            return int(np.argmax(logits_row))
        z = np.asarray(logits_row, np.float64) / self._temperature
        z -= z.max()
        p = np.exp(z)
        cdf = np.cumsum(p / p.sum())
        u = req.rng.random()
        return int(min(np.searchsorted(cdf, u, side="right"),
                       cdf.size - 1))

    def _decode_group(self, active, slots) -> None:
        """Advance ``slots`` one token in one ladder-padded step. Padded
        lanes use the scratch slot (length 0; in the paged pool its
        all-scratch page table)."""
        n = len(slots)
        lane = self._ladder.bucket_for(n)
        run = self._decode_runs[lane]
        slot_ids = np.full(lane, self.pool.scratch_slot, np.int32)
        tokens = np.full((lane, 2), GHOST_TOKEN, np.int32)
        lengths = np.zeros(lane, np.int32)
        for i, s in enumerate(slots):
            slot_ids[i] = s
            tokens[i, 0] = active[s].last_token
            lengths[i] = self.pool.lengths[s]
        t0 = time.monotonic()
        tp0 = time.perf_counter()
        if self._paged:
            run(page_tables=self.pool.page_tables[slot_ids], tokens=tokens,
                lengths=lengths)
            rows = run.fetch((slice(0, n), 0))  # waits for the step
        else:
            run(slot_ids=slot_ids, tokens=tokens[:, 0].copy(),
                lengths=lengths)
            rows = run.fetch(slice(0, n))
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
            tok = self._pick_token(req, rows[i])
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

    def _expire(self, active, prefilling) -> None:
        """Fail sequences whose deadline passed mid-generation (or
        mid-chunked-prefill); their slots free immediately."""
        now = time.monotonic()
        for group in (active, prefilling):
            for slot in list(group):
                req = group[slot]
                if req.deadline is not None and now > req.deadline:
                    del group[slot]
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
                        f"deadline passed after {len(req.generated)} "
                        f"tokens"))
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
