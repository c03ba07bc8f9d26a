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
shares), and under the options below one verify runner per ladder
entry, the swap pair and a model draft's own, each counted on
``serving.decode.compiles`` under a ``serving.decode.compile`` span. A
runner holds the step's static device inputs; on a CUDA device it also
holds pinned host staging buffers and the graph, captured on the
engine's own stream after one eager run there (which builds the
kernel; the paged kernel's arrival counters for that stream are
reserved before the first capture). The engine's graphs share one
memory pool, since they run in turn. A call
copies the host arrays into the static inputs, replays the graph, and
copies to the host only the logits rows the token choice needs, before
the next replay. A replay adds the kernel calls its graph captured
(paged attention; the flash forward in a
:class:`~distkeras_tpu_torch.serving.engine.ServingEngine` graph) to each
wrapper's ``launches``. A capture that fails raises
out of the constructor; nothing falls back to eager launches. On the
CPU, used only when the caller names it, a runner calls the step eagerly
on the same static buffers. :attr:`GenerationEngine.compiled_executables`
lists the shapes; no other shape can occur, because the ladder covers
every in-flight count.

**Two weight banks** (live rollout, :mod:`~distkeras_tpu_torch.serving.
rollout`): the runners above exist once in each of two banks, each a
serving copy of the model (:func:`~distkeras_tpu_torch.models.gpt.
inference_copy`), all captured in ``__init__``. A slot pins the version
it was admitted on; decode groups slots by version and runs each group
on its bank. :meth:`GenerationEngine.swap_weights` hands the new float32
masters to the scheduler, which casts them in place into the bank that
no slot pins, between two iterations, and makes it current: a swap
never captures. The swap pair of the prefix cache and a draft's runners
read no swapped weight and exist once.

Backpressure and deadlines keep the JAX package's semantics and typed
errors: a bounded admission queue (:class:`QueueFull`), page exhaustion
leaves the request at the queue head until pages return, deadlines are
checked at admission and between decode steps
(:class:`DeadlineExceeded`), :class:`EngineClosed` after shutdown.

Three more options of the JAX engine, each with its own declared shapes,
all made in ``__init__``:

- ``prefix_cache_bytes=`` (paged only): a host-RAM
  :class:`~distkeras_tpu_torch.serving.kv_cache.PrefixCache` of
  content-hashed KV prefixes. Admission looks the prompt up; a hit
  scatters the parked pages into the slot's reservation (the swap-in
  graph, fixed ``[pages_per_slot]`` ids, unused ones on the scratch
  page) and prefills only the tail at ``lengths=[start]`` on the
  prefill graphs; a full hit with parked logits emits the first token
  with no model call. A finished prefill and a retiring conversation
  are parked through the swap-out graph (a gather) and one copy into a
  new page-locked host buffer from torch's caching host allocator
  (which keeps freed blocks for reuse: up to about twice the budget
  stays pinned), from which a swap-in copies straight to the card.
  ``export_prefix``/``import_prefix`` hand entries to and from other
  threads through the scheduler thread.
- ``kv_dtype="int8"`` (paged only): int8 pages with per-page float32
  scales (:func:`~distkeras_tpu_torch.models.gpt._paged_int8_attention`).
- ``draft=``/``spec_k=``: speculative decoding. The draft
  (:class:`NgramDraft` on the host, or :class:`ModelDraft`, a smaller
  model with its own rectangular pool and graphs) proposes ``spec_k``
  tokens a lane, one verify call (``T = spec_k + 1``, a graph per
  ladder entry) scores them, and the host walks the accept/reject rule:
  greedy tokens are those of plain greedy decode, sampled streams those
  of plain sampled decode under the same seed.
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
                                                  PagedKVCachePool,
                                                  PrefixCache, tree_leaves)
from distkeras_tpu_torch.utils import fault

#: token id fed at the decode step's ghost position (its output is
#: discarded, so any valid id works)
GHOST_TOKEN = 0


def _counted_kernels() -> tuple:
    """The kernel wrappers a captured graph may call (looked up at each
    capture, so a wrapper swapped in for a test is the one counted); a
    replay adds the calls its capture recorded to each one's
    ``launches``."""
    return fa.paged_flash_attention, fa.flash_attention_fwd


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


def make_verify_fn(model):
    """``(pool, slot_ids[n], tokens[n, T], lengths[n]) -> logits[n, T,
    V]``: the speculative verify step over the rectangular pool. Each
    lane feeds ``[pending, d_1 .. d_{T-1}]`` at positions ``len ..
    len + T - 1``; ALL T cells are scattered back IN PLACE (accepted
    cells are what sequential decode writes; rejected ones lie past the
    post-accept length, masked until overwritten). A position ``>=
    max_len`` is written to the row's last cell with the value the
    model's row holds there, which is that cell's own (the JAX package
    drops it)."""

    @torch.no_grad()
    def verify(pool, slot_ids, tokens, lengths):
        rows_of = slot_ids.long()
        rows = tuple({name: a[rows_of] for name, a in layer.items()}
                     for layer in pool)
        logits, rows = model(tokens, cache=rows, cache_index=lengths)
        n, t = tokens.shape
        max_len = pool[0]["k"].shape[1]
        lane = torch.arange(n, device=slot_ids.device)[:, None]
        col = (lengths.long()[:, None]
               + torch.arange(t, device=slot_ids.device)[None, :]).clamp(
            max=max_len - 1)
        for layer, new in zip(pool, rows):
            for name, a in layer.items():
                a[rows_of[:, None], col] = new[name][lane, col]
        return logits

    return verify


def make_swap_out_fn():
    """``(pages, page_ids[Pmax]) -> leaves``: gather the named pages of
    every pool leaf (:func:`~distkeras_tpu_torch.serving.kv_cache.
    tree_leaves` order) for host parking; unused ids point at scratch."""

    @torch.no_grad()
    def swap_out(pages, page_ids):
        ids = page_ids.long()
        return tuple(a[ids] for a in tree_leaves(pages))

    return swap_out


def make_swap_in_fn():
    """``(pages, page_ids[Pmax], leaves) -> pages``: scatter parked page
    data back into the pool IN PLACE. Unused ids point at scratch, so
    their rows collide only on the scratch page."""

    @torch.no_grad()
    def swap_in(pages, page_ids, leaves):
        ids = page_ids.long()
        for a, d in zip(tree_leaves(pages), leaves):
            a[ids] = d
        return pages

    return swap_in


def _unflatten(pool, leaves):
    """``leaves`` (:func:`tree_leaves` order) in ``pool``'s structure."""
    it = iter(leaves)
    return tuple({name: next(it) for name in sorted(layer)}
                 for layer in pool)


class NgramDraft:
    """Prompt-lookup drafting (host only): propose the k tokens that
    followed the most recent earlier occurrence of the context's final
    ``ngram``-gram; with no match, the last token repeated (a proposal
    is always exactly k tokens: the verify shape is fixed). Draft
    quality moves the accept rate only, never the tokens."""

    def __init__(self, ngram: int = 2):
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.ngram = int(ngram)
        self._ctx: dict = {}

    def bind(self, engine) -> None:  # noqa: ARG002 - uniform draft API
        """Nothing to capture: the draft is host work."""

    def begin(self, slot: int, prompt, first_token: int) -> None:
        self._ctx[slot] = [int(t) for t in prompt] + [int(first_token)]

    def propose(self, slots, last_tokens, lengths, k: int) -> np.ndarray:
        del last_tokens, lengths  # the host context already ends on them
        out = np.zeros((len(slots), k), np.int32)
        for i, s in enumerate(slots):
            out[i] = self._propose_one(self._ctx[s], k)
        return out

    def _propose_one(self, ctx, k: int):
        n = self.ngram
        props: list = []
        if len(ctx) > n:
            tail = ctx[-n:]
            for start in range(len(ctx) - n - 1, -1, -1):
                if ctx[start:start + n] == tail:
                    props = ctx[start + n:start + n + k]
                    break
        while len(props) < k:
            props.append(props[-1] if props else ctx[-1])
        return np.asarray(props[:k], np.int32)

    def observe(self, slot: int, emitted) -> None:
        self._ctx[slot].extend(int(t) for t in emitted)

    def release(self, slot: int) -> None:
        self._ctx.pop(slot, None)


class ModelDraft:
    """Draft-model proposals: a smaller
    :class:`~distkeras_tpu_torch.models.gpt.CausalLM` (holding its
    weights) runs k + 1 greedy decode steps to propose k tokens. It keeps
    its OWN rectangular pool indexed by the target's slot ids and always
    feeds at the target's lengths, so its cache follows the accepted
    sequence; a stale draft cell can only lower the accept rate.

    ``bind`` makes one prefill runner per prompt bucket and one decode
    runner per ladder entry on the engine's stream and graph pool (CUDA
    graphs on the card), counted on ``serving.decode.compiles``, and
    runs each once on the scratch row."""

    def __init__(self, model, *, dtype=None):
        self.model = model
        self._dtype = dtype
        self._cache = None

    def bind(self, engine) -> None:
        if int(self.model.max_len) < engine.max_len:
            raise ValueError(
                f"draft max_len {self.model.max_len} < target max_len "
                f"{engine.max_len}; the draft must cover every position "
                f"the target can reach")
        self._buckets = engine._buckets
        self._ladder = engine._ladder
        self._scratch = engine.pool.num_slots
        self.model.to(engine.device).eval()
        serve = gpt.inference_copy(self.model)
        self._cache = gpt.init_cache(self.model, engine.pool.num_slots + 1,
                                     self._dtype, device=engine.device)
        self._lengths = np.zeros(engine.pool.num_slots + 1, np.int32)
        prefill, decode = make_prefill_fn(serve), make_decode_fn(serve)
        compiles = telemetry.counter("serving.decode.compiles")
        self._prefill_runs, self._decode_runs = {}, {}
        for lb in self._buckets:
            with telemetry.span("serving.decode.compile", draft_prefill=lb):
                self._prefill_runs[lb] = engine._runner(
                    prefill, self._cache, ids=np.zeros((1, lb), np.int32),
                    slot=np.full(1, self._scratch, np.int64),
                    length=np.full(1, lb, np.int32))
            compiles.inc()
        for n in self._ladder:
            with telemetry.span("serving.decode.compile", draft_lanes=n):
                self._decode_runs[n] = engine._runner(
                    decode, self._cache,
                    slot_ids=np.full(n, self._scratch, np.int32),
                    tokens=np.zeros(n, np.int32),
                    lengths=np.zeros(n, np.int32))
            compiles.inc()
        for run in (*self._prefill_runs.values(),
                    *self._decode_runs.values()):
            run.warm()

    @property
    def compiled_executables(self):
        return {"prefill": tuple(sorted(self._prefill_runs)),
                "decode": tuple(sorted(self._decode_runs))}

    def free_device(self) -> None:
        """Free the draft's graphs and cache (its engine shut down)."""
        for run in (*self._prefill_runs.values(),
                    *self._decode_runs.values()):
            run.free()
        self._cache = None

    def begin(self, slot: int, prompt, first_token: int) -> None:
        del first_token  # arrives as last_tokens at the next propose
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n = prompt.size
        lb = self._buckets.bucket_for(n)
        ids = np.zeros((1, lb), np.int32)
        ids[0, :n] = prompt
        self._prefill_runs[lb](ids=ids, slot=np.full(1, slot, np.int64),
                               length=np.full(1, n, np.int32))
        self._lengths[slot] = n

    def propose(self, slots, last_tokens, lengths, k: int) -> np.ndarray:
        n = len(slots)
        lane = self._ladder.bucket_for(n)
        run = self._decode_runs[lane]
        out = np.zeros((n, k), np.int32)
        feed = np.asarray(last_tokens, np.int32).copy()
        lens_live = np.asarray(lengths, np.int32).copy()
        # k proposal feeds and one that caches the last proposal, so that
        # a full accept leaves the draft cache complete
        for step in range(k + 1):
            slot_ids = np.full(lane, self._scratch, np.int32)
            toks = np.full(lane, GHOST_TOKEN, np.int32)
            lens = np.zeros(lane, np.int32)
            slot_ids[:n] = slots
            toks[:n] = feed
            lens[:n] = lens_live
            run(slot_ids=slot_ids, tokens=toks, lengths=lens)
            lens_live += 1
            if step < k:
                feed = np.argmax(run.fetch(slice(0, n)), axis=-1).astype(
                    np.int32)
                out[:, step] = feed
        self._lengths[list(slots)] = lens_live
        return out

    def observe(self, slot: int, emitted) -> None:
        """The draft feeds at the target's lengths: acceptance needs no
        rollback here."""

    def release(self, slot: int) -> None:
        self._lengths[slot] = 0


class _StepRunner:
    """One declared shape of a step (module docstring): ``fn(pool,
    **inputs) -> out`` over static input tensors made from ``inputs``
    (numpy arrays or CPU tensors that point every lane at the scratch
    slot or page, so that the eager run before the capture and
    :meth:`warm` touch no live cell). A call may pass fewer leading rows
    than an input holds; the rest keep their last values. With a
    ``stream`` (a CUDA device) the graph is captured here, its memory
    drawn from ``graph_pool``, which the engine's graphs share: ``out``
    then holds until the engine's next replay, which may reuse its
    memory, so the caller fetches what it needs of it first. Without a stream (the CPU) each call runs ``fn``
    eagerly."""

    def __init__(self, fn, pool, inputs: dict, device, stream=None,
                 graph_pool=None):
        self._fn = fn
        self._pool = pool
        self._inputs = inputs
        self._static = {k: torch.as_tensor(v).clone().to(device)
                        for k, v in inputs.items()}
        self._stream = stream
        self._graph = None
        #: kernel wrapper -> its calls one replay makes (counted at the
        #: capture)
        self.launches = {}
        self.out = None
        if stream is None:
            return
        self._host = {k: torch.as_tensor(v).clone().pin_memory()
                      for k, v in inputs.items()}
        self._copied = torch.cuda.Event()
        torch.cuda.synchronize(device)  # the static inputs have landed
        with torch.cuda.stream(stream):
            fn(pool, **self._static)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        kernels = _counted_kernels()
        before = [k.captured for k in kernels]
        # thread_local: other threads' CUDA calls (another engine's
        # scheduler) stay legal while this thread captures
        with torch.cuda.graph(graph, pool=graph_pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.out = fn(pool, **self._static)
        # a capture launches nothing: its calls are counted per replay
        self.launches = {k: k.captured - b for k, b in zip(kernels, before)
                         if k.captured > b}
        self._graph = graph

    def __call__(self, **arrays) -> torch.Tensor:
        if self._graph is None:
            for k, a in arrays.items():
                a = torch.as_tensor(a)
                self._static[k][:a.shape[0]].copy_(a)
            self.out = self._fn(self._pool, **self._static)
            return self.out
        # the previous call's copies must have read the staging buffers
        self._copied.synchronize()
        with torch.cuda.stream(self._stream):
            for k, a in arrays.items():
                a = torch.as_tensor(a)
                if not a.is_pinned():  # a pinned input is copied as is
                    host = self._host[k][:a.shape[0]]
                    host.copy_(a)
                    a = host
                self._static[k][:a.shape[0]].copy_(a, non_blocking=True)
            self._copied.record()
            self._graph.replay()
        for kernel, n in self.launches.items():
            kernel.launches += n
        return self.out

    def fetch(self, index) -> np.ndarray:
        """``out[index]`` on the host as float32, once the step has run."""
        if self._graph is None:
            return self.out[index].float().numpy()
        with torch.cuda.stream(self._stream):
            return self.out[index].float().cpu().numpy()

    def fetch_rows(self, n: int) -> list:
        """The first ``n`` rows of each tensor of ``out`` (a sequence) on
        the host in its own dtype, once the step has run: on the card as
        views of ONE new pinned buffer a call, copied into on the
        engine's stream (page-locked memory: no staging copy out, and
        :meth:`__call__` copies such a view straight to the card)."""
        if self._graph is None:
            return [o[:n].clone() for o in self.out]
        rows = [o[:n] for o in self.out]
        offsets, total = [], 0
        for r in rows:  # each view 16-byte aligned
            offsets.append(total)
            total += -(-r.nbytes // 16) * 16
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        host = [buf[at:at + r.nbytes].view(r.dtype).view(r.shape)
                for r, at in zip(rows, offsets)]
        with torch.cuda.stream(self._stream):
            for h, r in zip(host, rows):
                h.copy_(r, non_blocking=True)
        self._stream.synchronize()
        return host

    def warm(self) -> None:
        """One call on the scratch inputs, so no request pays a first
        replay's costs."""
        self(**self._inputs)
        if self._stream is not None:
            self._stream.synchronize()

    def free(self) -> None:
        """Drop the graph, its output and the static inputs: the runner
        cannot be called again. The caller has synchronized the stream
        after the last replay."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self.out = self._fn = self._pool = None
        self._static, self._host = {}, {}


class _Bank:
    """One weight bank of a serving engine: a serving copy of the model
    (:func:`~distkeras_tpu_torch.models.gpt.inference_copy`), the version
    its weights hold (None before its first swap), the step functions
    over it and its own runner for every declared shape."""

    __slots__ = ("model", "version", "fns", "prefill", "decode", "verify",
                 "chunk")

    def __init__(self, model, version):
        self.model = model
        self.version = version
        self.fns = ()
        self.prefill, self.decode, self.verify = {}, {}, {}
        self.chunk = None


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
                 "t_perf", "rng", "prefill_pos", "last_logits")

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
        #: logits row of the newest token (kept under a prefix cache only:
        #: retirement parks it, so that a resumed conversation's full hit
        #: emits with no model call)
        self.last_logits = None


class GenerationEngine:
    """Iteration-level continuous-batching decode loop.

    ``generate()`` is thread-safe and returns a Future of
    :class:`GenerationResult`; an optional ``stream`` callback receives
    each token as it is emitted (called on the scheduler thread — it
    must not block). One scheduler thread owns the pool, the runners, the
    prefix cache and all host-side accounting.

    ``model`` is a :class:`~distkeras_tpu_torch.models.gpt.CausalLM`
    holding its weights; the engine moves it to ``device`` (default
    ``cuda:0``; ``"cpu"`` only when asked) and puts it in eval mode.
    ``page_size=None`` (the default) serves from the rectangular pool,
    an int from the paged pool. ``warmup`` runs every declared shape
    once after its capture. ``draft`` is an :class:`NgramDraft` or a
    :class:`ModelDraft` (with ``spec_k >= 1``).
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
        if prefix_cache_bytes and not self._paged:
            raise ValueError(
                "prefix_cache_bytes requires page_size: the prefix cache "
                "parks/restores KV at page granularity")
        if (draft is None) != (spec_k == 0):
            raise ValueError(
                "speculative decoding needs BOTH draft= and spec_k >= 1")
        if spec_k < 0 or spec_k >= self.max_len - 1:
            raise ValueError(f"spec_k must be in [0, max_len-1), got "
                             f"{spec_k}")
        self._draft = draft
        self._spec_k = int(spec_k)
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
        self._prefix = (PrefixCache(prefix_cache_bytes)
                        if prefix_cache_bytes else None)
        self.device = self.pool.device
        model.to(self.device).eval()
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.eos_id = eos_id
        self.queue_capacity = int(queue_capacity)
        self._dq: "collections.deque[_GenRequest]" = collections.deque()
        # prefix imports/exports from other threads, applied by the
        # scheduler thread between iterations (the prefix cache has one
        # owner and no lock)
        self._host_ops: collections.deque = collections.deque()
        self._swap_runs: dict = {}
        self._cv = threading.Condition()
        self._closed = False
        self._drain = True
        #: True once the scheduler exited and freed the device state
        self.released = False

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
        self._spec_proposed_c = telemetry.counter(
            "serving.decode.spec.proposed")
        self._spec_accepted_c = telemetry.counter(
            "serving.decode.spec.accepted")
        self._spec_iters_c = telemetry.counter(
            "serving.decode.spec.iterations")
        self._spec_rate_g = telemetry.gauge("serving.decode.spec.accept_rate")
        self._swapped_in_c = telemetry.counter(
            "serving.decode.paged.swapped_in")
        self._swapped_out_c = telemetry.counter(
            "serving.decode.paged.swapped_out")
        self._swap_fail_c = telemetry.counter(
            "serving.decode.paged.swap_in_failures")
        self._prefix_full_c = telemetry.counter(
            "serving.decode.prefix.full_hits")
        self._prefix_imports_c = telemetry.counter(
            "serving.decode.prefix.imports")
        self._prefix_exports_c = telemetry.counter(
            "serving.decode.prefix.exports")
        if self._chunk is not None:
            # created only when chunking is on, as in the JAX engine
            self._chunk_admits_c = telemetry.counter(
                "serving.decode.chunk.admitted")
            self._chunk_steps_c = telemetry.counter(
                "serving.decode.chunk.steps")
            self._chunk_depth_g = telemetry.gauge(
                "serving.decode.chunk.queue_depth")
            self._chunk_depth_g.set(0)
        if self._sampling and self._spec_k:
            self._spec_s_accepts_c = telemetry.counter(
                "serving.decode.spec.sampled_accepts")
            self._spec_s_resamples_c = telemetry.counter(
                "serving.decode.spec.sampled_resamples")

        # live rollout (serving/rollout.py): the float32 masters of the
        # current version, and the version each in-flight slot pinned
        self.model_version = 0
        self.last_swap_time: Optional[float] = None
        self._params = dict(model.state_dict())
        self._versions = {0: 0}            # live version -> bank index
        self._slot_version: dict = {}      # slot -> version pinned at prefill
        self._pending_swap = None          # (version, params, staged, ...)
        self._cur = 0                      # the current version's bank
        self._banks = [_Bank(gpt.inference_copy(model, new=True), v)
                       for v in (0, None)]
        self._compile_all()
        if warmup:
            self._warmup()
        self._thread = threading.Thread(target=self._scheduler_loop,
                                        name="generation-scheduler",
                                        daemon=True)
        self._thread.start()

    # -- one runner (a CUDA graph on the card) per declared shape ----------

    def _runner(self, fn, pool, **inputs) -> _StepRunner:
        """A runner of ``fn`` over ``pool`` on this engine's device,
        stream and graph pool (a draft's runners too)."""
        return _StepRunner(fn, pool, inputs, self.device, self.stream,
                           self._graph_pool)

    def _compile_all(self) -> None:
        """Make exactly one runner per prefill bucket, one per ladder
        entry, one for the chunk width (shared with a bucket of that
        width) and one verify runner per ladder entry (speculative only)
        in EACH weight bank, and the swap pair (prefix cache only) once,
        up front (module docstring), then bind the draft. A shape counts
        once on ``serving.decode.compiles``, whatever the banks. On a
        CUDA device each captures its graph on the engine's stream;
        ``graph_pool_bytes`` is the device memory the runners then hold
        (the graphs' pools and the static inputs)."""
        cuda = self.device.type == "cuda"
        #: the stream every capture and replay of this engine runs on
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        #: the memory pool the engine's graphs share (they run in turn)
        self._graph_pool = torch.cuda.graph_pool_handle() if cuda else None
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
                    + [fa.counters_needed(n, max(2, self._spec_k + 1), h)
                       for n in self._ladder]))
        compiles = telemetry.counter("serving.decode.compiles")
        scratch = self.pool.scratch_slot
        runner = lambda fn, **inputs: self._runner(  # noqa: E731
            fn, self.pool.pool, **inputs)

        def declare(runs, key, make, **span):
            """One declared shape: a runner in each bank from
            ``make(bank)``, counted once."""
            with telemetry.span("serving.decode.compile", **span):
                for bank in self._banks:
                    getattr(bank, runs)[key] = make(bank)
            compiles.inc()

        t_verify = self._spec_k + 1
        if self._paged:
            for bank in self._banks:
                step = make_paged_step_fn(bank.model)
                bank.fns = (lambda pool, _step=step, **kw:  # noqa: E731
                            _step(pool, **kw)[1],)
            spt = self.pool.page_tables[scratch]
            paged = lambda bank, n, t: runner(  # noqa: E731
                bank.fns[0], page_tables=np.tile(spt, (n, 1)),
                tokens=np.zeros((n, t), np.int32),
                lengths=np.zeros(n, np.int32))
            for lb in self._buckets:
                declare("prefill", lb, lambda b: paged(b, 1, lb), prefill=lb)
            if self._chunk is not None:
                if self._chunk in self._buckets:
                    # a chunk the width of a bucket is the same shape
                    for bank in self._banks:
                        bank.chunk = bank.prefill[self._chunk]
                else:
                    with telemetry.span("serving.decode.compile",
                                        prefill_chunk=self._chunk):
                        for bank in self._banks:
                            bank.chunk = paged(bank, 1, self._chunk)
                    compiles.inc()
            for n in self._ladder:
                declare("decode", n, lambda b: paged(b, n, 2), lanes=n)
                if self._spec_k:
                    declare("verify", n, lambda b: paged(b, n, t_verify),
                            verify=n)
            if self._prefix is not None:
                self._declare_swaps(compiles, runner)
        else:
            for bank in self._banks:
                bank.fns = (make_prefill_fn(bank.model),
                            make_decode_fn(bank.model),
                            make_verify_fn(bank.model))
            for lb in self._buckets:
                declare("prefill", lb, lambda b: runner(
                    b.fns[0], ids=np.zeros((1, lb), np.int32),
                    slot=np.full(1, scratch, np.int64),
                    length=np.full(1, lb, np.int32)), prefill=lb)
            lanes = lambda n, t: dict(  # noqa: E731
                slot_ids=np.full(n, scratch, np.int32),
                tokens=np.zeros((n, t) if t else n, np.int32),
                lengths=np.zeros(n, np.int32))
            for n in self._ladder:
                declare("decode", n,
                        lambda b: runner(b.fns[1], **lanes(n, 0)), lanes=n)
                if self._spec_k:
                    declare("verify", n, lambda b: runner(
                        b.fns[2], **lanes(n, t_verify)), verify=n)
        if self._draft is not None:
            self._draft.bind(self)
        self.graph_pool_bytes = 0
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            self.graph_pool_bytes = (torch.cuda.memory_reserved(self.device)
                                     - reserved0)

    def _declare_swaps(self, compiles, runner) -> None:
        """The prefix cache's fixed-shape page pair over ``[pmax]`` page
        ids (unused ones on the scratch page), one pair for both banks
        (it reads no weight): ``"out"`` gathers a slot's pages (copied to
        pinned host memory), ``"in"`` scatters parked pages into a
        reservation."""
        pmax = self.pool.pages_per_slot
        ids = np.full(pmax, self.pool.scratch_page, np.int32)
        leaves = tree_leaves(self.pool.pool)
        swap_out, swap_in = make_swap_out_fn(), make_swap_in_fn()
        data = {f"leaf{i}": torch.zeros((pmax,) + a.shape[1:],
                                        dtype=a.dtype)
                for i, a in enumerate(leaves)}
        fn_in = lambda pool, page_ids, **d: swap_in(  # noqa: E731
            pool, page_ids, [d[f"leaf{i}"] for i in range(len(d))])
        for key, make in (("out", lambda: runner(swap_out, page_ids=ids)),
                          ("in", lambda: runner(fn_in, page_ids=ids,
                                                **data))):
            with telemetry.span("serving.decode.compile", swap=key):
                self._swap_runs[key] = make()
            compiles.inc()

    def _warmup(self) -> None:
        """Run every shape once against the scratch slot/page (scratch
        garbage is fine: reads are masked by per-slot lengths)."""
        with telemetry.span("serving.decode.warmup"):
            for run in self._runners():
                run.warm()

    def _runners(self):
        runs = []
        for bank in self._banks:
            runs += list(bank.prefill.values())
            runs += list(bank.decode.values())
            runs += list(bank.verify.values())
            if bank.chunk is not None and self._chunk not in bank.prefill:
                runs.append(bank.chunk)
        runs += [self._swap_runs[k] for k in ("out", "in")
                 if k in self._swap_runs]
        return runs

    # the current bank's runners (every bank holds the same shapes)
    _prefill_runs = property(lambda self: self._banks[self._cur].prefill)
    _decode_runs = property(lambda self: self._banks[self._cur].decode)
    _verify_runs = property(lambda self: self._banks[self._cur].verify)
    _chunk_run = property(lambda self: self._banks[self._cur].chunk)

    @property
    def compiled_executables(self):
        """{"prefill": bucket sizes, "decode": lane widths}, plus
        ``"prefill_chunk"`` under chunked prefill, ``"verify"`` lane
        widths under speculative decoding, ``"swap": ("in", "out")``
        under the prefix cache and ``"draft_prefill"``/``"draft_decode"``
        with a :class:`ModelDraft`: the shapes made in ``__init__`` (CUDA
        graphs on the card), the only ones any request runs. Never
        grows."""
        execs = {"prefill": tuple(sorted(self._prefill_runs)),
                 "decode": tuple(sorted(self._decode_runs))}
        if self._chunk_run is not None:
            execs["prefill_chunk"] = (self._chunk,)
        if self._verify_runs:
            execs["verify"] = tuple(sorted(self._verify_runs))
        if self._swap_runs:
            execs["swap"] = ("in", "out")
        if self._draft is not None and hasattr(self._draft,
                                               "compiled_executables"):
            de = self._draft.compiled_executables
            execs["draft_prefill"] = de["prefill"]
            execs["draft_decode"] = de["decode"]
        return execs

    # -- live weight rollout (serving/rollout.py) ----------------------------

    def _bank_of(self, version: int) -> _Bank:
        return self._banks[self._versions.get(version, self._cur)]

    def swap_weights(self, params, version: int,
                     timeout: float = 60.0) -> None:
        """Install ``params`` (a ``state_dict`` of float32 masters, as
        ``model.state_dict()`` gives) as ``version`` and block until the
        scheduler applied it. Validation runs on the caller's thread: a
        torn or mismatched dict raises ValueError with the engine
        untouched. So does the copy to the device. The scheduler then
        casts the masters into the weight bank that no in-flight slot
        pins (an in-place copy into the tensors its CUDA graphs read)
        between two iterations and makes it current: requests prefilled
        before keep decoding on their pinned bank, requests admitted
        after run on the new one. Nothing is captured, so
        :attr:`compiled_executables` and ``serving.decode.compiles`` do
        not move. With two banks, a swap that arrives while both are
        live (the current one and an older one still pinned) waits until
        the older version's last slot retires; the JAX engine installs
        it at once (ROADMAP.md Queue C, divergences by design). If that
        wait outlasts ``timeout``, the swap is withdrawn (the engine
        stays on its version and a later swap is not refused as
        pending) and TimeoutError is raised."""
        from distkeras_tpu_torch.serving.rollout import validate_tree_like

        t0 = time.perf_counter()
        try:
            validate_tree_like(params, self._params)
        except ValueError:
            telemetry.counter("rollout.torn_swaps_blocked",
                              engine="generation").inc()
            raise
        staged = {k: torch.as_tensor(v).to(self.device)
                  for k, v in params.items()}
        if self.stream is not None:
            torch.cuda.current_stream(self.device).synchronize()
        done = threading.Event()
        errbox: list = []
        pending = (int(version), params, staged, done, errbox)
        with self._cv:
            if self._closed:
                raise EngineClosed("engine is shut down; no weight swaps")
            if self._pending_swap is not None:
                raise RuntimeError("a weight swap is already pending")
            self._pending_swap = pending
            self._cv.notify_all()
        if not done.wait(timeout):
            with self._cv:
                withdrawn = self._pending_swap is pending
                if withdrawn:
                    self._pending_swap = None
            if withdrawn:
                raise TimeoutError(f"weight swap to version {version} not "
                                   f"applied within {timeout}s; withdrawn")
            done.wait()  # the scheduler took it: the load is under way
        if errbox:
            raise errbox[0]
        dt = time.perf_counter() - t0
        telemetry.counter("rollout.swaps", engine="generation").inc()
        telemetry.histogram("rollout.swap_s", engine="generation").record(dt)
        telemetry.record_event("rollout", action="swap",
                               engine="generation", version=int(version),
                               seconds=dt)

    def _apply_pending_swap(self) -> None:
        """Scheduler-thread half of :meth:`swap_weights`, between two
        iterations: load the pending version into the bank whose version
        no slot pins and make it current. Leaves the swap pending while
        that bank's version is still pinned."""
        with self._cv:
            pending = self._pending_swap
        if pending is None:
            return
        self._reclaim_versions()
        idle = 1 - self._cur
        if self._banks[idle].version in self._versions:
            return  # still pinned: retried every iteration until it drains
        with self._cv:
            self._pending_swap = None
        version, params, staged, done, errbox = pending
        bank = self._banks[idle]
        try:
            if self.stream is not None:
                with torch.cuda.stream(self.stream):
                    gpt.load_weights(bank.model, staged)
                self.stream.synchronize()  # ``staged`` may be freed after
            else:
                gpt.load_weights(bank.model, staged)
        except Exception as e:  # the swapper waits on ``done``
            bank.version = None  # half loaded: no version lives here
            errbox.append(e)
            done.set()
            raise
        bank.version = version
        self._versions[version] = idle
        self._cur = idle
        self._params = params
        self.model_version = version
        self.last_swap_time = time.time()
        telemetry.gauge("rollout.model_version",
                        engine="generation").set(version)
        telemetry.gauge("rollout.last_swap_time",
                        engine="generation").set(self.last_swap_time)
        from distkeras_tpu_torch.health import recorder as flight_recorder

        flight_recorder.configure(decode_model_version=int(version))
        self._reclaim_versions()
        done.set()

    def _fail_pending_swap(self, err: Exception) -> None:
        """Unblock a swapper whose swap can no longer be applied
        (scheduler crash or shutdown) with ``err`` instead of a hang."""
        with self._cv:
            pending = self._pending_swap
            self._pending_swap = None
        if pending is not None:
            errbox, done = pending[4], pending[3]
            errbox.append(err)
            done.set()

    def _reclaim_versions(self) -> None:
        """Retire-before-reclaim: a version no in-flight slot pins and
        that is not current leaves the live set; its bank is then free
        for the next swap."""
        pinned = set(self._slot_version.values())
        pinned.add(self.model_version)
        for stale in [v for v in self._versions if v not in pinned]:
            del self._versions[stale]
            telemetry.counter("rollout.versions_retired").inc()
            telemetry.record_event("rollout", action="version_retired",
                                   engine="generation", version=stale)

    # -- prefix handoff between engines ------------------------------------

    def _host_op(self, kind: str, payload, timeout: float):
        """Hand one prefix-cache operation to the scheduler thread and
        wait for its result: other threads never touch the cache."""
        done = threading.Event()
        box: list = []
        with self._cv:
            if self._closed:
                return None if kind == "export" else False
            self._host_ops.append((kind, payload, done, box))
            self._cv.notify_all()
        if not done.wait(timeout):
            return None if kind == "export" else False
        return box[0]

    def export_prefix(self, tokens, timeout: float = 10.0):
        """Host copy of the parked KV for exactly ``tokens``: ``(data,
        last_logits)`` (``data`` the pool's structure, each leaf a CPU
        tensor of the prefix's pages in the pool's dtype; ``last_logits``
        may be None), or None when no such entry (or no cache) exists."""
        tokens = tuple(int(t) for t in np.asarray(tokens).reshape(-1))
        return self._host_op("export", tokens, timeout)

    def import_prefix(self, tokens, leaves, last_logits=None,
                      timeout: float = 10.0) -> bool:
        """Install a shipped prefix into this engine's cache. ``leaves``
        is the flat leaf list (:func:`~distkeras_tpu_torch.serving.
        kv_cache.tree_leaves`) of an :meth:`export_prefix` ``data``; a
        leaf count, page count, shape or dtype that does not match this
        pool is refused, never half-installed. True when the entry is
        resident; False means the caller must prefill."""
        tokens = tuple(int(t) for t in np.asarray(tokens).reshape(-1))
        if last_logits is not None:
            last_logits = np.asarray(last_logits)
        return bool(self._host_op("import", (tokens, list(leaves),
                                             last_logits), timeout))

    def _apply_host_ops(self) -> None:
        """Scheduler-thread half of import/export_prefix."""
        while True:
            with self._cv:
                if not self._host_ops:
                    return
                kind, payload, done, box = self._host_ops.popleft()
            try:
                if self._prefix is None:
                    box.append(None if kind == "export" else False)
                elif kind == "export":
                    entry = self._prefix.peek(payload)
                    if entry is None:
                        box.append(None)
                    else:
                        self._prefix_exports_c.inc()
                        box.append((entry.data, entry.last_logits))
                else:
                    tokens, leaves, last_logits = payload
                    leaves = [torch.as_tensor(x) for x in leaves]
                    pool_leaves = tree_leaves(self.pool.pool)
                    pages = self.pool.pages_for(len(tokens))
                    ok = len(leaves) == len(pool_leaves) and all(
                        x.shape == (pages,) + p.shape[1:]
                        and x.dtype == p.dtype
                        for x, p in zip(leaves, pool_leaves))
                    if ok:
                        self._prefix.insert(
                            tokens, _unflatten(self.pool.pool, leaves),
                            last_logits)
                        ok = self._prefix.has(tokens)
                        if ok:
                            self._prefix_imports_c.inc()
                    box.append(bool(ok))
            except Exception:  # a bad handoff must not kill the loop
                self._swap_fail_c.inc()
                box.append(None if kind == "export" else False)
            finally:
                done.set()

    def _fail_host_ops(self) -> None:
        """Unblock waiters whose op can no longer run (crash/shutdown)."""
        with self._cv:
            pending = list(self._host_ops)
            self._host_ops.clear()
        for kind, _payload, done, box in pending:
            box.append(None if kind == "export" else False)
            done.set()

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
        try:
            self._schedule()
        finally:
            self._free_device()

    def _schedule(self) -> None:
        active = {}      # slot -> _GenRequest (decoding)
        prefilling = {}  # slot -> _GenRequest (chunked prefill cursor)
        pending: list = []
        try:
            while True:
                with self._cv:
                    while not self._dq and not active and not prefilling \
                            and not self._closed \
                            and self._pending_swap is None \
                            and not self._host_ops:
                        self._cv.wait()
                    if self._closed and not self._drain:
                        pending = list(self._dq)
                        self._dq.clear()
                        self._depth_g.set(0)
                        break
                    if self._closed and not self._dq and not active \
                            and not prefilling:
                        self._fail_pending_swap(EngineClosed(
                            "engine is shut down; no weight swaps"))
                        self._fail_host_ops()
                        return
                self._apply_pending_swap()
                self._apply_host_ops()
                self._admit(active, prefilling)
                self._expire(active, prefilling)
                if prefilling:
                    self._chunk_step(active, prefilling)
                if active:
                    self._decode_step(active)
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

    def _free_device(self) -> None:
        """Free the engine's device state once its scheduler, the only
        thread that replays its graphs, has made its last call (drained,
        shut down without draining, or failed): every runner's graph,
        output and static inputs, the draft's, both weight banks and the
        KV pool, so the graphs' memory pool goes back to the allocator
        with the last graph. Its stream is synchronized first, so no
        replay of this engine is in flight; other engines' streams and
        pools are not touched. ``released`` is then True and
        ``compiled_executables`` still names the declared shapes. The
        freed blocks go back to the caching allocator; returning them
        to the device (``torch.cuda.empty_cache()``) is the caller's
        call."""
        if self.stream is not None:
            self.stream.synchronize()
        for run in self._runners():
            run.free()
        if self._draft is not None and hasattr(self._draft, "free_device"):
            self._draft.free_device()
        for bank in self._banks:
            bank.model, bank.fns = None, ()
        self.pool.pool = None
        self._graph_pool = None
        self.released = True

    def _fail_all(self, err, pending, active, prefilling) -> None:
        self._fail_pending_swap(err)
        self._fail_host_ops()
        for req in (pending + list(active.values())
                    + list(prefilling.values())):
            req.future.set_exception(err)
        for slot in list(active) + list(prefilling):
            self.pool.free(slot)
        self._slot_version.clear()

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
                if self._start_chunked(req, slot, prefilling):
                    self._chunk_admits_c.inc()
                    self._chunk_depth_g.set(len(prefilling))
                    continue
                # else a full prefix hit completed with no chunk work
            elif self._paged:
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
        # pin the version this sequence started on: every later decode
        # step for this slot runs on the same bank even if a swap lands
        # mid-generation
        self._slot_version[slot] = self.model_version
        self._finish_prefill(req, slot, run.fetch(...), t0, tp0, bucket=lb)

    def _prefix_start(self, req: _GenRequest, slot: int):
        """Prefix-cache half of paged admission: lookup and page swap-in.
        Returns ``(start, logits_row, hit)``: positions ``[0, start)``
        are resident in ``slot``; ``logits_row`` is not None on a full
        hit with parked logits (the caller emits with no model call);
        ``hit`` says whether a cached prefix was restored."""
        n = req.prompt.size
        entry = (self._prefix.lookup(req.prompt)
                 if self._prefix is not None else None)
        if entry is None or not self._swap_in_entry(slot, entry):
            return 0, None, False
        if entry.length < n:
            return entry.length, None, True
        if entry.last_logits is not None:
            # full hit: the parked logits ARE the first-token
            # distribution
            self._prefix_full_c.inc()
            return n, entry.last_logits, True
        # the KV covers the prompt but no logits were parked: re-derive
        # them by feeding the last prompt token again
        return n - 1, None, True

    def _prefill_paged(self, req: _GenRequest, slot: int) -> None:
        """Paged admission: prefix lookup and swap-in, then one bucketed
        prefill of what the cache did not cover, at ``lengths=[start]``
        on the prefill runners. A full hit with parked logits emits the
        first token with no model call."""
        n = req.prompt.size
        t0 = time.monotonic()
        tp0 = time.perf_counter()
        start, logits_row, hit = self._prefix_start(req, slot)
        self.pool.lengths[slot] = start
        ran_prefill = logits_row is None
        if ran_prefill:
            lb, ids = self._bucket_ids(req.prompt[start:])
            run = self._prefill_runs[lb]
            run(page_tables=self.pool.page_table_row(slot)[None, :],
                tokens=ids, lengths=np.full(1, start, np.int32))
            logits_row = run.fetch((0, n - start - 1))
        self._finish_prefill(req, slot, logits_row, t0, tp0,
                             ran_prefill=ran_prefill, prefix_hit=hit)

    def _start_chunked(self, req: _GenRequest, slot: int,
                       prefilling) -> bool:
        """Chunked admission: the prefix half of :meth:`_prefill_paged`,
        then the request parks in ``prefilling`` with its cursor at the
        restored length. False when no chunk work is left (a full hit
        with parked logits completes here with no model call)."""
        t0 = time.monotonic()
        tp0 = time.perf_counter()
        start, logits_row, hit = self._prefix_start(req, slot)
        self.pool.lengths[slot] = start
        if logits_row is not None:
            self._finish_prefill(req, slot, logits_row, t0, tp0,
                                 ran_prefill=False, prefix_hit=hit)
            return False
        # pin the version NOW: every chunk (and later decode step) of this
        # slot runs on the bank it was admitted on, even if a weight swap
        # lands mid-prefill
        self._slot_version[slot] = self.model_version
        req.prefill_pos = start
        prefilling[slot] = req
        return True

    def _swap_in_entry(self, slot: int, entry) -> bool:
        """Scatter a parked prefix's pages into ``slot``'s reservation
        (the swap-in runner; only the entry's pages are copied in). The
        ``"kv.swap_in"`` chaos site models a torn or lost restore: the
        entry is evicted (never offered again) and the caller prefills
        from scratch, as in the JAX engine."""
        if fault.chaos("kv.swap_in") is not None:
            self._swap_fail_c.inc()
            self._prefix.evict(entry)
            return False
        pmax = self.pool.pages_per_slot
        p0 = self.pool.pages_for(entry.length)
        page_ids = np.full(pmax, self.pool.scratch_page, np.int32)
        page_ids[:p0] = self.pool.page_table_row(slot)[:p0]
        self._swap_runs["in"](page_ids=page_ids, **{
            f"leaf{i}": leaf for i, leaf in enumerate(tree_leaves(
                entry.data))})
        self._swapped_in_c.inc(p0)
        return True

    def _capture_prefix(self, slot: int, tokens, last_logits) -> None:
        """Park ``slot``'s first ``len(tokens)`` cells and a copy of
        ``last_logits`` in the prefix cache (the swap-out runner, then one
        copy into pinned host memory), unless the cache holds those
        tokens already."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if self._prefix.has(tokens):
            return
        pmax = self.pool.pages_per_slot
        p0 = self.pool.pages_for(tokens.size)
        page_ids = np.full(pmax, self.pool.scratch_page, np.int32)
        page_ids[:p0] = self.pool.page_table_row(slot)[:p0]
        run = self._swap_runs["out"]
        run(page_ids=page_ids)
        data = _unflatten(self.pool.pool, run.fetch_rows(p0))
        self._swapped_out_c.inc(p0)
        self._prefix.insert(tokens, data,
                            np.array(last_logits, np.float32))

    def _finish_prefill(self, req: _GenRequest, slot: int, logits_row,
                        t0: float, tp0: float, ran_prefill: bool = True,
                        **span) -> None:
        """Shared tail of every prefill path (one-shot, chunked, full
        hit): the version pin, the first-token pick, TTFT accounting,
        prefix capture, draft begin, stream."""
        # setdefault: a chunked slot pinned its version at admission and
        # must not re-pin to a newer one a mid-prefill swap installed
        version = self._slot_version.setdefault(slot, self.model_version)
        self.pool.lengths[slot] = req.prompt.size
        tok = self._pick_token(req, logits_row)
        now = time.monotonic()
        if ran_prefill:
            self._prefills_c.inc()
            self._prefill_h.record(now - t0)
        self._ttft_h.record(now - req.t_submit)
        if req.trace is not None:
            telemetry.record_trace_span(
                req.trace, "trace.prefill", tp0,
                time.perf_counter() - tp0, slot=slot,
                model_version=version, **span)
        req.generated.append(tok)
        req.last_token = tok
        if self._prefix is not None:
            req.last_logits = logits_row
            self._capture_prefix(slot, req.prompt, logits_row)
        if self._draft is not None:
            self._draft.begin(slot, req.prompt, tok)
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
            run = self._bank_of(self._slot_version.get(
                slot, self.model_version)).chunk
            run(page_tables=self.pool.page_table_row(slot)[None],
                tokens=ids, lengths=np.full(1, pos, np.int32))
            self._chunk_steps_c.inc()
            req.prefill_pos = pos + chunk.size
            self.pool.lengths[slot] = req.prefill_pos
            if req.prefill_pos >= n:
                del prefilling[slot]
                self._finish_prefill(
                    req, slot, run.fetch((0, n - pos - 1)), t0, tp0,
                    chunk=self._chunk)
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

    def _decode_step(self, active) -> None:
        """One scheduler iteration of decode over every active slot.
        Slots are grouped BY PINNED VERSION and each group runs on its
        version's bank (as the JAX engine groups by version: one call
        shares one set of weights), so a request ends on the version it
        started on. Steady state is one group; two exist only while a
        swap's older version drains. Each group is a speculative
        iteration when every lane's verify block ``[len, len + spec_k]``
        stays inside the context window, else plain decode (the tokens
        are the same either way)."""
        groups: dict = {}
        for s in sorted(active):
            groups.setdefault(
                self._slot_version.get(s, self.model_version), []).append(s)
        if len(groups) > 1:
            telemetry.histogram("rollout.version_groups").record(
                len(groups))
        for version in sorted(groups):
            slots = groups[version]
            bank = self._bank_of(version)
            if self._spec_k and all(
                    self.pool.lengths[s] + self._spec_k < self.max_len
                    for s in slots):
                self._spec_group(active, slots, bank)
            else:
                self._decode_group(active, slots, bank)
        self._reclaim_versions()
        self._active_g.set(len(active))

    def _group_arrays(self, active, slots, lane: int, t: int):
        """Ladder-padded step inputs: scratch lanes for padding, column
        0 each lane's pending token, columns 1..t-1 GHOST_TOKEN (the
        speculative path puts the draft's proposals there)."""
        slot_ids = np.full(lane, self.pool.scratch_slot, np.int32)
        tokens = np.full((lane, t), GHOST_TOKEN, np.int32)
        lengths = np.zeros(lane, np.int32)
        for i, s in enumerate(slots):
            slot_ids[i] = s
            tokens[i, 0] = active[s].last_token
            lengths[i] = self.pool.lengths[s]
        return slot_ids, tokens, lengths

    def _decode_group(self, active, slots, bank: _Bank) -> None:
        """Advance ``slots`` one token in one ladder-padded step on
        ``bank``. Padded lanes use the scratch slot (length 0; in the
        paged pool its all-scratch page table)."""
        n = len(slots)
        lane = self._ladder.bucket_for(n)
        run = bank.decode[lane]
        slot_ids, tokens, lengths = self._group_arrays(active, slots, lane,
                                                       2)
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
            if self._prefix is not None:
                # a view of this step's own host array: copied only if
                # the conversation is parked
                req.last_logits = rows[i]
            if self._draft is not None:
                self._draft.observe(s, (tok,))
            if req.trace is not None:
                # one step serves every lane, so each traced request gets
                # the SHARED step interval
                telemetry.record_trace_span(
                    req.trace, "trace.decode", tp0, dt_p,
                    step=len(req.generated), lanes=lane)
            self._stream_token(req, tok)
            if self._emit(req, s) is not None:
                del active[s]

    def _sampled_accept_walk(self, req: _GenRequest, props_i, logits_i):
        """Host side of sampled speculative verification: the target-vs-
        draft accept/reject rule for point-mass drafts. ONE tempered
        inverse-CDF draw a position accepts the proposal iff it lands on
        it (probability ``p_target(d)``), and otherwise is itself a
        sample of the normalized residual. One uniform per EMITTED token,
        in emission order: the stream plain sampled decode draws.
        Returns ``(emit, resampled)``; the caps (max_new_tokens, EOS)
        apply inside the walk, so no draw is spent on a token that is not
        emitted."""
        s = self._spec_k
        emit: list = []
        resampled = False
        remaining = req.max_new_tokens - len(req.generated)
        for m in range(min(s + 1, remaining)):
            tok = self._pick_token(req, logits_i[m])
            emit.append(tok)
            if req.eos_id is not None and tok == req.eos_id:
                break
            if m < s and tok != int(props_i[m]):
                resampled = True
                break
        return emit, resampled

    def _spec_group(self, active, slots, bank: _Bank) -> None:
        """One draft-verify iteration: the draft proposes ``spec_k``
        tokens a lane, ONE verify call (``T = spec_k + 1``) scores them
        all, and the greedy rule emits token i+1 iff proposals 1..i all
        matched greedy's choices, plus the one token the verify call
        always yields: the tokens of sequential greedy decode. Under
        ``sampling=True`` the walk is :meth:`_sampled_accept_walk`."""
        n = len(slots)
        s = self._spec_k
        lane = self._ladder.bucket_for(n)
        run = bank.verify[lane]
        slot_ids, tokens, lengths = self._group_arrays(active, slots, lane,
                                                       s + 1)
        props = self._draft.propose(slots, tokens[:n, 0], lengths[:n], s)
        tokens[:n, 1:] = props
        t0 = time.monotonic()
        tp0 = time.perf_counter()
        if self._paged:
            run(page_tables=self.pool.page_tables[slot_ids], tokens=tokens,
                lengths=lengths)
        else:
            run(slot_ids=slot_ids, tokens=tokens, lengths=lengths)
        logits = run.fetch(slice(0, n))  # [n, s + 1, V]
        greedy = np.argmax(logits, axis=-1)
        dt = time.monotonic() - t0
        dt_p = time.perf_counter() - tp0
        self._steps_c.inc()
        self._step_h.record(dt)
        self._padded_h.record(lane - n)
        self._spec_iters_c.inc()
        emitted_total = 0
        for i, slot in enumerate(slots):
            req = active[slot]
            if self._sampling:
                emit, resampled = self._sampled_accept_walk(
                    req, props[i], logits[i])
            else:
                m = 0
                while m < s and props[i, m] == greedy[i, m]:
                    m += 1
                emit = [int(t) for t in greedy[i, :m + 1]]
                # caps: never past max_new_tokens, truncated at EOS
                emit = emit[:req.max_new_tokens - len(req.generated)]
                if req.eos_id is not None and req.eos_id in emit:
                    emit = emit[:emit.index(req.eos_id) + 1]
                resampled = False
            p = len(emit)
            self._spec_proposed_c.inc(s)
            self._spec_accepted_c.inc(p - 1)
            if self._sampling:
                self._spec_s_accepts_c.inc(p - 1)
                if resampled:
                    self._spec_s_resamples_c.inc()
            self.pool.lengths[slot] += p  # cells L..L+p-1 are now true
            for tok in emit:
                req.generated.append(tok)
                req.last_token = tok
                self._stream_token(req, tok)
            if self._prefix is not None:
                req.last_logits = logits[i, p - 1]
            self._draft.observe(slot, emit)
            emitted_total += p
            if req.trace is not None:
                telemetry.record_trace_span(
                    req.trace, "trace.decode", tp0, dt_p,
                    step=len(req.generated), lanes=lane, spec=p)
            if self._emit(req, slot) is not None:
                del active[slot]
        self._tokens_c.inc(emitted_total)
        if dt > 0:
            self._tps_g.set(emitted_total / dt)
        proposed = self._spec_proposed_c.value
        if proposed:
            self._spec_rate_g.set(self._spec_accepted_c.value / proposed)

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
        if (self._prefix is not None and req.last_logits is not None
                and len(req.generated) > 1):
            # park the finished conversation: cells [0, length) hold the
            # prompt and generated[:-1], and last_logits gives the last
            # token: a resumed conversation becomes a full hit
            self._capture_prefix(
                slot, np.concatenate([req.prompt, np.asarray(
                    req.generated[:-1], np.int32)]), req.last_logits)
        self.pool.free(slot)
        self._slot_version.pop(slot, None)  # unpin: the version may retire
        if self._draft is not None:
            self._draft.release(slot)
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
                    self._slot_version.pop(slot, None)
                    if self._draft is not None:
                        self._draft.release(slot)
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

    # -- health --------------------------------------------------------------

    def health_status(self) -> dict:
        """Live state for the health plane (the JAX engine's digest)."""
        with self._cv:
            depth = len(self._dq)
            oldest = (time.monotonic() - self._dq[0].t_submit
                      if self._dq else 0.0)
        self._depth_g.set(depth)
        status = {
            "num_slots": self.pool.num_slots,
            "slots_active": self.pool.num_active,
            "slots_free": self.pool.num_free,
            "queue_depth": depth,
            "oldest_request_age_s": oldest,
            "cache_bytes": self.pool.cache_bytes,
            "prefill_buckets": list(self._buckets.sizes),
            "decode_ladder": list(self._ladder.sizes),
            "compiled": {k: list(v) for k, v in
                         self.compiled_executables.items()},
            "model_version": self.model_version,
            "last_swap_time": self.last_swap_time,
            "live_versions": sorted(self._versions),
        }
        if self._paged:
            status["paged"] = {
                "page_size": self.pool.page_size,
                "num_pages": self.pool.num_pages,
                "pages_in_use": self.pool.pages_in_use,
                "page_occupancy": (self.pool.pages_in_use
                                   / self.pool.num_pages),
                "page_bytes": self.pool.page_bytes,
                "kv_dtype": self.pool.kv_dtype,
            }
            if self.pool.kv_dtype == "int8":
                status["paged"]["kv_quant_bytes_saved"] = (
                    self.pool.kv_quant_bytes_saved)
        if self._chunk is not None:
            status["chunked_prefill"] = {
                "prefill_chunk": self._chunk,
                "admitted": self._chunk_admits_c.value,
                "chunk_steps": self._chunk_steps_c.value,
            }
        if self._sampling:
            status["sampling"] = {
                "temperature": self._temperature,
                "seed": self._seed,
            }
        if self._prefix is not None:
            status["prefix_cache"] = {
                "entries": len(self._prefix),
                "bytes": self._prefix.bytes,
                "budget_bytes": self._prefix.budget_bytes,
                "hits": self._prefix.hits,
                "misses": self._prefix.misses,
                "hit_rate": self._prefix.hit_rate,
                "evictions": self._prefix.evictions,
            }
        if self._spec_k:
            proposed = self._spec_proposed_c.value
            accepted = self._spec_accepted_c.value
            status["speculative"] = {
                "spec_k": self._spec_k,
                "proposed": proposed,
                "accepted": accepted,
                "accept_rate": accepted / proposed if proposed else 0.0,
                "sampling": self._sampling,
            }
        return status

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
            self._fail_pending_swap(err)
            self._fail_host_ops()
            for req in pending:
                req.future.set_exception(err)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
