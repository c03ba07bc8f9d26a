"""Runtime telemetry: structured metrics + span tracing for the system side.

The PyTorch port's own copy of ``distkeras_tpu/telemetry.py`` (stdlib
only; the port imports nothing of the JAX package). Metric names are the
same, so dashboards and the health CLI read both packages alike.

``observability.py`` covers the *compute* side (FLOPs, MFU, profiler
traces). This module covers the *system* side the reference never had and
the async zoo badly needs: PS RPC latency, commit staleness distributions,
worker window timing, prefetch queue occupancy. A process-local
:class:`MetricsRegistry` holds counters, gauges and bounded histograms; a
``with span("ps.commit"): ...`` tracer records wall-clock durations (and a
bounded event timeline with monotonic timestamps); ``dump_jsonl`` leaves a
machine-readable artifact next to the BENCH_*.json files.

Design constraints (enforced by tests/test_telemetry.py):

- **No framework import.** Nothing here can touch a device, so instrumentation
  can never introduce a device sync on the step path.
- **Lock-free record path.** Counters and histograms shard their state
  per thread (``threading.local``); ``inc``/``record``/``set``/``add``
  touch only the calling thread's shard — no lock, no contention from
  ``host_async`` worker threads. The only locks are on metric *creation*
  (first call for a given name+labels) and shard registration (first call
  per thread per metric); after that the hot path is a dict hit plus a few
  attribute ops (~1 µs).
- **Cleanly disabled.** A default registry is installed at import (the
  telemetry is default-on); ``uninstall()`` turns every module-level
  accessor into a shared no-op metric, so instrumented call sites cost one
  ``None`` check and a no-op method call.

JSONL schema (one object per line; see DESIGN.md §5b):

    {"kind": "counter",   "name": ..., "labels": {...}, "value": N}
    {"kind": "gauge",     "name": ..., "labels": {...}, "value": X}
    {"kind": "histogram", "name": ..., "labels": {...}, "count": N,
     "sum": S, "min": m, "max": M, "p50": ..., "p95": ...,
     "samples_kept": K}
    {"kind": "span", "name": ..., "labels": {...}, "t0": monotonic_start,
     "dur_s": ...}

Histograms are *bounded*: each thread shard keeps a ring of the most
recent ``max_samples`` values (count/sum/min/max stay exact over ALL
samples; percentiles are computed from the kept ring, i.e. they are
recency-weighted once a shard overflows).
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "get_registry", "install", "uninstall", "reset",
    "counter", "gauge", "histogram", "span", "load_jsonl",
    "METRIC_NAMES", "METRIC_PREFIXES", "declared_kind",
    "TraceContext", "current_trace", "use_trace", "inject", "extract",
    "record_trace_span", "flush_at_exit",
    "set_recorder", "get_recorder", "record_event",
    "set_process_index", "process_index", "per_process_path",
]

SCHEMA_VERSION = 1

#: The metric-name registry: every metric the package produces, declared
#: once, name -> instrument kind. Two readers share this dict as the
#: single source of truth: the runtime (``MetricsRegistry._get`` raises on
#: a declared name used with the wrong kind) and the dktlint
#: telemetry-registry checker (``distkeras_tpu_torch/analysis/registry.py``
#: parses this literal from the AST and cross-checks every producer call
#: and consumer reference in the repo). Ad-hoc names outside the declared
#: namespaces (tests, experiments) remain legal — the registry constrains
#: the names it knows about, it does not close the namespace.
#:
#: Keep this a LITERAL dict of string keys/values: the lint suite reads it
#: without importing this module.
METRIC_NAMES = {
    # comms wire accounting (codec + both remote_ps sides)
    "comms.bytes_recv": "counter",
    "comms.bytes_sent": "counter",
    "comms.compress_ratio": "histogram",
    "comms.negotiated": "counter",
    # data plane
    "data.prefetch.producer_errors": "counter",
    "data.prefetch.producer_wait_s": "histogram",
    "data.prefetch.puts": "counter",
    "data.prefetch.queue_depth": "gauge",
    "data.prefetch.queue_depth_samples": "histogram",
    # streaming data service (data/service.py, DESIGN.md §20)
    "data.service.acks": "counter",
    "data.service.client.reconnects": "counter",
    "data.service.client.retries": "counter",
    "data.service.client.rtt_s": "histogram",
    "data.service.client.unavailable": "counter",
    "data.service.cursor": "gauge",
    "data.service.dedup_hits": "counter",
    "data.service.epoch": "gauge",
    "data.service.fetch_rows": "counter",
    "data.service.leased_ranges": "gauge",
    "data.service.leases": "counter",
    "data.service.ranges": "gauge",
    "data.service.releases": "counter",
    "data.service.server.auth_failures": "counter",
    "data.service.server.dispatch": "counter",
    "data.service.stale_acks": "counter",
    # elastic fleet membership (health/membership.py + remote_ps commits)
    "elastic.evictions": "counter",
    # coordinator failover plane (parallel/failover.py, DESIGN.md §17)
    "elastic.failover.epoch": "gauge",
    "elastic.failover.fenced": "counter",
    "elastic.failover.kills": "counter",
    "elastic.failover.promotions": "counter",
    "elastic.failover.repl_dropped": "counter",
    "elastic.failover.repl_errors": "counter",
    "elastic.failover.repl_lag": "gauge",
    "elastic.failover.repl_records": "counter",
    "elastic.failover.resolves": "counter",
    "elastic.late_folds": "counter",
    "elastic.readmissions": "counter",
    "elastic.workers": "gauge",
    # fault injection
    "fault.chaos": "counter",
    "fault.injected": "counter",
    # routed serving fleet (serving/fleet.py, DESIGN.md §22)
    "fleet.affinity.entries": "gauge",
    "fleet.affinity.hit_rate": "gauge",
    "fleet.affinity.hits": "counter",
    "fleet.affinity.misses": "counter",
    "fleet.evictions": "counter",
    "fleet.handoff_failures": "counter",
    "fleet.handoffs": "counter",
    "fleet.replica.queue_depth": "gauge",
    "fleet.replicas": "gauge",
    "fleet.requests": "counter",
    "fleet.requeued": "counter",
    "fleet.sheds": "counter",
    "fleet.version_skew": "gauge",
    # health plane
    "health.alerts.active": "gauge",
    "health.alerts.breaches": "counter",
    "health.alerts.evals": "counter",
    "health.straggler.events": "counter",
    "health.stragglers": "gauge",
    "health.watchdog.idle_s": "gauge",
    "health.watchdog.last_loss": "gauge",
    "health.watchdog.last_update_norm": "gauge",
    "health.watchdog.tripped": "gauge",
    "health.watchdog.trips": "counter",
    "health.worker.clock": "gauge",
    "health.worker.heartbeat_time": "gauge",
    "health.worker.staleness": "gauge",
    "health.worker.straggler": "gauge",
    "health.worker.window_s": "gauge",
    "health.worker.windows": "counter",
    # host-driven async trainer
    "host_async.commit_clock_lag": "histogram",
    "host_async.commit_s": "histogram",
    "host_async.degraded_windows": "counter",
    "host_async.pull_s": "histogram",
    "host_async.save.count": "counter",
    "host_async.save_s": "histogram",
    "host_async.window_s": "histogram",
    # compute-side observability
    "observability.achieved_flops": "gauge",
    "observability.calibration_ratio": "gauge",
    "observability.cost_analysis_unavailable": "counter",
    "observability.flops.while_floor": "counter",
    "observability.flops_per_step": "gauge",
    "observability.mfu": "gauge",
    "observability.mfu_window": "histogram",
    "observability.peak_flops": "gauge",
    # in-process parameter servers
    "ps.commit.count": "counter",
    "ps.commit.handle_s": "histogram",
    "ps.commit.staleness": "histogram",
    "ps.pull.count": "counter",
    # remote (socket) parameter server
    "remote_ps.client.bytes_received": "counter",
    "remote_ps.client.bytes_sent": "counter",
    "remote_ps.client.reconnects": "counter",
    "remote_ps.client.retries": "counter",
    "remote_ps.client.rtt_s": "histogram",
    "remote_ps.client.unavailable": "counter",
    "remote_ps.server.auth_failures": "counter",
    "remote_ps.server.dedup_hits": "counter",
    "remote_ps.server.bytes_received": "counter",
    "remote_ps.server.dispatch": "counter",
    "remote_ps.server.handle_s": "histogram",
    "remote_ps.server.inflight_connections": "gauge",
    # serving plane
    "serving.batch_errors": "counter",
    "serving.batch_size": "histogram",
    "serving.batch_wait_s": "histogram",
    "serving.batches": "counter",
    "serving.compiles": "counter",
    "serving.completed": "counter",
    "serving.deadline_exceeded": "counter",
    "serving.execute_s": "histogram",
    "serving.oldest_request_age_s": "gauge",
    "serving.padding_rows": "histogram",
    "serving.queue_depth": "gauge",
    "serving.rejected": "counter",
    "serving.request_latency_s": "histogram",
    "serving.client.reconnects": "counter",
    "serving.client.retries": "counter",
    "serving.server.auth_failures": "counter",
    "serving.server.inflight_connections": "gauge",
    "serving.server.requests": "counter",
    "serving.shutdown_timeouts": "counter",
    "serving.submitted": "counter",
    # generative serving (KV-cache decode loop, DESIGN.md §14)
    "serving.decode.admitted": "counter",
    "serving.decode.cache_bytes": "gauge",
    "serving.decode.compiles": "counter",
    "serving.decode.deadline_exceeded": "counter",
    "serving.decode.loop_errors": "counter",
    "serving.decode.padded_lanes": "histogram",
    "serving.decode.prefill_s": "histogram",
    "serving.decode.prefills": "counter",
    "serving.decode.queue_depth": "gauge",
    "serving.decode.rejected": "counter",
    "serving.decode.retired": "counter",
    "serving.decode.slot_occupancy": "gauge",
    "serving.decode.slots_active": "gauge",
    "serving.decode.steps": "counter",
    "serving.decode.step_s": "histogram",
    "serving.decode.stream_errors": "counter",
    "serving.decode.tokens": "counter",
    "serving.decode.tokens_per_s": "gauge",
    "serving.decode.ttft_s": "histogram",
    # planet-scale decode layer (DESIGN.md §19): prefix cache, paged KV
    # with host swap, speculative decoding
    "serving.decode.prefix.bytes": "gauge",
    "serving.decode.prefix.evictions": "counter",
    "serving.decode.prefix.exports": "counter",
    "serving.decode.prefix.full_hits": "counter",
    "serving.decode.prefix.hit_rate": "gauge",
    "serving.decode.prefix.hits": "counter",
    "serving.decode.prefix.imports": "counter",
    "serving.decode.prefix.inserts": "counter",
    "serving.decode.prefix.misses": "counter",
    "serving.decode.paged.kv_quant_bytes_saved": "gauge",
    "serving.decode.paged.page_occupancy": "gauge",
    "serving.decode.paged.pages_allocated": "counter",
    "serving.decode.paged.swap_in_failures": "counter",
    "serving.decode.paged.swapped_in": "counter",
    "serving.decode.paged.swapped_out": "counter",
    "serving.decode.spec.accept_rate": "gauge",
    "serving.decode.spec.accepted": "counter",
    "serving.decode.spec.iterations": "counter",
    "serving.decode.spec.proposed": "counter",
    "serving.decode.spec.sampled_accepts": "counter",
    "serving.decode.spec.sampled_resamples": "counter",
    # long-context serving economics: chunked prefill
    "serving.decode.chunk.admitted": "counter",
    "serving.decode.chunk.queue_depth": "gauge",
    "serving.decode.chunk.steps": "counter",
    # live rollout / canary / rollback plane (serving/rollout.py,
    # DESIGN.md §18)
    "rollout.canary.agreement": "gauge",
    "rollout.canary.evals": "counter",
    "rollout.canary.mirrored": "counter",
    "rollout.last_swap_time": "gauge",
    "rollout.mirror_errors": "counter",
    "rollout.model_version": "gauge",
    "rollout.promotions": "counter",
    "rollout.publish_dropped": "counter",
    "rollout.publishes": "counter",
    "rollout.rejections": "counter",
    "rollout.rollbacks": "counter",
    "rollout.stale_publishes": "counter",
    "rollout.swap_s": "histogram",
    "rollout.swaps": "counter",
    "rollout.torn_swaps_blocked": "counter",
    "rollout.version_groups": "histogram",
    "rollout.versions_retired": "counter",
    # trainer lifecycle
    "trainer.training_time_s": "gauge",
    # flight recorder (health/recorder.py): bounded forensic ring + dumps
    "recorder.dump_errors": "counter",
    "recorder.dumps": "counter",
    "recorder.events": "counter",
    # artifact loading (load_jsonl crash-tail recovery accounting)
    "telemetry.load.truncated_tail": "counter",
    # time-series metrics plane (health/timeseries.py, DESIGN.md §24):
    # bounded tiered history of the registry + trend detection
    "timeseries.collect_s": "histogram",
    "timeseries.collections": "counter",
    "timeseries.dropped_series": "counter",
    "timeseries.points": "gauge",
    "timeseries.series": "gauge",
    "timeseries.trend_breaches": "counter",
    "timeseries.trends_active": "gauge",
    # chaos soak harness (benchmarks/soak.py): wall-clock-budgeted
    # whole-loop run under a seeded kill schedule
    "soak.cycles": "counter",
    "soak.elapsed_s": "gauge",
    "soak.failed_requests": "counter",
    "soak.kills": "counter",
    "soak.lost_windows": "counter",
    "soak.model_version": "gauge",
    "soak.requests": "counter",
    "soak.version_regressions": "counter",
    "soak.windows": "counter",
    # fleet telemetry collector (health/collector.py; lives on shard 0)
    "collector.batches": "counter",
    "collector.dropped_batches": "counter",
    "collector.dropped_rows": "counter",
    "collector.processes": "gauge",
    "collector.rows": "counter",
    # step-time decomposition (DESIGN.md §15): the canonical phase
    # vocabulary attribution.py renders. Also covered by the
    # "profile.phase." family so per-worker variants stay legal.
    "profile.phase.bookkeep_s": "histogram",
    "profile.phase.collective_s": "histogram",
    "profile.phase.commit_s": "histogram",
    "profile.phase.compute_s": "histogram",
    "profile.phase.data_wait_s": "histogram",
    "profile.phase.decode_s": "histogram",
    "profile.phase.encode_s": "histogram",
    "profile.phase.fold_s": "histogram",
    "profile.phase.h2d_s": "histogram",
    "profile.phase.pull_s": "histogram",
    "profile.phase.window_s": "histogram",
    # op-level attribution (DESIGN.md §21): roofline coverage + per-op
    # time shares, plus the once-per-process degradation counters for
    # backends without a cost model / device profiler. Per-op labeled
    # variants ride the "profile.op." family below.
    "profile.op.capture_unavailable": "counter",
    "profile.op.coverage": "gauge",
    "profile.op.inventory_unavailable": "counter",
    "profile.op.share": "gauge",
    # attention group's share of modeled step time, baseline-vs-kernel
    # (regression_gate --check roofline)
    "profile.op.attention_share": "gauge",
    # span names (the `with span("..."):` vocabulary; each also emits a
    # `span.<name>.duration_s` histogram via the prefix family below)
    "serving.compile": "span",
    "serving.decode.compile": "span",
    "serving.decode.warmup": "span",
    "serving.warmup": "span",
    "trainer.compile": "span",
    "trainer.epoch": "span",
    "trainer.finalize": "span",
    "trainer.init": "span",
    "trainer.stage": "span",
    # distributed-trace span vocabulary (DESIGN.md §15). One trace stitches
    # worker window -> transport (retries/reconnects) -> shard folds, or a
    # generate request -> queue wait -> prefill -> decode iterations.
    "trace.commit": "span",
    "trace.compute": "span",
    "trace.decode": "span",
    "trace.fold": "span",
    "trace.prefill": "span",
    "trace.pull": "span",
    "trace.queue_wait": "span",
    "trace.reconnect": "span",
    "trace.request": "span",
    "trace.retry": "span",
    "trace.rpc": "span",
    "trace.server": "span",
    "trace.shard": "span",
    "trace.stream_flush": "span",
    "trace.window": "span",
}

#: Dynamic name families: any name starting with one of these prefixes is
#: declared as a family with the given kind (same literal-dict contract as
#: METRIC_NAMES).
METRIC_PREFIXES = {
    # per-span duration histograms minted by MetricsRegistry.record_span
    "span.": "histogram",
    # device memory stats keyed by whatever the backend reports
    "observability.hbm_": "gauge",
    # distributed-trace span names (DESIGN.md §15)
    "trace.": "span",
    # step-time decomposition phases (benchmarks/attribution.py)
    "profile.phase.": "histogram",
    # op-level roofline shares (profiling/roofline.py), labeled per op
    "profile.op.": "gauge",
}


def declared_kind(name: str):
    """The registered kind for ``name`` ("counter" | "gauge" |
    "histogram" | "span"), or None when the name is undeclared (ad-hoc
    names are allowed; they are simply outside the registry's contract)."""
    k = METRIC_NAMES.get(name)
    if k is not None:
        return k
    for prefix, kind in METRIC_PREFIXES.items():
        if name.startswith(prefix):
            return kind
    return None

# -- distributed trace context (DESIGN.md §15) ------------------------------

#: Header key carrying the trace context on every wire protocol
#: (remote_ps request headers, serving/generation framing). W3C
#: traceparent shape: ``00-<32 hex trace_id>-<16 hex span_id>-01``.
#: Servers ignore unknown header keys, so carrying it is raw-fallback-safe
#: for peers that predate tracing.
TRACEPARENT_KEY = "traceparent"

#: Optional baggage dict riding next to the traceparent (low-cardinality
#: request annotations only: worker id, window number — never values).
TRACE_BAGGAGE_KEY = "tracebaggage"

#: Reserved span-label keys that carry trace identity. ``record_span``
#: strips them before minting the ``span.<name>.duration_s`` histogram
#: (per-trace ids would mint one histogram per span) and the row emitters
#: hoist them to top-level row fields.
_TRACE_KEYS = ("trace_id", "span_id", "parent_id")


class TraceContext:
    """A position in a distributed trace: ``trace_id`` names the whole
    request/window, ``span_id`` names the current span, ``baggage`` carries
    low-cardinality annotations along the entire trace.

    Identity is process-agnostic (ids are random hex minted by
    ``os.urandom``), so a context can be serialized into a wire header with
    :func:`inject`, recovered with :func:`extract`, and adopted on any
    thread with :func:`use_trace` — spans recorded while a context is
    current chain parent -> child automatically."""

    __slots__ = ("trace_id", "span_id", "baggage")

    def __init__(self, trace_id: str, span_id: str,
                 baggage: Optional[Dict[str, str]] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.baggage = dict(baggage) if baggage else {}

    @classmethod
    def new_root(cls, **baggage: str) -> "TraceContext":
        return cls(os.urandom(16).hex(), os.urandom(8).hex(), baggage)

    def child(self) -> "TraceContext":
        """A new span position under the same trace (baggage shared)."""
        return TraceContext(self.trace_id, os.urandom(8).hex(), self.baggage)

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, value, baggage: Optional[Dict[str, str]] = None):
        """Parse a traceparent string; None on anything malformed (a
        garbled header must never fail the request it rode in on)."""
        parts = value.split("-") if isinstance(value, str) else []
        if len(parts) != 4 or parts[0] != "00":
            return None
        trace_id, span_id = parts[1], parts[2]
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        try:
            int(trace_id, 16)
            int(span_id, 16)
        except ValueError:
            return None
        return cls(trace_id, span_id, baggage)

    def __repr__(self) -> str:
        return f"TraceContext({self.to_traceparent()!r})"


_trace_local = threading.local()


def current_trace() -> Optional[TraceContext]:
    """The calling thread's active trace context, or None (untraced)."""
    return getattr(_trace_local, "ctx", None)


@contextlib.contextmanager
def use_trace(ctx: Optional[TraceContext]):
    """Adopt ``ctx`` as the calling thread's current trace for the block.
    Threads do not inherit context — fan-out sites (shard pools, handler
    threads) adopt the parent explicitly, which is what keeps span
    parentage honest across thread boundaries."""
    prev = getattr(_trace_local, "ctx", None)
    _trace_local.ctx = ctx
    try:
        yield ctx
    finally:
        _trace_local.ctx = prev


def inject(header: Dict[str, Any],
           ctx: Optional[TraceContext] = None) -> Dict[str, Any]:
    """Write ``ctx`` (default: the thread's current trace) into a wire
    header dict in W3C style; no-op when untraced. Returns ``header``."""
    if ctx is None:
        ctx = current_trace()
    if ctx is not None:
        header[TRACEPARENT_KEY] = ctx.to_traceparent()
        if ctx.baggage:
            header[TRACE_BAGGAGE_KEY] = dict(ctx.baggage)
    return header


def extract(header: Dict[str, Any]) -> Optional[TraceContext]:
    """Recover a TraceContext from a wire header; None when absent or
    malformed. The inverse of :func:`inject`."""
    raw = header.get(TRACEPARENT_KEY)
    if not raw:
        return None
    bag = header.get(TRACE_BAGGAGE_KEY)
    return TraceContext.from_traceparent(
        raw, bag if isinstance(bag, dict) else None)


#: Per-thread-shard ring size for histograms. 1024 doubles (per writing
#: thread) bounds memory while keeping p50/p95 meaningful for the window
#: counts real runs produce (a 10-epoch async run commits O(1e3) windows).
DEFAULT_MAX_SAMPLES = 1024

#: Bounded span-event timeline (registry-wide). deque(maxlen=) appends are
#: atomic in CPython, so the span record path needs no lock either.
MAX_SPAN_EVENTS = 4096


def _full_name(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def _span_row(name: str, t0: float, dur_s: float,
              labels: Dict[str, Any]) -> dict:
    """Span event -> row dict. Trace identity keys are hoisted out of the
    labels into top-level fields so consumers (merge views, Chrome export)
    key on ``row["trace_id"]`` while labels stay low-cardinality."""
    row = {"kind": "span", "name": name, "labels": labels,
           "t0": t0, "dur_s": dur_s}
    if labels and "trace_id" in labels:
        row["labels"] = {k: v for k, v in labels.items()
                        if k not in _TRACE_KEYS}
        for k in _TRACE_KEYS:
            if k in labels:
                row[k] = labels[k]
    return row


class _Metric:
    """Shared shard plumbing: per-thread state boxes, created lock-free on
    the hot path after the first call per thread."""

    kind = "metric"

    def __init__(self, name: str, labels: Dict[str, Any]):
        self.name = name
        self.labels = dict(labels)
        self._local = threading.local()
        self._shards: List[Any] = []
        self._shards_lock = threading.Lock()  # shard CREATION only

    def _shard(self):
        shard = getattr(self._local, "shard", None)
        if shard is None:
            shard = self._new_shard()
            self._local.shard = shard
            with self._shards_lock:
                self._shards.append(shard)
        return shard

    def _new_shard(self):
        raise NotImplementedError

    @property
    def full_name(self) -> str:
        return _full_name(self.name, self.labels)

    def row(self) -> dict:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic count. ``inc`` adds to the calling thread's shard; the
    value is the sum over shards (reading concurrent ints is safe under
    the GIL — at worst a read misses an in-flight bump)."""

    kind = "counter"

    def _new_shard(self):
        return [0]

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"Counter is monotonic; use a Gauge for "
                             f"up/down values (got inc({n}))")
        self._shard()[0] += n

    @property
    def value(self):
        return sum(s[0] for s in list(self._shards))

    def row(self) -> dict:
        return {"kind": self.kind, "name": self.name, "labels": self.labels,
                "value": self.value}


class Gauge(_Metric):
    """Last-write-wins ``set`` plus lock-free up/down ``add`` deltas:
    ``value = last set + sum of adds`` (in-flight counts use add(±1))."""

    kind = "gauge"

    def __init__(self, name: str, labels: Dict[str, Any]):
        super().__init__(name, labels)
        self._base = 0.0

    def _new_shard(self):
        return [0.0]

    def set(self, value: float) -> None:
        self._base = value

    def add(self, n: float) -> None:
        self._shard()[0] += n

    @property
    def value(self) -> float:
        return self._base + sum(s[0] for s in list(self._shards))

    def row(self) -> dict:
        return {"kind": self.kind, "name": self.name, "labels": self.labels,
                "value": self.value}


class _HistShard:
    __slots__ = ("n", "total", "lo", "hi", "ring", "i", "cap")

    def __init__(self, cap: int):
        self.n = 0
        self.total = 0.0
        self.lo = float("inf")
        self.hi = float("-inf")
        self.ring: List[float] = []
        self.i = 0
        self.cap = cap


class Histogram(_Metric):
    """Bounded histogram: exact count/sum/min/max over every sample, p50/p95
    from a per-thread ring of the most recent ``max_samples`` values."""

    kind = "histogram"

    def __init__(self, name: str, labels: Dict[str, Any],
                 max_samples: int = DEFAULT_MAX_SAMPLES):
        super().__init__(name, labels)
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.max_samples = int(max_samples)

    def _new_shard(self):
        return _HistShard(self.max_samples)

    def record(self, value: float) -> None:
        v = float(value)
        s = self._shard()
        s.n += 1
        s.total += v
        if v < s.lo:
            s.lo = v
        if v > s.hi:
            s.hi = v
        if len(s.ring) < s.cap:
            s.ring.append(v)
        else:  # overwrite oldest: bounded memory, recency-weighted kept set
            s.ring[s.i] = v
            s.i = (s.i + 1) % s.cap

    def stats(self) -> dict:
        shards = list(self._shards)
        n = sum(s.n for s in shards)
        if n == 0:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "p50": None, "p95": None, "samples_kept": 0}
        kept = sorted(v for s in shards for v in s.ring)

        def pct(q: float) -> float:
            return kept[min(len(kept) - 1, int(q * len(kept)))]

        return {"count": n,
                "sum": sum(s.total for s in shards),
                "min": min(s.lo for s in shards),
                "max": max(s.hi for s in shards),
                "p50": pct(0.50), "p95": pct(0.95),
                "samples_kept": len(kept)}

    def row(self) -> dict:
        out = {"kind": self.kind, "name": self.name, "labels": self.labels}
        out.update(self.stats())
        return out


class _NullMetric:
    """Shared no-op standing in for every metric when no registry is
    installed — call sites stay branch-free."""

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def add(self, n: float) -> None:
        pass

    def record(self, value: float) -> None:
        pass

    @property
    def value(self):
        return 0


_NULL = _NullMetric()


class MetricsRegistry:
    """Process-local metric store. Creation (``counter``/``gauge``/
    ``histogram``) is get-or-create keyed by (name, labels): the fast path
    is an unlocked dict read (safe in CPython), the miss path takes the
    creation lock once per metric."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, tuple], _Metric] = {}
        self._create_lock = threading.Lock()
        self.spans: "collections.deque" = collections.deque(
            maxlen=MAX_SPAN_EVENTS)

    def _get(self, cls, name: str, labels: Dict[str, Any], **kw) -> _Metric:
        key = (name, tuple(sorted(labels.items())))
        m = self._metrics.get(key)
        if m is None:
            # the registry contract (METRIC_NAMES) is enforced on the
            # creation path only — the hot path stays a bare dict hit
            want = declared_kind(name)
            if want is not None and want != cls.kind:
                raise TypeError(
                    f"metric {name!r} is declared as a {want} in "
                    f"telemetry.METRIC_NAMES but requested as {cls.kind}")
            with self._create_lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, labels, **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {_full_name(name, labels)!r} already "
                            f"registered as {m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, max_samples: int = DEFAULT_MAX_SAMPLES,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, max_samples=max_samples)

    def record_span(self, name: str, t0: float, dur_s: float,
                    labels: Dict[str, Any]) -> None:
        self.spans.append((name, t0, dur_s, labels))
        rec = _recorder
        if rec is not None:  # flight-recorder ring (lock-light, bounded)
            rec.record_span_event(name, t0, dur_s, labels)
        hist_labels = labels
        if labels and "trace_id" in labels:
            # trace ids are per-span unique: keeping them would mint one
            # histogram per event. Identity stays on the timeline only.
            hist_labels = {k: v for k, v in labels.items()
                           if k not in _TRACE_KEYS}
        self.histogram(f"span.{name}.duration_s", **hist_labels).record(dur_s)

    # -- export -----------------------------------------------------------
    def rows(self) -> Iterator[dict]:
        for m in list(self._metrics.values()):
            yield m.row()
        for name, t0, dur, labels in list(self.spans):
            yield _span_row(name, t0, dur, labels)

    def recent_spans(self, limit: int = 100) -> List[dict]:
        """The newest ``limit`` span events as row dicts (oldest first) —
        the live ``recent-spans`` introspection endpoint's payload."""
        events = list(self.spans)[-max(0, int(limit)):]
        return [_span_row(name, t0, dur, labels)
                for name, t0, dur, labels in events]

    def snapshot(self) -> dict:
        """Structured view for ``Trainer.get_telemetry()`` and the live
        ``metrics-snapshot`` endpoint: metric rows grouped by kind, keyed by
        ``name{label=...}``.

        Lock-consistent: the metric SET and the span timeline are copied
        under the creation lock, so a snapshot taken from an introspection
        handler thread never sees a half-registered metric or tears the
        span deque against a concurrent ``clear()``. Individual values are
        still read without stopping writers (a read may miss an in-flight
        bump — monotonic, never garbage)."""
        with self._create_lock:
            metrics = list(self._metrics.values())
            spans = list(self.spans)
        out: dict = {"counters": {}, "gauges": {}, "histograms": {},
                     "spans": []}
        rows = [m.row() for m in metrics] + [
            _span_row(name, t0, dur, labels)
            for name, t0, dur, labels in spans]
        for row in rows:
            kind = row["kind"]
            if kind == "span":
                out["spans"].append(row)
                continue
            key = _full_name(row["name"], row["labels"])
            if kind == "counter":
                out["counters"][key] = row["value"]
            elif kind == "gauge":
                out["gauges"][key] = row["value"]
            else:
                out["histograms"][key] = {
                    k: v for k, v in row.items()
                    if k not in ("kind", "name", "labels")}
        return out

    def dump_jsonl(self, path: str) -> str:
        """Write every metric + span event as JSON lines; returns ``path``."""
        with open(path, "w") as f:
            f.write(json.dumps({"kind": "meta", "schema": SCHEMA_VERSION,
                                "unix_time": time.time()}) + "\n")
            for row in self.rows():
                f.write(json.dumps(row) + "\n")
        return path

    def clear(self) -> None:
        with self._create_lock:
            self._metrics.clear()
        self.spans.clear()


def load_jsonl(path: str) -> List[dict]:
    """Load a dumped artifact back into a list of row dicts (meta line
    included as row 0).

    A truncated TRAILING line — the shape a crash-time dump leaves when the
    process dies mid-write — is tolerated: the parsed prefix is returned
    and a warning is emitted. Corruption anywhere *before* the last line
    still raises (that artifact is damaged, not merely cut short)."""
    with open(path) as f:
        lines = [ln for ln in (raw.strip() for raw in f) if ln]
    rows = []
    for i, line in enumerate(lines):
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                import warnings

                # silent corruption becomes visible in fleet digests: the
                # recovery is tolerated but COUNTED, not just warned about
                counter("telemetry.load.truncated_tail").inc()
                warnings.warn(
                    f"{path}: dropping truncated trailing line "
                    f"({line[:60]!r}...); returning the "
                    f"{len(rows)}-row parsed prefix (crash-time dump)",
                    RuntimeWarning, stacklevel=2)
                break
            raise
    return rows


# -- module-level default registry (telemetry is default-ON) ----------------

_default = MetricsRegistry()
_installed: Optional[MetricsRegistry] = _default


def get_registry() -> Optional[MetricsRegistry]:
    return _installed


def install(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process registry (tests install a fresh one per case)."""
    global _installed
    _installed = registry
    return registry


def uninstall() -> None:
    """Disable telemetry: module-level accessors become no-ops."""
    global _installed
    _installed = None


def reset() -> MetricsRegistry:
    """Install a fresh registry (and return it) — run isolation helper."""
    return install(MetricsRegistry())


def counter(name: str, **labels):
    reg = _installed
    return _NULL if reg is None else reg.counter(name, **labels)


def gauge(name: str, **labels):
    reg = _installed
    return _NULL if reg is None else reg.gauge(name, **labels)


def histogram(name: str, **labels):
    reg = _installed
    return _NULL if reg is None else reg.histogram(name, **labels)


@contextlib.contextmanager
def span(name: str, **labels):
    """Time a block into ``span.<name>.duration_s`` (+ the event timeline).
    Timestamps are ``time.monotonic``-class (perf_counter); pairs of events
    order correctly within a process but mean nothing across processes.

    When the calling thread has an active :class:`TraceContext` (via
    :func:`use_trace` or an enclosing ``span``), the event is recorded as a
    child of that context, a fresh child context is made current for the
    duration of the block, and that context is yielded (None when
    untraced) — so nested spans chain parent -> child and the context can
    be injected into outbound wire headers."""
    reg = _installed
    if reg is None:
        yield None
        return
    parent = current_trace()
    if parent is None:
        t0 = time.perf_counter()
        try:
            yield None
        finally:
            reg.record_span(name, t0, time.perf_counter() - t0, labels)
        return
    ctx = parent.child()
    labels = dict(labels, trace_id=ctx.trace_id, span_id=ctx.span_id,
                  parent_id=parent.span_id)
    _trace_local.ctx = ctx
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        _trace_local.ctx = parent
        reg.record_span(name, t0, time.perf_counter() - t0, labels)


def record_trace_span(ctx: Optional["TraceContext"], name: str, t0: float,
                      dur_s: float, **labels) -> None:
    """Record one already-measured span as a child of ``ctx`` (plain
    untraced event when ctx is None). For code whose span boundaries do
    not nest as a ``with`` block — e.g. the generation scheduler, where a
    request's queue-wait starts on the submitting thread and ends
    iterations later on the scheduler thread. ``t0`` must be a
    ``time.perf_counter`` reading (the registry's span time base)."""
    reg = _installed
    if reg is None:
        return
    if ctx is not None:
        child = ctx.child()
        labels = dict(labels, trace_id=child.trace_id,
                      span_id=child.span_id, parent_id=ctx.span_id)
    reg.record_span(name, t0, dur_s, labels)


# -- flight-recorder sink (health/recorder.py plugs in here) -----------------
#
# The recorder is a plain object with ``record(kind, **fields)`` and
# ``record_span_event(name, t0, dur_s, labels)`` methods; telemetry holds
# only the slot so the dependency points health -> telemetry, never back.
# The slot is module-global and read without a lock (same CPython-read
# discipline as ``_installed``): the record paths stay lock-free.

_recorder: Optional[Any] = None


def set_recorder(rec: Optional[Any]) -> Optional[Any]:
    """Install (or clear, with None) the process flight-recorder sink."""
    global _recorder
    _recorder = rec
    return rec


def get_recorder() -> Optional[Any]:
    return _recorder


def record_event(kind: str, /, **fields) -> None:
    """Append one structured event to the flight-recorder ring (no-op when
    no recorder is installed). Events are forensic breadcrumbs — wire
    outcomes, membership transitions, window phase profiles, alerts — that
    only leave the process inside a postmortem bundle."""
    rec = _recorder
    if rec is not None:
        rec.record(kind, **fields)


# -- per-process artifact identity -------------------------------------------
#
# telemetry/health must stay device-runtime-free, so the process index is
# PUSHED in by the trainers (which know the real one) instead of read from
# the accelerator runtime here. Default 0 = single-process runs unchanged.

_process_index = 0


def set_process_index(index: int) -> int:
    """Declare this process's fleet index (trainers call this once the
    runtime is up); stamps ``flush_at_exit`` artifacts and recorder dump
    paths so shared-FS fleets cannot clobber each other."""
    global _process_index
    index = int(index)
    if index < 0:
        raise ValueError(f"process index must be >= 0, got {index}")
    _process_index = index
    return _process_index


def process_index() -> int:
    return _process_index


def per_process_path(path: str) -> str:
    """``path`` suffixed with this process's identity (``.p{index}``).
    Merge tooling globs the family (``path.p*``)."""
    return f"{path}.p{_process_index}"


# -- crash-safe artifact flush ----------------------------------------------

_flush_state: Dict[str, Optional[str]] = {"path": None}


def flush_at_exit(path: str) -> str:
    """Arrange for the installed registry to be dumped to
    ``path.p{process_index}`` at interpreter exit, so the span/metric
    artifact survives a crashed or watchdog-killed run
    (``checkpoint_and_raise`` unwinds through here) and multi-process
    fleets on a shared FS each keep their own copy. Idempotent: one atexit
    hook total, the most recent path wins; the suffix is applied at FLUSH
    time so a process index declared after this call still lands. The hook
    is a no-op when telemetry is uninstalled at exit time."""
    first = _flush_state["path"] is None
    _flush_state["path"] = str(path)
    if first:
        atexit.register(_flush_now)
    return per_process_path(_flush_state["path"])


def _flush_now() -> Optional[str]:
    path, reg = _flush_state["path"], _installed
    if path is None or reg is None:
        return None
    try:
        return reg.dump_jsonl(per_process_path(path))
    except OSError:
        return None  # a dead disk at exit must not mask the real failure
