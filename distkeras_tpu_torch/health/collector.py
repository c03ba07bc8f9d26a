"""Fleet telemetry collector (port of ``distkeras_tpu/health/collector.py``)
— the coordinator-side sink of the distributed tracing plane (DESIGN.md
§15).

Per-process registries (telemetry.py) see only their own process; the
traces stitched across sockets are useless if their halves stay in
different address spaces. This module closes the loop: workers push their
registry rows (``MetricsRegistry.rows()``, JSON-serializable) as one batch
over the existing remote_ps framing (op ``telemetry_put``), the collector
on the coordinator shard (shard 0) buffers them, and readers get one
merged, pid-tagged row stream (op ``telemetry_merged``, the health CLI,
``telemetry_summary --merge``, the merged Chrome trace). The port's
:class:`~distkeras_tpu_torch.parallel.remote_ps.ParameterServerService`
mounts those two ops.

Backpressure rules (the collector must never threaten the run it
observes):

- buffers are BOUNDED: at most ``max_batches`` batches are held; when a
  new batch arrives over the bound, the OLDEST batch is dropped (recency
  wins — the newest rows explain the current state) and
  ``collector.dropped_batches`` counts it;
- a single batch over ``max_rows_per_batch`` is truncated, keeping the
  row prefix, with the overflow counted in ``collector.dropped_rows``;
- pushes are best-effort end to end: the client swallows transport
  failures (``RemoteParameterServer.put_telemetry``), the server answers
  an absent collector with ``ok=False`` — telemetry can degrade, the
  training run cannot.

No framework import (health-plane rule): rows are plain dicts by the time they
arrive here.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Tuple

from distkeras_tpu_torch import telemetry

#: Bounds chosen for a realistic fleet: each process pushes one batch per
#: run (plus optional periodic pushes), so 256 batches of <=20k rows hold
#: an entire large fleet's end-of-run state with slack.
DEFAULT_MAX_BATCHES = 256
DEFAULT_MAX_ROWS_PER_BATCH = 20000


class TelemetryCollector:
    """Bounded multi-process span/metric batch sink.

    ``add_batch`` is called from service handler threads (one per
    connection); ``merged_rows`` from health/CLI readers. One lock covers
    the deque — every operation under it is O(batch), no I/O.
    """

    def __init__(self, max_batches: int = DEFAULT_MAX_BATCHES,
                 max_rows_per_batch: int = DEFAULT_MAX_ROWS_PER_BATCH):
        self.max_batches = int(max_batches)
        self.max_rows_per_batch = int(max_rows_per_batch)
        self._batches: collections.deque = collections.deque()
        self._pids: set = set()
        self._lock = threading.Lock()

    def add_batch(self, pid, rows: List[dict]) -> dict:
        """Absorb one process's row batch; returns
        ``{"accepted": n, "dropped": m}`` so the pusher can observe its
        own loss. Oversized batches are truncated, an over-full buffer
        drops its oldest batch — both with counters, never an error."""
        pid = int(pid)
        rows = list(rows)
        dropped = 0
        if len(rows) > self.max_rows_per_batch:
            dropped = len(rows) - self.max_rows_per_batch
            rows = rows[:self.max_rows_per_batch]
            telemetry.counter("collector.dropped_rows").inc(dropped)
        with self._lock:
            while len(self._batches) >= self.max_batches:
                self._batches.popleft()
                telemetry.counter("collector.dropped_batches").inc()
            self._batches.append((pid, rows))
            self._pids.add(pid)
            processes = len(self._pids)
        telemetry.counter("collector.batches").inc()
        telemetry.counter("collector.rows").inc(len(rows))
        telemetry.gauge("collector.processes").set(processes)
        return {"accepted": len(rows), "dropped": dropped}

    def adopt_batches(self, batches: List[Tuple[int, List[dict]]]) -> int:
        """Seed a freshly-mounted collector from a replicated mirror —
        the promotion half of coordinator failover (parallel/failover.py):
        the standby's :class:`StandbyState` mirrors every
        ``telemetry_put`` batch the old coordinator absorbed, and the
        collector that re-mounts on the NEW coordinator starts from that
        mirror instead of empty. Same bounds/counters as live pushes.
        Returns the number of rows adopted."""
        total = 0
        for pid, rows in batches:
            total += self.add_batch(pid, rows)["accepted"]
        return total

    def merged_rows(self, local_pid: Optional[int] = None) -> List[dict]:
        """Every buffered row, each tagged with its origin ``pid``. When
        ``local_pid`` is given, the hosting process's OWN live registry is
        appended under that pid — so the coordinator's half of each trace
        is in the merge without the coordinator pushing to itself."""
        with self._lock:
            batches: List[Tuple[int, List[dict]]] = list(self._batches)
        if local_pid is not None:
            reg = telemetry.get_registry()
            if reg is not None:
                batches.append((int(local_pid), list(reg.rows())))
        out = []
        for pid, rows in batches:
            for row in rows:
                if "pid" not in row:
                    row = dict(row, pid=pid)
                out.append(row)
        return out

    @property
    def processes(self) -> List[int]:
        with self._lock:
            return sorted(self._pids)


def worker_table(rows: List[dict], now: float) -> Dict[str, dict]:
    """Fold (merged, possibly multi-process) telemetry rows into one dict
    per worker for the CLI's ``watch --table`` mode: heartbeat age,
    windows completed, last window duration, staleness, degraded-window
    count, straggler flag. Rates are the caller's job (it has the poll
    interval and the previous sample)."""
    workers: Dict[str, dict] = {}

    def entry(labels) -> Optional[dict]:
        worker = (labels or {}).get("worker")
        if worker is None:
            return None
        return workers.setdefault(str(worker), {})

    for row in rows:
        name, kind = row.get("name", ""), row.get("kind")
        if kind == "gauge" and name.startswith("health.worker."):
            w = entry(row.get("labels"))
            if w is None:
                continue
            field = name[len("health.worker."):]
            if field == "heartbeat_time":
                # across processes the newest heartbeat wins (a worker
                # appears once per process snapshot in a merged stream)
                w["age_s"] = min(w.get("age_s", float("inf")),
                                 round(now - row["value"], 3))
            elif field == "straggler":
                w["straggler"] = bool(w.get("straggler")) or bool(
                    row["value"])
            else:
                w[field] = row["value"]
        elif kind == "counter" and name == "health.worker.windows":
            w = entry(row.get("labels"))
            if w is not None:
                w["windows"] = w.get("windows", 0) + row["value"]
        elif kind == "counter" and name == "host_async.degraded_windows":
            w = entry(row.get("labels"))
            if w is not None:
                w["degraded"] = w.get("degraded", 0) + row["value"]
        elif kind == "gauge" and name == "health.alerts.active":
            # per-worker-labelled SLO breaches land in that worker's row;
            # fleet-wide alerts (no worker label) are the CLI's summary
            # line, not a row
            w = entry(row.get("labels"))
            if w is not None and row.get("value"):
                w["alerts"] = w.get("alerts", 0) + 1
        elif kind == "gauge" and name == "timeseries.trends_active":
            # per-worker-labelled trend breaches (a stalled window clock
            # names its worker, DESIGN.md §24) land in that worker's row;
            # fleet-wide trends are the CLI's TRENDS summary line
            w = entry(row.get("labels"))
            if w is not None and row.get("value"):
                w["trends"] = w.get("trends", 0) + 1
    for w in workers.values():
        w.setdefault("degraded", 0)
        w.setdefault("alerts", 0)
        w.setdefault("trends", 0)
    return workers


__all__ = ["TelemetryCollector", "worker_table",
           "DEFAULT_MAX_BATCHES", "DEFAULT_MAX_ROWS_PER_BATCH"]
