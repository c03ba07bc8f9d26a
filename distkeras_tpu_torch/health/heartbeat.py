"""Worker heartbeats + straggler detection for the live health plane
(port of ``distkeras_tpu/health/heartbeat.py``).

A DOWNPOUR-family system fails quietly when one worker slows down: its
windows stretch, its commits arrive ever staler, and the aggregate loss
curve just gets mushier — nothing crashes. The fix the reference never had
is the Dapper-style property that every worker's liveness is *queryable
while it runs* (DESIGN.md §9): each `host_async` worker publishes a
per-window heartbeat (wall time, server clock, staleness, window duration)
into the telemetry registry, and a :class:`StragglerDetector` flags workers
whose window time exceeds ``k×`` the rolling median of recent windows
across the fleet.

Like ``telemetry.py``, this module never imports torch — publishing a
heartbeat can never introduce a device sync on the worker's step path.

Gauges/counters (all visible in snapshots, the introspection endpoints,
and the Prometheus export):

- ``health.worker.heartbeat_time{worker=}`` — unix time of the last window
- ``health.worker.clock{worker=}``         — server clock at its last fold
- ``health.worker.staleness{worker=}``     — staleness of that fold
- ``health.worker.window_s{worker=}``      — last window duration
- ``health.worker.windows{worker=}``       — windows completed (counter)
- ``health.worker.straggler{worker=}``     — 1 while flagged, else 0
- ``health.stragglers``                    — currently-flagged worker count
- ``health.straggler.events{worker=}``     — flag *transitions* (counter)
"""

from __future__ import annotations

import collections
import statistics
import threading
import time
from typing import Callable, List

from distkeras_tpu_torch import telemetry


class HeartbeatPublisher:
    """Publishes one worker-window heartbeat into the telemetry registry.

    ``time_fn`` is injectable for deterministic tests (defaults to
    ``time.time`` — heartbeat *age* is what the endpoint reports, so the
    clock must be wall time, not monotonic)."""

    def __init__(self, time_fn: Callable[[], float] = time.time):
        self._time = time_fn

    def publish(self, worker: int, clock: int, staleness: float,
                window_s: float) -> None:
        telemetry.gauge("health.worker.heartbeat_time",
                        worker=worker).set(self._time())
        telemetry.gauge("health.worker.clock", worker=worker).set(int(clock))
        telemetry.gauge("health.worker.staleness",
                        worker=worker).set(float(staleness))
        telemetry.gauge("health.worker.window_s",
                        worker=worker).set(float(window_s))
        telemetry.counter("health.worker.windows", worker=worker).inc()


class StragglerDetector:
    """Flags workers whose window duration exceeds ``k×`` the rolling
    median of the fleet's recent window durations.

    The median is computed over a bounded pooled ring of the last
    ``history`` observed durations across ALL workers, *excluding* the
    observation being judged — so the verdict for a scripted sequence of
    durations is a pure function of that sequence (determinism is tested).
    A worker is un-flagged by its next sub-threshold window; ``observe``
    returns the current verdict.

    ``min_samples`` guards cold start: no verdicts until the pool has that
    many durations (the first windows of a run include compile time and
    would otherwise flag everyone or no one arbitrarily).
    """

    def __init__(self, k: float = 3.0, min_samples: int = 4,
                 history: int = 64):
        if k <= 1.0:
            raise ValueError(f"straggler threshold k must be > 1, got {k}")
        if min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {min_samples}")
        self.k = float(k)
        self.min_samples = int(min_samples)
        self._ring: collections.deque = collections.deque(
            maxlen=int(history))
        self._flagged: dict = {}
        self._lock = threading.Lock()

    def observe(self, worker: int, window_s: float) -> bool:
        """Record one worker window; returns True while flagged."""
        window_s = float(window_s)
        with self._lock:
            pooled = list(self._ring)
            self._ring.append(window_s)
            if len(pooled) >= self.min_samples:
                med = statistics.median(pooled)
                flagged = med > 0 and window_s > self.k * med
            else:
                flagged = False
            was = self._flagged.get(worker, False)
            self._flagged[worker] = flagged
            n_flagged = sum(1 for f in self._flagged.values() if f)
        telemetry.gauge("health.worker.straggler",
                        worker=worker).set(1.0 if flagged else 0.0)
        telemetry.gauge("health.stragglers").set(n_flagged)
        if flagged and not was:
            telemetry.counter("health.straggler.events", worker=worker).inc()
        return flagged

    @property
    def stragglers(self) -> List[int]:
        """Currently-flagged worker ids, sorted."""
        with self._lock:
            return sorted(w for w, f in self._flagged.items() if f)
