"""Time-series metrics plane: bounded history + trend detection (§24;
port of ``distkeras_tpu/health/timeseries.py``).

Every observability layer so far judges an instant (``SloEngine`` reads
the live registry, ``watch`` polls a snapshot) or a committed artifact
(``regression_gate``). Nothing can see a slow HBM leak, a creeping queue
depth, or a stalled watermark *over time* — which is exactly how
hours-scale runs die. This module adds the time dimension:

:class:`MetricStore`
    A bounded store that periodically snapshots the live registry
    (``telemetry.get_registry().rows()``) into per-metric rings of
    ``(t, value)`` points. Three retention tiers per series — raw (every
    collection), 10 s, 60 s — give minutes of fine history and hours of
    coarse history under a hard memory budget: the budget caps the
    NUMBER OF SERIES (``budget_bytes // bytes-per-full-series``); series
    past the cap are dropped and counted (``timeseries.dropped_series``),
    never silently resized. Histograms expand into one series per stored
    stat (``count``/``p50``/``p95``/``max``); counters keep their
    cumulative value (:meth:`MetricStore.rate` derives per-second rates
    over any window).

:class:`TrendDetector` suite
    :class:`LeakDetector` (sustained monotone growth — HBM bytes, queue
    depth, collector drops), :class:`StallDetector` (a metric that must
    advance stopped — data-service watermark, worker window clock) and
    :class:`DriftDetector` (recent window drifted from the series' OWN
    earlier baseline). :class:`TrendMonitor` evaluates them against the
    store, mints typed :class:`TrendEvent` rows onto the flight-recorder
    ring (``telemetry.record_event("trend", ...)``) and mirrors active
    trends into ``timeseries.trends_active{trend=...}`` gauges — which
    makes every detector :class:`~distkeras_tpu_torch.health.slo.SloSpec`-
    compatible (:func:`trend_specs` builds the specs), so trend breaches
    ride the existing alert/burn-rate/on_breach machinery unchanged.

Design constraints (the health-plane rules, enforced by tests):

- **No framework import.** Collection can never sync a device. The HBM
  series is the ``observability.hbm_*`` gauges that the port's
  :func:`~distkeras_tpu_torch.observability.hbm_stats` publishes.
- **Off the step path.** ``collect`` runs on its own daemon thread (or
  explicitly from tests); the instrumented code never calls in here.
- **Honest clocks.** Points are stamped with the collector's LOCAL wall
  clock; cross-process series are only roughly comparable (same caveat
  as the flight-recorder merge, DESIGN.md §16).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from distkeras_tpu_torch import telemetry

#: Retention tiers: (tier name, minimum seconds between kept points).
#: ``raw`` keeps every collection; the coarse tiers thin by time so one
#: series spans minutes (raw), an hour (10s) and most of a day (60s).
TIERS: Tuple[Tuple[str, float], ...] = (("raw", 0.0), ("10s", 10.0),
                                        ("60s", 60.0))

#: Per-tier ring capacities (points). At the default 2 s collection
#: interval: raw = ~17 min, 10s = 1 h, 60s = 8 h.
TIER_POINTS = {"raw": 512, "10s": 360, "60s": 480}

#: Approximate CPython cost of one stored point — a (float, float) tuple
#: plus its deque slot. Deliberately generous: the budget must bound the
#: worst case, not the average.
POINT_BYTES = 120

#: Histogram stats stored as separate series (the registry row fields).
HISTOGRAM_FIELDS = ("count", "p50", "p95", "max")

_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[float], width: int = 32) -> str:
    """Render a value sequence as a unicode sparkline (``telemetry_summary``
    and the watch table use this). Flat series render as a low bar; the
    newest ``width`` values are shown."""
    vals = [float(v) for v in values][-max(1, int(width)):]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _BLOCKS[0] * len(vals)
    span = hi - lo
    return "".join(
        _BLOCKS[min(len(_BLOCKS) - 1,
                    int((v - lo) / span * len(_BLOCKS)))] for v in vals)


def _labels_key(labels: Optional[dict]) -> tuple:
    return tuple(sorted((labels or {}).items()))


def _match_labels(have: Optional[dict],
                  want: Optional[Dict[str, str]]) -> bool:
    if not want:
        return True
    h = have or {}
    return all(str(h.get(k)) == str(v) for k, v in want.items())


class _Series:
    """One metric stream's tiered point rings."""

    __slots__ = ("name", "labels", "field", "kind", "rings", "_last_kept")

    def __init__(self, name: str, labels: dict, field: str, kind: str):
        self.name = name
        self.labels = dict(labels)
        self.field = field
        self.kind = kind
        self.rings: Dict[str, collections.deque] = {
            tier: collections.deque(maxlen=TIER_POINTS[tier])
            for tier, _ in TIERS}
        self._last_kept = {tier: float("-inf") for tier, _ in TIERS}

    def append(self, t: float, v: float) -> None:
        for tier, min_dt in TIERS:
            if t - self._last_kept[tier] >= min_dt:
                self.rings[tier].append((t, v))
                self._last_kept[tier] = t

    def points(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Points within the trailing ``window_s`` (None = the whole raw
        ring), read from the finest tier whose retention still covers the
        window start — raw for recent windows, coarse for long ones."""
        if window_s is None:
            return list(self.rings["raw"])
        now = time.time() if now is None else now
        start = now - float(window_s)
        for tier, _ in TIERS:
            ring = self.rings[tier]
            if ring and ring[0][0] <= start:
                return [(t, v) for t, v in ring if t >= start]
        # no tier reaches back that far: the one reaching furthest back
        # wins, ties to the finest (early in a run every ring starts at
        # the same instant — raw holds the most points over that span)
        best = None
        for tier, _ in TIERS:
            ring = self.rings[tier]
            if ring and (best is None or ring[0][0] < best[0][0]):
                best = ring
        return [(t, v) for t, v in (best or ()) if t >= start]

    def n_points(self) -> int:
        return sum(len(r) for r in self.rings.values())


class MetricStore:
    """Bounded tiered history of the live registry.

    ``collect()`` is the whole algorithm (call it from tests);
    ``start``/``stop`` wrap it in a daemon thread. The memory budget is
    enforced as a hard cap on the number of series: a full series costs
    ``POINT_BYTES * sum(TIER_POINTS.values())`` bytes, so
    ``max_series = budget_bytes / that`` — overflowing series are dropped
    and counted, never silently thinned.
    """

    def __init__(self, budget_bytes: int = 8 << 20,
                 interval_s: float = 2.0,
                 clock: Callable[[], float] = time.time):
        if budget_bytes < 1:
            raise ValueError(f"budget_bytes must be >= 1, "
                             f"got {budget_bytes}")
        per_series = POINT_BYTES * sum(TIER_POINTS.values())
        self.budget_bytes = int(budget_bytes)
        self.max_series = max(16, self.budget_bytes // per_series)
        self.interval_s = float(interval_s)
        self._clock = clock
        self._series: Dict[tuple, _Series] = {}
        self._lock = threading.Lock()
        self._dropped: set = set()
        self._stop_evt: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # -- collection --------------------------------------------------------
    def _samples(self, row: dict):
        kind = row.get("kind")
        if kind in ("counter", "gauge"):
            yield "value", float(row.get("value", 0.0))
        elif kind == "histogram":
            for field in HISTOGRAM_FIELDS:
                v = row.get(field)
                if v is not None:
                    yield field, float(v)

    def collect(self, now: Optional[float] = None) -> int:
        """One snapshot pass over the live registry; returns the number of
        points appended. Spans are not stored (the recorder ring and the
        ``span.*.duration_s`` histograms already cover them)."""
        reg = telemetry.get_registry()
        if reg is None:
            return 0
        now = self._clock() if now is None else now
        t0 = time.perf_counter()
        appended = 0
        with self._lock:
            for row in reg.rows():
                if row.get("kind") == "span":
                    continue
                name, labels = row.get("name", ""), row.get("labels") or {}
                for field, value in self._samples(row):
                    key = (name, _labels_key(labels), field)
                    s = self._series.get(key)
                    if s is None:
                        if len(self._series) >= self.max_series:
                            if key not in self._dropped:
                                self._dropped.add(key)
                                telemetry.counter(
                                    "timeseries.dropped_series").inc()
                            continue
                        s = _Series(name, labels, field, row["kind"])
                        self._series[key] = s
                    s.append(now, value)
                    appended += 1
            n_series = len(self._series)
            n_points = sum(s.n_points() for s in self._series.values())
        telemetry.counter("timeseries.collections").inc()
        telemetry.gauge("timeseries.series").set(n_series)
        telemetry.gauge("timeseries.points").set(n_points)
        telemetry.histogram("timeseries.collect_s").record(
            time.perf_counter() - t0)
        return appended

    # -- queries -----------------------------------------------------------
    def query(self, name: str, labels: Optional[Dict[str, str]] = None,
              field: str = "value") -> List[_Series]:
        """Every stored series for ``name``/``field`` whose labels contain
        ``labels`` (subset match, same rule as SloSpec.labels)."""
        with self._lock:
            return [s for (n, _, f), s in self._series.items()
                    if n == name and f == field
                    and _match_labels(s.labels, labels)]

    def latest(self, name: str, labels: Optional[Dict[str, str]] = None,
               field: str = "value") -> Optional[float]:
        """Sum of the newest point across matching series (None when the
        store has never seen the metric)."""
        vals = [s.rings["raw"][-1][1] for s in self.query(name, labels,
                                                          field)
                if s.rings["raw"]]
        return sum(vals) if vals else None

    def rate(self, name: str, labels: Optional[Dict[str, str]] = None,
             window_s: float = 60.0,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second rate of a (cumulative) counter over the trailing
        window, summed across matching series: ``(last - first) /
        (t_last - t_first)``. None when any matching series has fewer
        than two points in the window (no honest interval to rate over).
        """
        now = self._clock() if now is None else now
        matched = self.query(name, labels, "value")
        if not matched:
            return None
        total = 0.0
        for s in matched:
            pts = s.points(window_s, now=now)
            if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
                return None
            total += (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0])
        return total

    # -- export ------------------------------------------------------------
    def rows(self, name: Optional[str] = None, tier: str = "raw",
             max_points: int = 120) -> List[dict]:
        """JSON-serializable series rows (the ``series`` wire op and the
        postmortem-bundle payload): the newest ``max_points`` of one tier
        per series, as ``[[t, v], ...]`` pairs."""
        with self._lock:
            series = [s for (n, _, f), s in sorted(self._series.items())
                      if name is None or n == name]
        out = []
        for s in series:
            pts = list(s.rings.get(tier) or ())[-max(1, int(max_points)):]
            if not pts:
                continue
            out.append({"kind": "timeseries", "name": s.name,
                        "labels": dict(s.labels), "field": s.field,
                        "metric_kind": s.kind, "tier": tier,
                        "points": [[t, v] for t, v in pts]})
        return out

    # -- daemon collector --------------------------------------------------
    def start(self, interval: Optional[float] = None) -> None:
        if self._thread is not None:
            return
        if interval is not None:
            self.interval_s = float(interval)
        if self.interval_s <= 0:
            raise ValueError(f"interval must be > 0, "
                             f"got {self.interval_s}")
        self._stop_evt = threading.Event()

        def loop():
            while not self._stop_evt.wait(self.interval_s):
                try:
                    self.collect()
                except Exception:
                    pass  # the historian must never take down the run

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="distkeras-timeseries")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join()
        self._thread = None
        self._stop_evt = None

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._dropped.clear()


# -- trend detection ----------------------------------------------------------

@dataclasses.dataclass
class TrendEvent:
    """A minted trend breach (or recovery): the typed record that rides
    the flight-recorder ring and the status digest."""

    trend: str
    detector: str  # "leak" | "stall" | "drift"
    metric: str
    labels: Optional[dict]
    observed: float
    threshold: float
    window_s: float
    time: float
    resolved: bool = False
    message: str = ""

    def to_row(self) -> dict:
        return dataclasses.asdict(self)


def _slope(pts: List[Tuple[float, float]]) -> float:
    """Least-squares slope (value units per second) of a point list."""
    n = len(pts)
    mt = sum(t for t, _ in pts) / n
    mv = sum(v for _, v in pts) / n
    den = sum((t - mt) ** 2 for t, _ in pts)
    if den <= 0.0:
        return 0.0
    return sum((t - mt) * (v - mv) for t, v in pts) / den


class LeakDetector:
    """Sustained monotone growth: breach when the least-squares slope over
    the window exceeds ``slope_per_s`` AND at least ``monotone_frac`` of
    consecutive deltas are non-negative (a sawtooth that grows and frees
    is load, not a leak)."""

    kind = "leak"

    def __init__(self, name: str, metric: str,
                 labels: Optional[Dict[str, str]] = None,
                 field: str = "value", window_s: float = 120.0,
                 slope_per_s: float = 1.0, monotone_frac: float = 0.9,
                 min_points: int = 8):
        self.name = name
        self.metric = metric
        self.labels = labels
        self.field = field
        self.window_s = float(window_s)
        self.slope_per_s = float(slope_per_s)
        self.monotone_frac = float(monotone_frac)
        self.min_points = int(min_points)

    def evaluate(self, store: MetricStore, now: float) -> List[TrendEvent]:
        out = []
        for s in store.query(self.metric, self.labels, self.field):
            pts = s.points(self.window_s, now=now)
            if len(pts) < self.min_points:
                continue
            slope = _slope(pts)
            rising = sum(1 for (_, a), (_, b) in zip(pts, pts[1:])
                         if b >= a)
            frac = rising / (len(pts) - 1)
            if slope > self.slope_per_s and frac >= self.monotone_frac:
                out.append(TrendEvent(
                    trend=self.name, detector=self.kind,
                    metric=self.metric, labels=s.labels or None,
                    observed=slope, threshold=self.slope_per_s,
                    window_s=self.window_s, time=now,
                    message=(f"{self.metric} growing {slope:.6g}/s over "
                             f"{self.window_s:.0f}s ({frac:.0%} of steps "
                             f"non-decreasing; ceiling "
                             f"{self.slope_per_s:.6g}/s)")))
        return out


class StallDetector:
    """A metric that must keep advancing stopped: breach when the series
    spans at least ``window_s`` of history yet advanced by no more than
    ``eps`` over it (watermarks, window clocks)."""

    kind = "stall"

    def __init__(self, name: str, metric: str,
                 labels: Optional[Dict[str, str]] = None,
                 field: str = "value", window_s: float = 30.0,
                 eps: float = 0.0, min_points: int = 4):
        self.name = name
        self.metric = metric
        self.labels = labels
        self.field = field
        self.window_s = float(window_s)
        self.eps = float(eps)
        self.min_points = int(min_points)

    def evaluate(self, store: MetricStore, now: float) -> List[TrendEvent]:
        out = []
        for s in store.query(self.metric, self.labels, self.field):
            pts = s.points(self.window_s, now=now)
            if len(pts) < self.min_points:
                continue
            if pts[-1][0] - pts[0][0] < 0.8 * self.window_s:
                continue  # not enough observed time to call a stall
            vals = [v for _, v in pts]
            advance = max(vals) - min(vals)
            if advance <= self.eps:
                out.append(TrendEvent(
                    trend=self.name, detector=self.kind,
                    metric=self.metric, labels=s.labels or None,
                    observed=advance, threshold=self.eps,
                    window_s=self.window_s, time=now,
                    message=(f"{self.metric} advanced {advance:.6g} over "
                             f"{pts[-1][0] - pts[0][0]:.0f}s "
                             f"(stall threshold {self.eps:.6g})")))
        return out


class DriftDetector:
    """Regression against the series' own baseline: the mean of the
    recent ``recent_s`` window vs the mean of the ``baseline_s`` window
    preceding it; breach when the relative drop (for ``direction="down"``;
    rise for ``"up"``) exceeds ``tolerance_frac``."""

    kind = "drift"

    def __init__(self, name: str, metric: str,
                 labels: Optional[Dict[str, str]] = None,
                 field: str = "value", recent_s: float = 60.0,
                 baseline_s: float = 300.0, tolerance_frac: float = 0.1,
                 direction: str = "down", min_points: int = 8):
        if direction not in ("down", "up"):
            raise ValueError(f"direction must be 'down' or 'up', "
                             f"got {direction!r}")
        self.name = name
        self.metric = metric
        self.labels = labels
        self.field = field
        self.recent_s = float(recent_s)
        self.baseline_s = float(baseline_s)
        self.tolerance_frac = float(tolerance_frac)
        self.direction = direction
        self.min_points = int(min_points)
        self.window_s = self.baseline_s  # uniform TrendEvent field

    def evaluate(self, store: MetricStore, now: float) -> List[TrendEvent]:
        out = []
        edge = now - self.recent_s
        for s in store.query(self.metric, self.labels, self.field):
            pts = s.points(self.baseline_s + self.recent_s, now=now)
            base = [v for t, v in pts if t < edge]
            recent = [v for t, v in pts if t >= edge]
            if len(base) < self.min_points or not recent:
                continue
            mb = sum(base) / len(base)
            mr = sum(recent) / len(recent)
            if mb == 0.0:
                continue
            delta = (mr - mb) / abs(mb)
            drifted = (delta < -self.tolerance_frac
                       if self.direction == "down"
                       else delta > self.tolerance_frac)
            if drifted:
                out.append(TrendEvent(
                    trend=self.name, detector=self.kind,
                    metric=self.metric, labels=s.labels or None,
                    observed=delta, threshold=self.tolerance_frac,
                    window_s=self.window_s, time=now,
                    message=(f"{self.metric} recent mean {mr:.6g} vs own "
                             f"baseline {mb:.6g} ({delta:+.1%}, tolerance "
                             f"{self.tolerance_frac:.0%})")))
        return out


def default_detectors(hbm_slope_bytes_per_s: float = 1 << 20,
                      queue_slope_per_s: float = 1.0,
                      drop_slope_per_s: float = 0.5,
                      stall_window_s: float = 30.0,
                      mfu_tolerance_frac: float = 0.10) -> List[Any]:
    """The stock long-horizon failure modes (DESIGN.md §24): HBM leak,
    queue-depth creep, collector drops, watermark / window-clock stalls,
    and MFU drift against the run's own baseline."""
    return [
        LeakDetector("hbm-leak", "observability.hbm_allocated_bytes",
                     window_s=120.0, slope_per_s=hbm_slope_bytes_per_s),
        LeakDetector("queue-growth", "serving.queue_depth",
                     window_s=60.0, slope_per_s=queue_slope_per_s),
        LeakDetector("collector-batch-drops", "collector.dropped_batches",
                     window_s=60.0, slope_per_s=drop_slope_per_s,
                     min_points=4),
        LeakDetector("collector-row-drops", "collector.dropped_rows",
                     window_s=60.0, slope_per_s=drop_slope_per_s,
                     min_points=4),
        StallDetector("data-watermark-stall", "data.service.cursor",
                      window_s=stall_window_s),
        StallDetector("window-clock-stall", "health.worker.clock",
                      window_s=stall_window_s),
        DriftDetector("mfu-drift", "observability.mfu",
                      tolerance_frac=mfu_tolerance_frac),
    ]


class TrendMonitor:
    """Evaluates detectors against a store; mints typed events.

    A detector turning up breaches flips ``timeseries.trends_active``
    gauges (one per trend name, plus a per-worker variant when the
    offending series carries a ``worker`` label — the watch table's
    TREND column reads those), bumps ``timeseries.trend_breaches`` and
    records a ``trend`` event on the flight-recorder ring. Recovery
    clears the gauges and records a resolution event.
    """

    def __init__(self, store: MetricStore, detectors: Sequence[Any],
                 clock: Callable[[], float] = time.time):
        self.store = store
        self.detectors = list(detectors)
        self._clock = clock
        self._lock = threading.Lock()
        self._active: Dict[str, TrendEvent] = {}
        self._gauge_keys: Dict[str, set] = {}
        self.history: List[TrendEvent] = []

    @staticmethod
    def _gauge_labels(ev: TrendEvent) -> List[dict]:
        labels = [{"trend": ev.trend}]
        worker = (ev.labels or {}).get("worker")
        if worker is not None:
            labels.append({"trend": ev.trend, "worker": str(worker)})
        return labels

    def evaluate_once(self, now: Optional[float] = None) -> List[TrendEvent]:
        """One pass over every detector; returns the events MINTED by this
        pass (new breaches and new recoveries only)."""
        now = self._clock() if now is None else now
        minted: List[TrendEvent] = []
        with self._lock:
            for det in self.detectors:
                try:
                    breaches = det.evaluate(self.store, now)
                except Exception:
                    breaches = []  # a broken detector must not spread
                was = det.name in self._active
                if breaches and not was:
                    ev = breaches[0]
                    self._active[det.name] = ev
                    self.history.append(ev)
                    minted.append(ev)
                    keys = set()
                    for lbl in self._gauge_labels(ev):
                        telemetry.gauge("timeseries.trends_active",
                                        **lbl).set(1.0)
                        keys.add(tuple(sorted(lbl.items())))
                    self._gauge_keys[det.name] = keys
                elif not breaches and was:
                    prev = self._active.pop(det.name)
                    res = dataclasses.replace(
                        prev, time=now, resolved=True,
                        message=f"{prev.metric} trend recovered")
                    self.history.append(res)
                    minted.append(res)
                    for key in self._gauge_keys.pop(det.name, ()):
                        telemetry.gauge("timeseries.trends_active",
                                        **dict(key)).set(0.0)
                elif not was:
                    # never breached: publish the 0 so SloSpecs over the
                    # gauge see the metric as present (require_present)
                    telemetry.gauge("timeseries.trends_active",
                                    trend=det.name).set(0.0)
        for ev in minted:
            telemetry.record_event(
                "trend", trend=ev.trend, detector=ev.detector,
                metric=ev.metric, observed=ev.observed,
                threshold=ev.threshold, window_s=ev.window_s,
                resolved=ev.resolved, message=ev.message,
                **({"labels": ev.labels} if ev.labels else {}))
            if not ev.resolved:
                telemetry.counter("timeseries.trend_breaches",
                                  trend=ev.trend).inc()
        return minted

    def active_trends(self) -> List[dict]:
        with self._lock:
            return [ev.to_row() for ev in self._active.values()]


def trend_specs(detectors: Sequence[Any]) -> List[Any]:
    """One :class:`~distkeras_tpu_torch.health.slo.SloSpec` per detector, over
    the monitor's ``timeseries.trends_active`` gauge — so trend breaches
    enter the SLO plane's burn-rate/alert/on_breach machinery without a
    second judging path. ``require_present`` keeps the specs silent until
    the monitor has evaluated at least once."""
    from distkeras_tpu_torch.health.slo import SloSpec

    return [SloSpec(f"trend-{det.name}", "timeseries.trends_active", 0.0,
                    op="<=", labels={"trend": det.name},
                    severity="ticket")
            for det in detectors]


# -- module-level store/monitor (read by slo, endpoints, recorder) -----------

_store: Optional[MetricStore] = None
_monitor: Optional[TrendMonitor] = None


def install_store(store: Optional[MetricStore]) -> Optional[MetricStore]:
    """Install (None: clear) the process MetricStore. The SLO engine's
    burn-rate path, the ``series`` wire op and postmortem bundles all
    read the installed store."""
    global _store
    _store = store
    return store


def get_store() -> Optional[MetricStore]:
    return _store


def install_monitor(monitor: Optional[TrendMonitor]
                    ) -> Optional[TrendMonitor]:
    """Install (None: clear) the process TrendMonitor; the health
    ``status`` op reports its active trends."""
    global _monitor
    _monitor = monitor
    return monitor


def get_monitor() -> Optional[TrendMonitor]:
    return _monitor


def active_trends() -> List[dict]:
    """The installed monitor's active trends ([] without a monitor)."""
    mon = _monitor
    return mon.active_trends() if mon is not None else []


__all__ = [
    "MetricStore", "TrendEvent", "TrendMonitor",
    "LeakDetector", "StallDetector", "DriftDetector",
    "default_detectors", "trend_specs", "sparkline",
    "install_store", "get_store", "install_monitor", "get_monitor",
    "active_trends", "TIERS", "TIER_POINTS", "HISTOGRAM_FIELDS",
]
