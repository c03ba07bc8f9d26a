"""SLO engine: declarative objectives evaluated live against telemetry
(port of ``distkeras_tpu/health/slo.py``).

The metrics plane measures; nothing judges. An :class:`SloSpec` declares
one objective over one metric — a gauge floor (``observability.mfu >=
0.50``), a histogram-tail ceiling (``host_async.commit_clock_lag p95 <=
8``), a counter burn rate (``host_async.degraded_windows`` per second) —
and the :class:`SloEngine` evaluates every spec continuously from the live
registry (a daemon thread, or ``evaluate_once`` from tests/handlers).

A breach is judged on a burn-rate budget, not a single sample: each spec
keeps a sliding window of verdicts and alerts only when the breached
fraction exceeds ``budget_frac`` (``window_s=0`` degenerates to
instantaneous). Crossing into breach mints a typed :class:`AlertEvent`
which:

- lands on the flight-recorder ring (``telemetry.record_event("alert",
  ...)``) so postmortem bundles carry the judgement with the evidence;
- bumps ``health.alerts.breaches{slo=...}`` and flips the
  ``health.alerts.active{slo=...}`` gauge (Prometheus export and the
  ``watch --table`` ALERTS column read these);
- invokes ``on_breach(alert)`` — the seam the rollout controller's
  canary/rollback attaches to. :func:`watchdog_on_breach` adapts the
  callback onto a
  :class:`~distkeras_tpu_torch.health.watchdog.TrainingWatchdog`, so a
  breach can ride the existing ``warn | raise | checkpoint_and_raise`` ladder.

Recovery (burn fraction back under budget) clears the active gauge and
records a resolution event; re-breaching re-alerts. No framework import, no
locks on the evaluation path beyond the engine's own bookkeeping lock
(evaluation runs OFF the step path, on its own thread).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from distkeras_tpu_torch import telemetry

OPS = {
    ">=": lambda v, t: v >= t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    "<": lambda v, t: v < t,
}

#: histogram fields a spec may select (stats() vocabulary); counters use
#: "rate" (per-second delta between evaluations), gauges/counters "value"
FIELDS = ("value", "p50", "p95", "min", "max", "rate")


@dataclasses.dataclass
class SloSpec:
    """One declared objective.

    ``metric`` names the instrument; ``field`` selects the observed value
    (gauge/counter ``value``, counter ``rate``, histogram percentiles).
    ``labels`` filters instrument label sets (subset match; None = the
    sum/first across all label sets — per-worker gauges judge fleet-wide).
    The objective holds when ``observed <op> threshold``; breach is judged
    on the fraction of failing verdicts within ``window_s`` exceeding
    ``budget_frac``.
    """

    name: str
    metric: str
    threshold: float
    op: str = ">="
    field: str = "value"
    labels: Optional[Dict[str, str]] = None
    window_s: float = 0.0
    budget_frac: float = 0.0
    severity: str = "page"
    #: specs over data that only exists mid-run (e.g. MFU) skip evaluation
    #: until the metric first appears instead of alerting on absence
    require_present: bool = True

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"op must be one of {sorted(OPS)}, "
                             f"got {self.op!r}")
        if self.field not in FIELDS:
            raise ValueError(f"field must be one of {FIELDS}, "
                             f"got {self.field!r}")
        if not (0.0 <= self.budget_frac < 1.0):
            raise ValueError(f"budget_frac must be in [0, 1), "
                             f"got {self.budget_frac}")


@dataclasses.dataclass
class AlertEvent:
    """A minted breach (or recovery): the typed record that rides the
    recorder ring, the status digest, and the ``on_breach`` callback."""

    slo: str
    metric: str
    observed: float
    threshold: float
    op: str
    severity: str
    time: float
    resolved: bool = False
    message: str = ""

    def to_row(self) -> dict:
        return dataclasses.asdict(self)


def _match_labels(row_labels: Optional[dict],
                  want: Optional[Dict[str, str]]) -> bool:
    if not want:
        return True
    have = row_labels or {}
    return all(str(have.get(k)) == str(v) for k, v in want.items())


class SloEngine:
    """Evaluates :class:`SloSpec`s against the live registry.

    ``evaluate_once`` is the whole algorithm; ``start``/``stop`` wrap it
    in a daemon thread. Engines are cheap — one per process, installed
    module-level via :func:`install_engine` so the health ``status``
    endpoint and the CLI can read active alerts without plumbing.
    """

    def __init__(self, specs: List[SloSpec],
                 on_breach: Optional[Callable[[AlertEvent], None]] = None,
                 clock: Callable[[], float] = time.time):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {sorted(names)}")
        self.specs = list(specs)
        self.on_breach = on_breach
        self._clock = clock
        self._lock = threading.Lock()
        # per-spec verdict window [(t, breached)], last counter sample for
        # rate fields [(t, value)], and current breach state
        self._verdicts: Dict[str, Deque[Tuple[float, bool]]] = {
            s.name: collections.deque() for s in specs}
        self._last_counter: Dict[str, Tuple[float, float]] = {}
        self._active: Dict[str, AlertEvent] = {}
        self.history: List[AlertEvent] = []
        self._stop_evt: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # -- observation -------------------------------------------------------
    def _observe_store(self, spec: SloSpec, now: float) -> Optional[float]:
        """Windowed observation from the installed
        :class:`~distkeras_tpu_torch.health.timeseries.MetricStore` (DESIGN.md
        §24), or None to fall back to the single-snapshot path: no store
        installed, the store has not seen the metric, the field is not
        retained (histogram ``min``), or a rate window holds fewer than
        two points. Histogram tails judge the WORST point over the spec's
        window across matching label sets — real history instead of one
        conservative snapshot; on a static series both paths agree
        (parity-tested)."""
        # lazy: no import cycle
        from distkeras_tpu_torch.health import timeseries

        store = timeseries.get_store()
        if store is None:
            return None
        window = spec.window_s if spec.window_s > 0 else None
        if spec.field in ("p50", "p95", "max"):
            vals = []
            for s in store.query(spec.metric, spec.labels, spec.field):
                pts = (s.points(window, now=now) if window
                       else list(s.rings["raw"])[-1:])
                vals.extend(v for _, v in pts)
            if not vals:
                return None
            return max(vals) if spec.op in ("<=", "<") else min(vals)
        if spec.field == "min":
            return None  # the store does not retain histogram min
        matched = store.query(spec.metric, spec.labels, "value")
        if not matched:
            return None
        if spec.field == "rate" and matched[0].kind == "counter":
            return store.rate(spec.metric, spec.labels,
                              window_s=spec.window_s or 60.0, now=now)
        if matched[0].kind == "histogram":
            return None  # "value" on a histogram: snapshot path picks p95
        return store.latest(spec.metric, spec.labels, "value")

    def _observe(self, spec: SloSpec, now: float) -> Optional[float]:
        """The spec's observed value — windowed store history when a
        MetricStore is installed, else the live registry — or None when
        the metric has produced nothing yet."""
        got = self._observe_store(spec, now)
        if got is not None:
            return got
        reg = telemetry.get_registry()
        if reg is None:
            return None
        rows = [m.row() for m in list(reg._metrics.values())
                if m.name == spec.metric
                and _match_labels(m.labels, spec.labels)]
        if not rows:
            return None
        kind = rows[0].get("kind")
        if kind == "histogram":
            field = spec.field if spec.field in ("p50", "p95", "min",
                                                 "max") else "p95"
            vals = [r[field] for r in rows if r.get(field) is not None]
            if not vals:
                return None
            # the conservative tail across label sets (e.g. workers):
            # judge the worst worker, not the average
            return max(vals) if spec.op in ("<=", "<") else min(vals)
        total = sum(float(r.get("value", 0.0)) for r in rows)
        if kind == "counter" and spec.field == "rate":
            prev = self._last_counter.get(spec.name)
            self._last_counter[spec.name] = (now, total)
            if prev is None or now <= prev[0]:
                return None  # first sample: no interval to rate over
            return (total - prev[1]) / (now - prev[0])
        return total

    # -- evaluation --------------------------------------------------------
    def evaluate_once(self, now: Optional[float] = None) -> List[AlertEvent]:
        """One full pass; returns the alerts MINTED by this pass (newly
        breached or newly resolved specs only)."""
        now = self._clock() if now is None else now
        minted: List[AlertEvent] = []
        with self._lock:
            for spec in self.specs:
                observed = self._observe(spec, now)
                if observed is None:
                    if spec.require_present:
                        continue  # nothing measured yet: skip, don't judge
                    observed = 0.0
                ok = OPS[spec.op](observed, spec.threshold)
                win = self._verdicts[spec.name]
                win.append((now, not ok))
                horizon = now - spec.window_s
                while win and win[0][0] < horizon:
                    win.popleft()
                burn = sum(1 for _, b in win if b) / len(win)
                breached = burn > spec.budget_frac if spec.budget_frac \
                    else not ok
                was = spec.name in self._active
                if breached and not was:
                    alert = AlertEvent(
                        slo=spec.name, metric=spec.metric,
                        observed=float(observed),
                        threshold=spec.threshold, op=spec.op,
                        severity=spec.severity, time=now,
                        message=(f"{spec.metric} {spec.field}="
                                 f"{observed:.6g} violates "
                                 f"{spec.op} {spec.threshold:.6g} "
                                 f"(burn {burn:.0%} > budget "
                                 f"{spec.budget_frac:.0%})"))
                    self._active[spec.name] = alert
                    self.history.append(alert)
                    minted.append(alert)
                elif not breached and was:
                    prev = self._active.pop(spec.name)
                    res = dataclasses.replace(
                        prev, observed=float(observed), time=now,
                        resolved=True,
                        message=f"{spec.metric} recovered: "
                                f"{spec.field}={observed:.6g}")
                    self.history.append(res)
                    minted.append(res)
                telemetry.gauge("health.alerts.active", slo=spec.name).set(
                    1.0 if spec.name in self._active else 0.0)
        telemetry.counter("health.alerts.evals").inc()
        for alert in minted:
            telemetry.record_event(
                "alert", slo=alert.slo, metric=alert.metric,
                observed=alert.observed, threshold=alert.threshold,
                severity=alert.severity, resolved=alert.resolved,
                message=alert.message)
            if not alert.resolved:
                telemetry.counter("health.alerts.breaches",
                                  slo=alert.slo).inc()
                if self.on_breach is not None:
                    # may raise (watchdog raise policies do): synchronous
                    # callers get the typed error; the daemon loop catches
                    # it — a tripping watchdog has already delivered the
                    # abort through its own on_trip hook by then
                    self.on_breach(alert)
        return minted

    def active_alerts(self) -> List[dict]:
        with self._lock:
            return [a.to_row() for a in self._active.values()]

    # -- daemon evaluator --------------------------------------------------
    def start(self, interval: float = 1.0) -> None:
        """Evaluate every ``interval`` seconds on a daemon thread."""
        if self._thread is not None:
            return
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self._stop_evt = threading.Event()

        def loop():
            while not self._stop_evt.wait(interval):
                try:
                    self.evaluate_once()
                except Exception:
                    pass  # the judge must never take down the judged

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="distkeras-slo")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join()
        self._thread = None
        self._stop_evt = None


def default_specs(mfu_floor: float = 0.50,
                  staleness_p95: float = 16.0,
                  ttft_p95_s: float = 2.0,
                  degraded_rate: float = 0.5,
                  queue_depth: float = 512.0,
                  canary_floor: float = 0.98,
                  collector_drop_rate: float = 1.0) -> List[SloSpec]:
    """The stock objectives for a training+serving process; callers prune
    or reparameterize for their workload. The long-horizon specs at the
    end judge the trend monitor's ``timeseries.trends_active`` gauges
    (DESIGN.md §24) — they stay silent until a
    :class:`~distkeras_tpu_torch.health.timeseries.TrendMonitor` is evaluating
    (``require_present``)."""
    return [
        SloSpec("mfu-floor", "observability.mfu", mfu_floor, op=">=",
                window_s=60.0, budget_frac=0.5, severity="ticket"),
        SloSpec("staleness-tail", "host_async.commit_clock_lag",
                staleness_p95, op="<=", field="p95",
                window_s=30.0, budget_frac=0.25),
        SloSpec("serving-ttft", "serving.decode.ttft_s", ttft_p95_s,
                op="<=", field="p95", window_s=30.0, budget_frac=0.1),
        SloSpec("degraded-windows", "host_async.degraded_windows",
                degraded_rate, op="<=", field="rate"),
        SloSpec("serving-queue", "serving.queue_depth", queue_depth,
                op="<="),
        # quality rail of the live-rollout plane (serving/rollout.py,
        # DESIGN.md §18): a promoted version drifting from last-good on
        # mirrored traffic pages — and with rollout_on_breach wired, the
        # breach rolls the fleet back instead of raising
        SloSpec("canary-agreement", "rollout.canary.agreement",
                canary_floor, op=">=", severity="page"),
        # long-horizon failure modes: an hours-scale run dies
        # of leaks and stalls, not of one bad sample. hbm-growth trips on
        # the LeakDetector over observability.hbm_allocated_bytes;
        # data-watermark-stall on the StallDetector over
        # data.service.cursor; collector-drops rates the collector's own
        # drop counter over a minute (loss of telemetry is itself a
        # failure of the forensic record).
        SloSpec("hbm-growth", "timeseries.trends_active", 0.0, op="<=",
                labels={"trend": "hbm-leak"}, severity="page"),
        SloSpec("data-watermark-stall", "timeseries.trends_active", 0.0,
                op="<=", labels={"trend": "data-watermark-stall"},
                severity="page"),
        SloSpec("collector-drops", "collector.dropped_batches",
                collector_drop_rate, op="<=", field="rate",
                window_s=60.0, budget_frac=0.25, severity="ticket"),
    ]


def watchdog_on_breach(watchdog) -> Callable[[AlertEvent], None]:
    """Adapt a :class:`TrainingWatchdog` into an ``on_breach`` callback:
    breaches enter the watchdog's policy ladder as :class:`SloBreach`
    trips (``warn`` logs, ``raise``/``checkpoint_and_raise`` abort with
    forensics). Resolved alerts never reach the watchdog."""

    def on_breach(alert: AlertEvent) -> None:
        watchdog.observe_slo_breach(alert)

    return on_breach


def rollout_on_breach(controller,
                      chain: Optional[Callable[[AlertEvent], None]] = None
                      ) -> Callable[[AlertEvent], None]:
    """Adapt a :class:`~distkeras_tpu_torch.serving.rollout.RolloutController`
    into an ``on_breach`` callback: a breach swaps the fleet back to the
    last-good version instead of raising, preserving the breach context
    in a flight-recorder postmortem (DESIGN.md §18). ``chain`` (if given)
    still sees every alert AFTER the rollback — page the human about the
    rollback, don't page instead of rolling back."""

    def on_breach(alert: AlertEvent) -> None:
        controller.on_breach(alert)
        if chain is not None:
            chain(alert)

    return on_breach


# -- module-level engine (read by health status / CLI) -----------------------

_engine: Optional[SloEngine] = None


def install_engine(engine: Optional[SloEngine]) -> Optional[SloEngine]:
    """Install (None: clear) the process SLO engine; the health ``status``
    op reports its active alerts."""
    global _engine
    _engine = engine
    return engine


def get_engine() -> Optional[SloEngine]:
    return _engine


def active_alerts() -> List[dict]:
    """The installed engine's active alerts ([] without an engine)."""
    eng = _engine
    return eng.active_alerts() if eng is not None else []


__all__ = [
    "SloSpec", "AlertEvent", "SloEngine", "OPS", "FIELDS",
    "default_specs", "watchdog_on_breach", "rollout_on_breach",
    "install_engine", "get_engine", "active_alerts",
]
