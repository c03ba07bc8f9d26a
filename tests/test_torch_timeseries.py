"""The port's time-series plane against the JAX package's.

The same scripted series, on the same explicit clock (every
``collect(now=...)`` and ``evaluate(now=...)`` is backdated from one
fixed instant), go into the JAX package's ``MetricStore`` and
detectors and into the port's; the results must be equal:

- the store's tiers, budget and dropped series, ``latest``/``rate``
  and its windowed rows;
- the leak, stall and drift detectors on series that should and should
  not fire;
- ``TrendMonitor`` breach and recovery, its gauges, its events on the
  flight recorder's ring, and ``trend_specs`` on the SLO engine;
- the ``series`` op over the wire, from either package's server to the
  port's ``HealthClient``;
- a postmortem bundle's series, trends and trend events.
"""

import json
import types

import pytest

from distkeras_tpu import serving as jserving
from distkeras_tpu import telemetry as jtelemetry
from distkeras_tpu.health import endpoints as jendpoints
from distkeras_tpu.health import recorder as jrecorder
from distkeras_tpu.health import slo as jslo
from distkeras_tpu.health import timeseries as jtimeseries
from distkeras_tpu_torch import serving as tserving
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.health import endpoints, recorder, slo, timeseries

PLANES = {
    "jax": types.SimpleNamespace(telemetry=jtelemetry, ts=jtimeseries,
                                 slo=jslo, recorder=jrecorder,
                                 endpoints=jendpoints, serving=jserving),
    "port": types.SimpleNamespace(telemetry=telemetry, ts=timeseries,
                                  slo=slo, recorder=recorder,
                                  endpoints=endpoints, serving=tserving),
}
#: the fixed instant every series is backdated from
T0 = 1_700_000_000.0
#: above the default 1 MiB/s HBM ceiling (1 MiB/s itself must not fire)
LEAK_SLOPE = 4 << 20


@pytest.fixture(autouse=True)
def fresh_planes():
    for p in PLANES.values():
        p.telemetry.reset()
        p.recorder.install(p.recorder.FlightRecorder())
        p.ts.install_store(None)
        p.ts.install_monitor(None)
        p.slo.install_engine(None)
    yield
    for p in PLANES.values():
        p.ts.install_store(None)
        p.ts.install_monitor(None)
        p.slo.install_engine(None)
        p.recorder.install(p.recorder.FlightRecorder())
        p.telemetry.reset()


def _fill(p, store, name, values, t0, dt=5.0, **labels):
    """One gauge sample per collect pass, ``dt`` apart from ``t0``."""
    g = p.telemetry.gauge(name, **labels)
    for i, v in enumerate(values):
        g.set(v)
        store.collect(now=t0 + i * dt)


def _both(script):
    got = {name: script(p) for name, p in PLANES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _events(evs):
    return [e.to_row() for e in evs]


# -- MetricStore --------------------------------------------------------------

def test_store_collects_counters_gauges_histograms():
    def script(p):
        store = p.ts.MetricStore()
        p.telemetry.counter("soak.requests").inc(3)
        p.telemetry.gauge("serving.queue_depth").set(7.0)
        h = p.telemetry.histogram("health.window.duration_s")
        for v in (0.1, 0.2, 0.3):
            h.record(v)
        appended = [store.collect(now=T0)]
        p.telemetry.counter("soak.requests").inc(2)
        appended.append(store.collect(now=T0 + 2.0))
        fields = sorted(s.field for key, s in store._series.items()
                        if key[0] == "health.window.duration_s")
        return (appended, store.latest("serving.queue_depth"),
                store.latest("soak.requests"),
                store.rate("soak.requests", window_s=60.0, now=T0 + 2.0),
                fields, store.latest("no.such.metric"),
                store.rate("no.such.metric", now=T0))

    appended, depth, total, rate, fields, none1, none2 = _both(script)
    assert depth == 7.0 and total == 5.0 and rate == pytest.approx(1.0)
    assert fields == ["count", "max", "p50", "p95"]
    assert none1 is None and none2 is None


def test_store_tiers_and_windowed_reads():
    def script(p):
        store = p.ts.MetricStore()
        _fill(p, store, "observability.mfu", [0.5 + 1e-4 * i
                                              for i in range(1440)],
              T0 - 7200.0)
        (s,) = store.query("observability.mfu")
        now = T0 - 7200.0 + 1439 * 5.0
        spacing = [pts[1][0] - pts[0][0] for pts in (
            s.points(w, now=now) for w in (600.0, 3000.0, 5000.0))]
        return ({t: list(r) for t, r in s.rings.items()}, spacing,
                [store.rows(name="observability.mfu", tier=t,
                            max_points=5) for t in ("raw", "10s", "60s")])

    rings, spacing, rows = _both(script)
    assert [len(rings[t]) for t in ("raw", "10s")] == [512, 360]
    assert 115 <= len(rings["60s"]) <= 121
    assert spacing == [5.0, 10.0, 60.0]
    assert [len(r[0]["points"]) for r in rows] == [5, 5, 5]


def test_store_budget_caps_series_and_counts_drops():
    def script(p):
        store = p.ts.MetricStore(budget_bytes=1)
        for i in range(20):
            p.telemetry.gauge("serving.queue_depth", replica=str(i)).set(1.0)
        dropped = []
        for k in range(3):
            store.collect(now=T0 + k)
            dropped.append(p.telemetry.get_registry().snapshot()[
                "counters"]["timeseries.dropped_series"])
        return store.max_series, len(store._series), dropped

    max_series, n, dropped = _both(script)
    assert max_series == n == 16 and dropped == [4.0, 12.0, 12.0]


def test_store_rows_json_and_sparkline():
    def script(p):
        store = p.ts.MetricStore()
        _fill(p, store, "serving.queue_depth", [1.0, 2.0, 3.0], T0 - 10.0)
        rows = store.rows(name="serving.queue_depth", max_points=2)
        return (json.dumps(rows), p.ts.sparkline([0.0, 1.0, 2.0, 3.0], 4),
                p.ts.sparkline([5.0] * 3), p.ts.sparkline([]))

    rows, line, flat, empty = _both(script)
    (row,) = json.loads(rows)
    assert [v for _, v in row["points"]] == [2.0, 3.0]
    assert line[0] == "▁" and line[-1] == "█" and empty == ""


# -- detectors ----------------------------------------------------------------

LEAK = [i * LEAK_SLOPE * 5.0 for i in range(24)]
SAW = [(i * LEAK_SLOPE * 5.0) * (1.0 if i % 2 else 0.25) for i in range(24)]


@pytest.mark.parametrize("series, fires", [
    (LEAK, True), (SAW, False), ([1e9] * 24, False)],
    ids=["leak", "sawtooth", "flat"])
def test_leak_detector(series, fires):
    def script(p):
        store = p.ts.MetricStore()
        _fill(p, store, "observability.hbm_allocated_bytes", series,
              T0 - 120.0)
        det = p.ts.LeakDetector("hbm-leak",
                                "observability.hbm_allocated_bytes",
                                window_s=120.0, slope_per_s=1 << 20)
        return _events(det.evaluate(store, now=T0 - 120.0 + 23 * 5.0))

    evs = _both(script)
    assert len(evs) == int(fires)
    if fires:
        assert evs[0]["observed"] == pytest.approx(LEAK_SLOPE, rel=0.05)


@pytest.mark.parametrize("series, dt, fires", [
    ([17.0] * 12, 5.0, True), (list(range(12)), 5.0, False),
    ([17.0] * 4, 1.0, False)], ids=["flat", "advancing", "too-short"])
def test_stall_detector(series, dt, fires):
    def script(p):
        store = p.ts.MetricStore()
        _fill(p, store, "data.service.cursor", series, T0 - 60.0, dt=dt)
        det = p.ts.StallDetector("data-watermark-stall",
                                 "data.service.cursor", window_s=30.0)
        return _events(det.evaluate(
            store, now=T0 - 60.0 + (len(series) - 1) * dt))

    evs = _both(script)
    assert len(evs) == int(fires)


@pytest.mark.parametrize("tail, fires", [(0.40, True), (0.52, False)])
def test_drift_detector(tail, fires):
    def script(p):
        store = p.ts.MetricStore()
        _fill(p, store, "observability.mfu", [0.55] * 60 + [tail] * 12,
              T0 - 360.0)
        det = p.ts.DriftDetector("mfu-drift", "observability.mfu",
                                 tolerance_frac=0.10)
        return _events(det.evaluate(store, now=T0 - 360.0 + 71 * 5.0))

    evs = _both(script)
    assert len(evs) == int(fires)


# -- TrendMonitor -------------------------------------------------------------

def _trend_gauges(p):
    snap = p.telemetry.get_registry().snapshot()
    return {k: v for kind in ("gauges", "counters")
            for k, v in snap[kind].items() if k.startswith("timeseries.trend")}


def test_trend_monitor_breach_recovery_and_gauges():
    def script(p):
        store = p.ts.MetricStore()
        t0 = T0 - 120.0
        _fill(p, store, "observability.hbm_allocated_bytes", LEAK, t0)
        mon = p.ts.TrendMonitor(store, p.ts.default_detectors())
        out = [_events(mon.evaluate_once(now=t0 + 23 * 5.0)),
               mon.active_trends(), _trend_gauges(p),
               _events(mon.evaluate_once(now=t0 + 23 * 5.0))]
        g = p.telemetry.gauge("observability.hbm_allocated_bytes")
        for i in range(24, 72):
            g.set(LEAK[-1])
            store.collect(now=t0 + i * 5.0)
        out += [_events(mon.evaluate_once(now=t0 + 71 * 5.0)),
                mon.active_trends(), _trend_gauges(p),
                [e["fields"] for e in p.recorder.get_recorder().events()
                 if e["kind"] == "trend"]]
        return out

    breach, active, gauges, again, recovery, after, gauges2, ring = \
        _both(script)
    assert [e["trend"] for e in breach] == ["hbm-leak"] and again == []
    assert [t["trend"] for t in active] == ["hbm-leak"]
    assert gauges["timeseries.trends_active{trend=hbm-leak}"] == 1.0
    assert gauges["timeseries.trends_active{trend=queue-growth}"] == 0.0
    assert [e["resolved"] for e in recovery] == [True] and after == []
    assert gauges2["timeseries.trends_active{trend=hbm-leak}"] == 0.0
    assert [f["resolved"] for f in ring] == [False, True]


def test_trend_specs_ride_the_slo_engine():
    def script(p):
        store = p.ts.install_store(p.ts.MetricStore())
        t0 = T0 - 120.0
        _fill(p, store, "observability.hbm_allocated_bytes", LEAK, t0)
        detectors = p.ts.default_detectors()
        mon = p.ts.TrendMonitor(store, detectors)
        specs = p.ts.trend_specs(detectors)
        engine = p.slo.SloEngine(specs)
        mon.evaluate_once(now=t0 + 23 * 5.0)
        store.collect(now=t0 + 23 * 5.0)
        return ([dict(vars(s)) for s in specs],
                [a.to_row() for a in engine.evaluate_once(
                    now=t0 + 23 * 5.0)])

    specs, minted = _both(script)
    assert [a["slo"] for a in minted] == ["trend-hbm-leak"]
    assert minted[0]["severity"] == "ticket"
    assert len(specs) == len(timeseries.default_detectors()) == 7


# -- the wire and the postmortem ----------------------------------------------

def test_series_op_over_the_wire_equal():
    """Either package's server answers the ``series`` op with its
    installed store's rows; the port's HealthClient reads both."""
    engine = types.SimpleNamespace(health_status=lambda: {})
    got = {}
    for name, p in PLANES.items():
        assert p.endpoints.handle_health_op("series", {}) == {"series": []}
        store = p.ts.install_store(p.ts.MetricStore())
        _fill(p, store, "serving.decode.tokens_per_s", [10.0, 20.0],
              T0 - 5.0, dt=1.0)
        _fill(p, store, "serving.decode.queue_depth", [1.0, 2.0, 4.0],
              T0 - 3.0, dt=1.0)
        srv = p.serving.ServingServer(engine, host="127.0.0.1")
        srv.start()
        try:
            with endpoints.HealthClient(f"127.0.0.1:{srv.port}") as cli:
                got[name] = (cli.series(name="serving.decode.queue_depth",
                                        max_points=2),
                             [r["name"] for r in cli.series()])
        finally:
            srv.stop()
    assert got["port"] == got["jax"]
    (row,), names = got["port"]
    assert [v for _, v in row["points"]] == [2.0, 4.0]
    assert "serving.decode.tokens_per_s" in names


def test_postmortem_bundle_series_and_trends(tmp_path):
    def script(p):
        store = p.ts.install_store(p.ts.MetricStore())
        mon = p.ts.install_monitor(p.ts.TrendMonitor(
            store, p.ts.default_detectors()))
        t0 = T0 - 120.0
        _fill(p, store, "observability.hbm_allocated_bytes", LEAK, t0)
        mon.evaluate_once(now=t0 + 23 * 5.0)
        path = p.recorder.get_recorder().dump(
            str(tmp_path / p.telemetry.__name__), reason="leak")
        with open(path) as f:
            bundle = json.load(f)
        # the store times its own collect passes: those rows differ
        series = [r for r in bundle["timeseries"]
                  if r["name"] != "timeseries.collect_s"]
        return (series, bundle["trends"],
                [e["fields"] for e in bundle["events"]
                 if e["kind"] == "trend"])

    series, trends, events = _both(script)
    assert [t["trend"] for t in trends] == ["hbm-leak"]
    assert events[0]["threshold"] == float(1 << 20)
    (row,) = [r for r in series
              if r["name"] == "observability.hbm_allocated_bytes"]
    assert len(row["points"]) == 24
