"""The port's health plane against the JAX package's, module for module.

Each scenario is one function of a *plane*: the JAX package's health
modules and telemetry, or the port's. It feeds scripted inputs on a
scripted clock and returns what came out (verdicts, raised errors,
minted events, the plane's own telemetry, rendered text); every test
runs it on both planes and asserts the two results equal, then checks
the result itself. Nothing here touches a device, a socket other than
``127.0.0.1:0``, or the wall clock.

- ``StragglerDetector`` and ``HeartbeatPublisher``: verdicts and gauges;
- ``Membership``: leases, eviction, re-admission, straggler graduation,
  ``export``/``restore``, ``status``;
- ``SloEngine``: burn rate, breach, resolve, re-breach, the callback,
  and the store path against the registry path;
- ``TrainingWatchdog``: NaN, divergence, stall and SLO-breach trips under
  each policy;
- ``resolve(health=...)`` on every argument form;
- Prometheus text byte-equal, ``chrome_trace`` equal;
- the CLI's fleet rows, watch table and watch line from the same rows,
  the collector's merged rows and ``worker_table``, and the port's CLI
  against the JAX package's and the port's own health endpoints.
"""

import json
import math
import time
import types
import warnings

import pytest

import distkeras_tpu.health as jhealth
from distkeras_tpu import telemetry as jtelemetry
from distkeras_tpu.health import cli as jcli
from distkeras_tpu.health import collector as jcollector
from distkeras_tpu.health import export as jexport
from distkeras_tpu.health import membership as jmembership
from distkeras_tpu.health import slo as jslo
from distkeras_tpu.health import timeseries as jtimeseries
from distkeras_tpu.health import watchdog as jwatchdog
import distkeras_tpu_torch.health as thealth
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.health import cli, collector, export, membership
from distkeras_tpu_torch.health import slo, timeseries, watchdog

PLANES = {
    "jax": types.SimpleNamespace(
        telemetry=jtelemetry, health=jhealth, membership=jmembership,
        slo=jslo, timeseries=jtimeseries, watchdog=jwatchdog,
        export=jexport, cli=jcli, collector=jcollector),
    "port": types.SimpleNamespace(
        telemetry=telemetry, health=thealth, membership=membership,
        slo=slo, timeseries=timeseries, watchdog=watchdog,
        export=export, cli=cli, collector=collector),
}


@pytest.fixture(autouse=True)
def fresh_planes():
    for p in PLANES.values():
        p.telemetry.reset()
        p.timeseries.install_store(None)
        p.timeseries.install_monitor(None)
        p.slo.install_engine(None)
    yield
    for p in PLANES.values():
        p.timeseries.install_store(None)
        p.timeseries.install_monitor(None)
        p.slo.install_engine(None)
        p.telemetry.reset()


def _snap(p, prefixes=("health.", "elastic.")):
    """The plane's own counters and gauges under ``prefixes``."""
    snap = p.telemetry.get_registry().snapshot()
    return {kind: {k: v for k, v in snap[kind].items()
                   if k.startswith(prefixes)}
            for kind in ("counters", "gauges")}


def _nan_free(x):
    """``x`` with every float NaN spelled ``"nan"`` (NaN != NaN)."""
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, dict):
        return {k: _nan_free(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_nan_free(v) for v in x)
    return x


def _both(script):
    """Run ``script`` on each plane; assert the results equal; return
    the port's."""
    got = {name: _nan_free(script(p)) for name, p in PLANES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# -- heartbeats and stragglers ------------------------------------------------

@pytest.mark.parametrize("durations, workers, want", [
    ([1.0] * 5 + [10.0, 1.0, 1.0], [0] * 8,
     [False] * 5 + [True] + [False] * 2),
    ([0.1] * 6 + [1.0], [0, 1] * 3 + [1], [False] * 6 + [True]),
], ids=["one-worker", "among-peers"])
def test_straggler_detector_verdicts(durations, workers, want):
    def script(p):
        det = p.health.StragglerDetector(k=3.0, min_samples=4)
        verdicts = [det.observe(w, d) for w, d in zip(workers, durations)]
        return verdicts, det.stragglers, _snap(p)

    verdicts, stragglers, snap = _both(script)
    assert verdicts == want
    assert stragglers == ([1] if workers[-1] == 1 else [])
    assert snap["counters"][f"health.straggler.events{{worker="
                            f"{workers[5]}}}"] == 1


def test_heartbeat_publisher_gauges():
    def script(p):
        hb = p.health.HeartbeatPublisher(time_fn=lambda: 1000.0)
        hb.publish(worker=0, clock=5, staleness=2.0, window_s=0.25)
        hb.publish(worker=0, clock=7, staleness=1.0, window_s=0.30)
        return _snap(p)

    snap = _both(script)
    assert snap["gauges"]["health.worker.clock{worker=0}"] == 7
    assert snap["counters"]["health.worker.windows{worker=0}"] == 2


def test_straggler_detector_validates_args():
    for p in PLANES.values():
        with pytest.raises(ValueError, match="k must be > 1"):
            p.health.StragglerDetector(k=1.0)
        with pytest.raises(ValueError, match="min_samples"):
            p.health.StragglerDetector(min_samples=0)


# -- membership ---------------------------------------------------------------

def test_membership_leases_eviction_readmission():
    def script(p):
        clock = [0.0]
        m = p.membership.Membership(lease_s=10.0, time_fn=lambda: clock[0])
        out = [m.register(1), m.register(2, lease_s=100.0), m.renew(1),
               m.sweep()]
        clock[0] = 11.0
        out += [m.sweep(), m.is_evicted(1), m.is_evicted(2),
                m.should_late_fold(1), m.should_late_fold(2), m.renew(1),
                m.is_evicted(1)]
        m.observe_commit(1)
        out.append(m.is_evicted(1))
        m.deregister(2)
        out += [m.workers, m.should_late_fold(99), m.status()]
        return out, _snap(p)

    out, snap = _both(script)
    assert out[:4] == [10.0, 100.0, False, []]
    assert out[4:11] == [[1], True, False, True, False, True, True]
    assert out[11] is False and out[12] == [1] and out[13] is False
    assert out[14]["workers"]["1"]["commits"] == 1
    assert snap["counters"]["elastic.evictions{reason=lease}"] == 1
    assert snap["counters"]["elastic.readmissions"] == 1


def test_membership_straggler_graduates_to_eviction():
    def script(p):
        m = p.membership.Membership(
            lease_s=1e6, straggler=p.health.StragglerDetector(
                k=3.0, min_samples=4), time_fn=lambda: 0.0)
        m.register(7)
        for _ in range(5):
            m.observe_commit(7, window_s=1.0)
        m.observe_commit(7, window_s=10.0)
        flagged = (m.is_evicted(7), m.status()["workers"]["7"],
                   m.should_late_fold(7))
        m.observe_commit(7, window_s=1.0)
        return flagged, m.is_evicted(7), _snap(p)

    flagged, after, _ = _both(script)
    assert flagged[0] and flagged[1]["reason"] == "straggler" and flagged[2]
    assert after is False


def test_membership_export_restore_reanchors_leases():
    def script(p):
        clock = [100.0]
        m = p.membership.Membership(lease_s=10.0, time_fn=lambda: clock[0])
        for w in (1, 2, 3):
            m.register(w)
        m.observe_commit(2)
        clock[0] = 105.0
        m.register(3, lease_s=2.0)  # 3's lease ends at 107
        clock[0] = 108.0
        m.sweep()  # 3 evicted
        table = m.export()
        clock2 = [5000.0]
        standby = p.membership.Membership(lease_s=10.0,
                                          time_fn=lambda: clock2[0])
        standby.restore(table)
        first = standby.status()
        clock2[0] = 5003.0
        swept = standby.sweep()
        return table, first, swept, standby.status(), _snap(p)

    table, first, swept, later, _ = _both(script)
    assert set(table) == {"1", "2", "3"} and table["3"]["evicted"]
    assert first["evicted"] == [3] and swept == [1, 2]
    assert later["evicted"] == [1, 2, 3]


# -- SLO engine ---------------------------------------------------------------

def _alerts(alerts):
    return [a.to_row() for a in alerts]


def test_slo_burn_rate_breach_resolve_rebreach():
    """A depth gauge judged over a 10 s window with a 50% budget, on a
    scripted clock: one hot sample does not breach, sustained depth
    does, the callback sees the breach (never the resolution), recovery
    resolves and a new run of hot samples breaches again."""
    depths = [1, 9, 1, 9, 9, 9, 1, 1, 1, 1, 1, 1, 9, 9, 9, 9]

    def script(p):
        seen = []
        eng = p.slo.SloEngine([p.slo.SloSpec(
            "depth", "serving.decode.queue_depth", 4.0, op="<=",
            window_s=10.0, budget_frac=0.5, severity="shed")],
            on_breach=seen.append, clock=lambda: 0.0)
        g = p.telemetry.gauge("serving.decode.queue_depth")
        minted = []
        for i, d in enumerate(depths):
            g.set(float(d))
            minted.append(_alerts(eng.evaluate_once(now=1000.0 + 2 * i)))
        return (minted, _alerts(seen), eng.active_alerts(),
                _alerts(eng.history), _snap(p))

    minted, seen, active, history, snap = _both(script)
    kinds = [[a["resolved"] for a in m] for m in minted]
    # 6 verdicts in a 10 s window at 2 s apart: a breach needs more
    # than 3 hot ones in it
    assert kinds == [[], [], [], [], [False], [], [], [True], [], [],
                     [], [], [], [], [], [False]]
    assert [a["resolved"] for a in seen] == [False, False]
    assert len(active) == 1 and len(history) == 3
    assert snap["counters"]["health.alerts.breaches{slo=depth}"] == 2
    assert snap["gauges"]["health.alerts.active{slo=depth}"] == 1.0


def test_slo_counter_rate_and_histogram_tail_fields():
    def script(p):
        eng = p.slo.SloEngine([
            p.slo.SloSpec("rate", "serving.decode.rejected", 1.0, op="<=",
                          field="rate"),
            p.slo.SloSpec("ttft", "serving.decode.ttft_s", 0.5, op="<=",
                          field="p95"),
            p.slo.SloSpec("absent", "serving.decode.deadline_exceeded", 0.0,
                          op="<=", require_present=False)])
        c = p.telemetry.counter("serving.decode.rejected")
        h = p.telemetry.histogram("serving.decode.ttft_s")
        out = []
        for i, (n, ttft) in enumerate([(0, 0.1), (1, 0.2), (5, 0.9),
                                       (0, 0.1)]):
            c.inc(n)
            h.record(ttft)
            out.append(_alerts(eng.evaluate_once(now=10.0 + i)))
        return out, eng.active_alerts()

    out, active = _both(script)
    assert [a["slo"] for a in out[2]] == ["rate", "ttft"]
    assert [a["slo"] for a in active] == ["ttft"]


def test_slo_store_path_against_registry_path():
    """On a static series the windowed store observation equals the
    registry snapshot's; a cold store falls back to the registry."""
    def script(p):
        p.telemetry.gauge("observability.mfu").set(0.42)
        h = p.telemetry.histogram("host_async.commit_clock_lag")
        for v in (1.0, 2.0, 8.0):
            h.record(v)
        p.telemetry.counter("host_async.degraded_windows").inc(6)
        specs = [
            p.slo.SloSpec("mfu", "observability.mfu", 0.50),
            p.slo.SloSpec("lag", "host_async.commit_clock_lag", 8.0,
                          op="<=", field="p95"),
            p.slo.SloSpec("lag-min", "host_async.commit_clock_lag", 0.1,
                          op=">=", field="min"),
            p.slo.SloSpec("degraded", "host_async.degraded_windows", 1.0,
                          op="<=", field="rate", window_s=60.0)]
        now = 2000.0
        reg = p.slo.SloEngine(specs)
        reg.evaluate_once(now=now - 2.0)
        registry = {s.name: reg._observe(s, now) for s in specs}
        store = p.timeseries.install_store(p.timeseries.MetricStore())
        cold = {s.name: p.slo.SloEngine(specs)._observe(s, now)
                for s in specs[:1]}
        store.collect(now=now - 2.0)
        store.collect(now=now)
        stored = {s.name: p.slo.SloEngine(specs)._observe(s, now)
                  for s in specs}
        return registry, cold, stored

    registry, cold, stored = _both(script)
    assert stored == pytest.approx(registry)
    assert cold == {"mfu": 0.42} and stored["degraded"] == 0.0
    assert stored["lag-min"] == 1.0


def test_slo_spec_validation_and_default_specs():
    for p in PLANES.values():
        with pytest.raises(ValueError, match="op"):
            p.slo.SloSpec("x", "m", 1.0, op="!=")
        with pytest.raises(ValueError, match="budget_frac"):
            p.slo.SloSpec("x", "m", 1.0, budget_frac=1.0)
        with pytest.raises(ValueError, match="duplicate"):
            p.slo.SloEngine([p.slo.SloSpec("x", "m", 1.0)] * 2)
    _both(lambda p: [dict(vars(s)) for s in p.slo.default_specs()])


def test_installed_engine_alerts_reach_the_status_digest():
    def script(p):
        eng = p.slo.install_engine(p.slo.SloEngine([p.slo.SloSpec(
            "depth", "serving.decode.queue_depth", 4.0, op="<=")]))
        p.telemetry.gauge("serving.decode.queue_depth").set(9.0)
        eng.evaluate_once(now=50.0)
        status = p.health.handle_health_op("status", {})
        return p.slo.active_alerts(), status["alerts"], "trends" in status

    active, alerts, has_trends = _both(script)
    assert [a["slo"] for a in alerts] == ["depth"] == [
        a["slo"] for a in active]
    assert not has_trends


# -- watchdog -----------------------------------------------------------------

def _watch(p, wd, calls):
    """Run ``calls`` (method name, argument) on ``wd``; record each
    call's outcome as the error's type name and text, or None."""
    out = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for name, arg in calls:
            try:
                getattr(wd, name)(*(() if arg is None else (arg,)))
                out.append(None)
            except p.watchdog.WatchdogError as e:
                out.append((type(e).__name__, e.kind, str(e)))
    return out, [str(w.message) for w in caught]


NAN = float("nan")


@pytest.mark.parametrize("policy", ("warn", "raise", "checkpoint_and_raise"))
@pytest.mark.parametrize("case", ("nan", "update_norm", "divergence",
                                  "stall", "slo"))
def test_watchdog_trips_under_each_policy(policy, case):
    def script(p):
        t, trips, ckpt = [0.0], [], []
        wd = p.watchdog.TrainingWatchdog(
            policy=policy, divergence_factor=2.0, min_observations=3,
            ema=0.0, stall_timeout_s=10.0, clock=lambda: t[0],
            checkpoint_fn=lambda: ckpt.append(1),
            on_trip=lambda e: trips.append(type(e).__name__))
        calls = {
            "nan": [("observe_loss", 1.0), ("observe_loss", NAN),
                    ("observe_loss", 2.0)],
            "update_norm": [("observe_update_norm", 3.0),
                            ("observe_update_norm", float("inf"))],
            "divergence": [("observe_loss", 1.0), ("observe_loss", 1.0),
                           ("observe_loss", 5.0)],
            "stall": [("notify_progress", None), ("check_stall", 5.0),
                      ("check_stall", 16.0)],
            "slo": [("observe_slo_breach", p.slo.AlertEvent(
                slo="mfu-floor", metric="observability.mfu", observed=0.2,
                threshold=0.5, op=">=", severity="page", time=1.0,
                message="observability.mfu value=0.2 violates >= 0.5"))],
        }[case]
        out, warned = _watch(p, wd, calls)
        return (out, warned, trips, ckpt,
                type(wd.tripped).__name__ if wd.tripped else None,
                _snap(p, ("health.watchdog.",)))

    out, warned, trips, ckpt, tripped, snap = _both(script)
    kind = {"nan": "nan", "update_norm": "nan", "divergence": "divergence",
            "stall": "stall", "slo": "slo"}[case]
    assert tripped is not None
    assert snap["counters"][f"health.watchdog.trips{{kind={kind},"
                            f"policy={policy}}}"] == 1
    if policy == "warn":
        assert all(o is None for o in out) and len(warned) == 1
        assert trips == []
    else:
        assert [o for o in out if o is not None][0][1] == kind
        assert trips == [tripped]
        assert ckpt == ([1] if policy == "checkpoint_and_raise" else [])


def test_watchdog_progress_resets_stall_and_bad_config():
    def script(p):
        t = [0.0]
        wd = p.watchdog.TrainingWatchdog(policy="raise",
                                         stall_timeout_s=10.0,
                                         clock=lambda: t[0])
        wd.notify_progress()
        t[0] = 9.0
        wd.notify_progress()
        t[0] = 18.0
        wd.check_stall()
        errors = []
        for kw in (dict(policy="explode"), dict(divergence_factor=0.5),
                   dict(ema=1.0)):
            try:
                p.watchdog.TrainingWatchdog(**kw)
            except ValueError as e:
                errors.append(str(e))
        return wd.tripped, errors, _snap(p, ("health.watchdog.",))

    tripped, errors, _ = _both(script)
    assert tripped is None and len(errors) == 3


# -- resolve(health=...) ------------------------------------------------------

@pytest.mark.parametrize("arg", [
    None, "warn", "raise", "checkpoint_and_raise",
    {"policy": "warn", "stall_timeout_s": 5.0},
    {"divergence_factor": 3.0, "straggler_k": 4.0},
    "config", "panic", "watchdog", 42], ids=str)
def test_resolve_health_argument_forms(arg):
    def script(p):
        a = {"config": p.health.HealthConfig(policy="raise"),
             "watchdog": p.health.TrainingWatchdog()}.get(arg, arg) \
            if isinstance(arg, str) else arg
        try:
            got = p.health.resolve(a)
        except (TypeError, ValueError) as e:
            return type(e).__name__, str(e)
        if got is None:
            return None
        wd = got.make_watchdog()
        det = got.make_straggler_detector()
        return (dict(vars(got)), wd.policy, wd.divergence_factor,
                det.k, det.min_samples)

    got = _both(script)
    if arg in ("panic",):
        assert got[0] == "ValueError"
    elif arg in ("watchdog", 42):
        assert got[0] == "TypeError"
    elif arg is not None:
        assert got[0]["policy"] in ("warn", "raise",
                                    "checkpoint_and_raise")


# -- exporters ----------------------------------------------------------------

def _fill_registry(p):
    p.telemetry.gauge("health.worker.clock", worker=0).set(5)
    p.telemetry.counter("ps.commits").inc(3)
    p.telemetry.gauge("fleet.replicas", role="both").set(2)
    p.telemetry.gauge("a.b-c", path='x"y\\z').set(1.5)
    h = p.telemetry.histogram("serving.decode.ttft_s")
    for v in (0.1, 0.3, 0.2, 0.9):
        h.record(v)
    return p.telemetry.get_registry().snapshot()


def test_prometheus_text_byte_equal():
    snap = _fill_registry(PLANES["jax"])
    texts = {name: (p.export.snapshot_to_prometheus(snap),
                    p.export.rows_to_prometheus(
                        p.export.snapshot_to_rows(snap)))
             for name, p in PLANES.items()}
    assert texts["port"] == texts["jax"]
    text = texts["port"][0]
    assert 'health_worker_clock{worker="0"} 5' in text
    assert 'a_b_c{path="x\\"y\\\\z"} 1.5' in text
    assert "# TYPE serving_decode_ttft_s summary" in text
    # the port's registry renders the same text for the same metrics
    assert PLANES["port"].export.snapshot_to_prometheus(
        _fill_registry(PLANES["port"])) == text


def test_chrome_trace_equal(tmp_path):
    rows = [
        {"kind": "span", "name": "fold", "t0": 1.0, "dur_s": 0.5,
         "labels": {"worker": "0"}},
        {"kind": "span", "name": "fold", "t0": 2.0, "dur_s": 0.25,
         "labels": {"worker": "1"}, "trace_id": "ab", "span_id": "cd"},
        {"kind": "span", "name": "step", "t0": 2.5, "dur_s": 0.1},
        {"kind": "gauge", "name": "skip.me", "value": 1.0, "labels": {}},
    ]
    traces = {name: p.export.chrome_trace(rows)
              for name, p in PLANES.items()}
    assert traces["port"] == traces["jax"]
    assert len(traces["port"]["traceEvents"]) == 3
    files = {}
    for name, p in PLANES.items():
        path = p.export.write_chrome_trace(str(tmp_path / f"{name}.json"),
                                           rows)
        with open(path) as f:
            files[name] = json.load(f)
    assert files["port"] == files["jax"] == traces["port"]


# -- CLI and collector --------------------------------------------------------

FLEET_ROWS = [
    {"kind": "gauge", "name": "fleet.replicas", "labels": {"role": "both"},
     "value": 2},
    {"kind": "gauge", "name": "fleet.replicas",
     "labels": {"role": "prefill"}, "value": 1},
    {"kind": "gauge", "name": "fleet.replicas",
     "labels": {"role": "decode"}, "value": 0},
    {"kind": "gauge", "name": "fleet.replica.queue_depth",
     "labels": {"replica": "0"}, "value": 3.0},
    {"kind": "gauge", "name": "fleet.replica.queue_depth",
     "labels": {"replica": "1"}, "value": 7.0},
    {"kind": "gauge", "name": "fleet.version_skew", "labels": {},
     "value": 1},
    {"kind": "gauge", "name": "fleet.affinity.hit_rate", "labels": {},
     "value": 0.4567},
    {"kind": "counter", "name": "fleet.requeued", "labels": {}, "value": 2},
    {"kind": "counter", "name": "fleet.handoffs", "labels": {}, "value": 8},
    {"kind": "counter", "name": "fleet.evictions", "labels": {}, "value": 1},
    {"kind": "gauge", "name": "health.alerts.active",
     "labels": {"slo": "fleet-replica-1-depth"}, "value": 1.0},
    {"kind": "gauge", "name": "health.alerts.active",
     "labels": {"slo": "staleness", "worker": "1"}, "value": 1.0},
    {"kind": "gauge", "name": "timeseries.trends_active",
     "labels": {"trend": "hbm-leak"}, "value": 1.0},
    {"kind": "gauge", "name": "rollout.model_version",
     "labels": {"engine": "generation"}, "value": 7},
    {"kind": "gauge", "name": "rollout.model_version",
     "labels": {"engine": "serving"}, "value": 6},
    {"kind": "gauge", "name": "serving.decode.prefix.hit_rate",
     "labels": {}, "value": 0.5},
    {"kind": "gauge", "name": "data.service.cursor", "labels": {},
     "value": 12},
    {"kind": "counter", "name": "data.service.releases",
     "labels": {"reason": "lease"}, "value": 3},
    {"kind": "gauge", "name": "profile.op.share",
     "labels": {"op": "dot", "bound": "compute"}, "value": 0.6},
    {"kind": "gauge", "name": "health.worker.heartbeat_time",
     "labels": {"worker": "0"}, "value": 990.0},
    {"kind": "gauge", "name": "health.worker.heartbeat_time",
     "labels": {"worker": "1"}, "value": 995.5},
    {"kind": "counter", "name": "health.worker.windows",
     "labels": {"worker": "0"}, "value": 40},
    {"kind": "gauge", "name": "health.worker.straggler",
     "labels": {"worker": "1"}, "value": 1.0},
    {"kind": "counter", "name": "host_async.degraded_windows",
     "labels": {"worker": "1"}, "value": 2},
]


def _render(p):
    c = p.cli
    workers = p.collector.worker_table(FLEET_ROWS, 1000.0)
    fleet = dict(fleet_alerts=c._fleet_alerts(FLEET_ROWS),
                 fleet_versions=c._fleet_versions(FLEET_ROWS),
                 fleet_decode=c._fleet_decode(FLEET_ROWS),
                 fleet_data=c._fleet_data(FLEET_ROWS),
                 fleet_ops=c._fleet_ops(FLEET_ROWS),
                 fleet_router=c._fleet_router(FLEET_ROWS),
                 fleet_trends=c._fleet_trends(FLEET_ROWS))
    return (workers, fleet,
            c._watch_table(workers, {"0": 30}, 2.0, **fleet),
            c._watch_table({}, {}, 0.0),
            c._watch_line({"workers": {"0": {"age_s": 1.5}},
                           "stragglers": ["1"], "watchdog_tripped": True,
                           "alerts": [{}], "queue_depth": 3,
                           "model_version": 7}),
            c._snapshot_rows({"gauges": {"a.b{x=1}": 2.0},
                              "counters": {"c": 3}}))


def test_cli_fleet_line_and_watch_table_render_equal(monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:00:00")
    workers, fleet, table, empty, line, rows = _both(_render)
    assert fleet["fleet_router"] == {
        "skew": 1, "affinity": 0.46, "requeued": 2, "handoffs": 8,
        "evictions": 1, "replicas": 3, "roles": "b2/p1", "depth_max": 7.0}
    assert ("FLEET: replicas=3 roles=b2/p1 depth_max=7.0 skew=1 "
            "affinity=0.46 requeued=2 evictions=1 handoffs=8") in table
    assert "ALERTS: fleet-replica-1-depth" in table
    assert "TRENDS: hbm-leak" in table and "SKEW" in table
    assert workers["1"]["straggler"] and workers["1"]["alerts"] == 1
    assert "(no workers reporting yet)" in empty
    assert "watchdog=TRIPPED" in line and "model_version=7" in line
    # no router, no FLEET line
    assert "FLEET" not in PLANES["port"].cli._watch_table(
        workers, {}, 0.0, fleet_router=PLANES["port"].cli._fleet_router(
            FLEET_ROWS[10:]))


def test_collector_bounds_and_merged_rows():
    def script(p):
        col = p.collector.TelemetryCollector(max_batches=2,
                                             max_rows_per_batch=3)
        acks = [col.add_batch(pid, [{"kind": "counter", "name": "c",
                                     "labels": {}, "value": i}
                                    for i in range(n)])
                for pid, n in ((1, 2), (2, 5), (3, 1))]
        return acks, col.merged_rows(local_pid=9), col.processes, \
            _snap(p, ("collector.",))

    acks, rows, pids, snap = _both(script)
    assert [a["dropped"] for a in acks] == [0, 2, 0]
    assert pids == [1, 2, 3]
    assert snap["counters"]["collector.dropped_batches"] == 1
    assert snap["counters"]["collector.dropped_rows"] == 2
    # the oldest batch went; the truncated one kept its 3-row prefix
    assert sorted((r["pid"], r["value"]) for r in rows
                  if r.get("name") == "c") == [(2, 0), (2, 1), (2, 2),
                                               (3, 0)]


def _serve_health(port):
    """The port's CLI ``status`` and ``watch --once --table`` against a
    health endpoint; returns what it printed, parsed where JSON."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main([f"127.0.0.1:{port}", "status"]) == 0
    status = json.loads(buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main([f"127.0.0.1:{port}", "metrics", "--format",
                         "prom"]) == 0
    return status, buf.getvalue()


def test_port_cli_polls_jax_and_port_endpoints():
    """One CLI, either package's service: the JAX package's and the
    port's serving fronts answer ``status`` and ``metrics`` alike."""
    from distkeras_tpu import serving as jserving
    from distkeras_tpu_torch import serving as tserving

    engine = types.SimpleNamespace(health_status=lambda: {})
    servers = {"jax": jserving.ServingServer(engine, host="127.0.0.1"),
               "port": tserving.ServingServer(engine, host="127.0.0.1")}
    got = {}
    try:
        for name, srv in servers.items():
            srv.start()
            p = PLANES[name]
            p.telemetry.gauge("serving.decode.queue_depth").set(3.0)
            p.telemetry.counter("fleet.requeued").inc(2)
            got[name] = _serve_health(srv.port)
    finally:
        for srv in servers.values():
            srv.stop()
    for name, (status, prom) in got.items():
        assert status["service"] == "serving" and status["alerts"] == []
        assert "fleet_requeued 2" in prom
        assert "serving_decode_queue_depth 3" in prom
    assert sorted(got["port"][0]) == sorted(got["jax"][0])
