"""Poller CLI for the live introspection endpoints (port of
``distkeras_tpu/health/cli.py``; it speaks the JAX package's wire, so it
polls the JAX package's services as well as the port's).

Point it at a running parameter-server service or serving front-end::

    python -m distkeras_tpu_torch.health.cli 127.0.0.1:41217 status
    python -m distkeras_tpu_torch.health.cli 127.0.0.1:41217 metrics \
        --format prom
    python -m distkeras_tpu_torch.health.cli 127.0.0.1:41217 spans \
        --chrome t.json
    python -m distkeras_tpu_torch.health.cli 127.0.0.1:41217 watch --interval 2

Commands: ``status`` (one liveness digest), ``metrics`` (full snapshot as
JSON or Prometheus text), ``spans`` (recent span events; ``--chrome PATH``
writes a chrome://tracing file instead), ``watch`` (poll ``status``
forever — or ``--count N`` times / ``--once`` for scripting — printing
one compact line per poll; ``--interval`` must be > 0).
``watch --table`` renders one row PER WORKER per poll instead (heartbeat
age, windows completed, window rate over the poll interval, staleness,
degraded-window count, active SLO alerts, straggler flag), preferring the
coordinator's fleet-merged collector view (``telemetry_merged``) and
falling back to the peer's local snapshot when the service doesn't carry
a collector. Pass ``--token`` when the service was started with a shared
secret.

The address-less ``postmortem`` subcommand works on files instead of a
live service: it globs the per-process flight-recorder bundles
(``postmortem*.json.p*``) a crashed run left next to its checkpoints and
renders one merged cross-process timeline::

    python -m distkeras_tpu_torch.health.cli postmortem /ckpt/dir
    python -m distkeras_tpu_torch.health.cli postmortem /ckpt/dir \
        --json out.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

from distkeras_tpu_torch.health import export
from distkeras_tpu_torch.health.collector import worker_table
from distkeras_tpu_torch.health.endpoints import HealthClient


def _snapshot_rows(snapshot: dict) -> list:
    """Flatten a ``metrics-snapshot`` payload into row dicts so the
    fallback path feeds :func:`worker_table` the same shape the merged
    collector stream does."""
    rows = []
    for kind in ("gauge", "counter"):
        for key, value in snapshot.get(kind + "s", {}).items():
            name, labels = export._parse_key(key)
            rows.append({"kind": kind, "name": name, "labels": labels,
                         "value": value})
    return rows


def _fleet_rows(client: HealthClient) -> list:
    try:
        return client.merged_rows()
    except RuntimeError:  # no collector behind this address
        return _snapshot_rows(client.metrics_snapshot())


def _fleet_alerts(rows: list) -> list:
    """Names of SLOs whose ``health.alerts.active`` gauge is set and that
    carry no worker label (fleet-wide breaches; per-worker ones land in
    their row's ALERTS column via :func:`worker_table`)."""
    out = []
    for r in rows:
        labels = r.get("labels") or {}
        if (r.get("kind") == "gauge"
                and r.get("name") == "health.alerts.active"
                and r.get("value") and "worker" not in labels):
            slo = labels.get("slo", "?")
            if slo not in out:
                out.append(slo)
    return out


def _fleet_trends(rows: list) -> list:
    """Names of active long-horizon trends (DESIGN.md §24): the
    ``timeseries.trends_active`` gauges the TrendMonitor flips, minus the
    per-worker variants (those land in their row's TREND column via
    :func:`worker_table`)."""
    out = []
    for r in rows:
        labels = r.get("labels") or {}
        if (r.get("kind") == "gauge"
                and r.get("name") == "timeseries.trends_active"
                and r.get("value") and "worker" not in labels):
            trend = labels.get("trend", "?")
            if trend not in out:
                out.append(trend)
    return out


def _fleet_versions(rows: list) -> dict:
    """{engine label: model_version} from the ``rollout.model_version``
    gauges — the fleet version-skew view (one glance says whether every
    engine is serving the same deployment, DESIGN.md §18)."""
    out = {}
    for r in rows:
        if (r.get("kind") == "gauge"
                and r.get("name") == "rollout.model_version"):
            labels = r.get("labels") or {}
            out[labels.get("engine", "?")] = int(r.get("value", 0))
    return out


def _fleet_decode(rows: list) -> dict:
    """Decode-plane gauges worth one glance in the fleet table:
    prefix-cache hit rate, KV page occupancy, chunked-prefill queue
    depth, and int8-KV megabytes saved
    (``serving.decode.prefix.hit_rate`` /
    ``serving.decode.paged.page_occupancy`` /
    ``serving.decode.chunk.queue_depth`` /
    ``serving.decode.paged.kv_quant_bytes_saved``, DESIGN.md §19).
    Keys appear only when an engine exports the gauge, so fleets not
    using a feature pay no extra field."""
    out = {}
    wanted = {"serving.decode.prefix.hit_rate": ("prefix_hit_rate", 1.0),
              "serving.decode.paged.page_occupancy": ("page_occupancy",
                                                      1.0),
              "serving.decode.chunk.queue_depth": ("chunk_queue", 1.0),
              "serving.decode.paged.kv_quant_bytes_saved": ("kv_saved_mb",
                                                            1e-6)}
    for r in rows:
        picked = wanted.get(r.get("name"))
        if picked and r.get("kind") == "gauge":
            label, scale = picked
            out[label] = float(r.get("value", 0.0)) * scale
    return out


def _fleet_data(rows: list) -> dict:
    """Streaming-data-service digest for the fleet table (DESIGN.md §20):
    shuffle-cursor position, epoch, leased/total ranges, and cumulative
    re-leases. Keys appear only when a DataCoordinator exports the
    metrics, so PS-only fleets pay no extra line."""
    out = {}
    wanted = {"data.service.cursor": ("cursor", int),
              "data.service.epoch": ("epoch", int),
              "data.service.leased_ranges": ("leased", int),
              "data.service.ranges": ("ranges", int)}
    releases = 0.0
    have_releases = False
    for r in rows:
        picked = wanted.get(r.get("name"))
        if picked and r.get("kind") == "gauge":
            label, cast = picked
            out[label] = cast(r.get("value", 0))
        elif (r.get("name") == "data.service.releases"
              and r.get("kind") == "counter"):
            releases += float(r.get("value", 0))  # summed over reasons
            have_releases = True
    if out and have_releases:
        out["releases"] = int(releases)
    return out


def _fleet_router(rows: list) -> dict:
    """Routed-serving-fleet digest for the fleet table (DESIGN.md §22):
    live replicas by role, the worst per-replica queue depth, version
    skew, affinity hit rate, and the router's shed/re-queue/handoff
    tallies. Keys appear only when a FleetRouter exports the metrics,
    so router-less fleets pay no extra line."""
    out: dict = {}
    roles: dict = {}
    depth = None
    tallies = {"fleet.sheds": "sheds", "fleet.requeued": "requeued",
               "fleet.handoffs": "handoffs",
               "fleet.handoff_failures": "handoff_failures",
               "fleet.evictions": "evictions"}
    for r in rows:
        name, kind = r.get("name"), r.get("kind")
        labels = r.get("labels") or {}
        if kind == "gauge" and name == "fleet.replicas":
            n = int(r.get("value", 0))
            if n:
                roles[labels.get("role", "?")] = n
        elif kind == "gauge" and name == "fleet.replica.queue_depth":
            v = float(r.get("value", 0.0))
            depth = v if depth is None else max(depth, v)
        elif kind == "gauge" and name == "fleet.version_skew":
            out["skew"] = int(r.get("value", 0))
        elif kind == "gauge" and name == "fleet.affinity.hit_rate":
            out["affinity"] = round(float(r.get("value", 0.0)), 2)
        elif kind == "counter" and name in tallies:
            out[tallies[name]] = int(r.get("value", 0))
    if roles:
        out["replicas"] = sum(roles.values())
        # compact role spread: p=prefill, d=decode, b=both
        out["roles"] = "/".join(f"{k[:1]}{v}"
                                for k, v in sorted(roles.items()))
    if depth is not None:
        out["depth_max"] = depth
    return out


def _fleet_ops(rows: list) -> list:
    """Op-roofline digest for the fleet table (DESIGN.md §21): the top
    ``profile.op.share`` gauges RooflineReport.publish() left behind,
    each with its boundedness verdict. Entries appear only when a process
    published a roofline, so fleets without op attribution pay no extra
    line."""
    out = []
    for r in rows:
        if (r.get("kind") == "gauge"
                and r.get("name") == "profile.op.share"):
            labels = r.get("labels") or {}
            out.append((labels.get("op", "?"),
                        float(r.get("value", 0.0)),
                        labels.get("bound", "?")))
    out.sort(key=lambda t: (-t[1], t[0]))
    return out[:3]


def _watch_table(workers: dict, prev: dict, interval: float,
                 fleet_alerts: list = (), fleet_versions: dict = (),
                 fleet_decode: dict = (), fleet_data: dict = (),
                 fleet_ops: list = (), fleet_router: dict = (),
                 fleet_trends: list = ()) -> str:
    cols = ("worker", "hb_age", "windows", "win/s", "staleness",
            "degraded", "alerts", "trend", "flag")
    lines = [time.strftime("%H:%M:%S") + "  " +
             " ".join(f"{c:>9s}" for c in cols)]
    for worker in sorted(workers, key=str):
        w = workers[worker]
        windows = w.get("windows", 0)
        rate = "-"
        if worker in prev and interval > 0:
            rate = f"{max(0, windows - prev[worker]) / interval:.2f}"
        age = w.get("age_s")
        vals = (worker, "-" if age is None else f"{age:.1f}s",
                str(windows), rate, str(w.get("staleness", "-")),
                str(w.get("degraded", 0)), str(w.get("alerts", 0)),
                str(w.get("trends", 0)),
                "STRAGGLER" if w.get("straggler") else "ok")
        lines.append("          " + " ".join(f"{v:>9s}" for v in vals))
    if len(lines) == 1:
        lines.append("          (no workers reporting yet)")
    if fleet_alerts:
        lines.append(f"          ALERTS: {', '.join(fleet_alerts)}")
    if fleet_trends:
        lines.append(f"          TRENDS: {', '.join(fleet_trends)}")
    if fleet_versions:
        skew = " SKEW" if len(set(fleet_versions.values())) > 1 else ""
        lines.append("          VERSIONS: " + ", ".join(
            f"{k}=v{v}" for k, v in sorted(fleet_versions.items())) + skew)
    if fleet_decode:
        lines.append("          DECODE: " + " ".join(
            f"{k}={v:.2f}" for k, v in sorted(fleet_decode.items())))
    if fleet_data:
        order = ("epoch", "cursor", "ranges", "leased", "releases")
        parts = [f"{k}={fleet_data[k]}" for k in order if k in fleet_data]
        parts += [f"{k}={v}" for k, v in sorted(fleet_data.items())
                  if k not in order]
        lines.append("          DATA: " + " ".join(parts))
    if fleet_ops:
        lines.append("          OPS: " + " ".join(
            f"{op}={share:.2f}({bound})" for op, share, bound in fleet_ops))
    if fleet_router:
        order = ("replicas", "roles", "depth_max", "skew", "affinity",
                 "sheds", "requeued", "evictions", "handoffs",
                 "handoff_failures")
        parts = [f"{k}={fleet_router[k]}" for k in order
                 if k in fleet_router]
        parts += [f"{k}={v}" for k, v in sorted(fleet_router.items())
                  if k not in order]
        lines.append("          FLEET: " + " ".join(parts))
    return "\n".join(lines)


def _watch_line(status: dict) -> str:
    workers = status.get("workers", {})
    ages = [d.get("age_s") for d in workers.values()
            if d.get("age_s") is not None]
    parts = [
        time.strftime("%H:%M:%S"),
        f"workers={len(workers)}",
        f"max_hb_age={max(ages):.1f}s" if ages else "max_hb_age=-",
        f"stragglers={','.join(status.get('stragglers', [])) or '-'}",
        f"watchdog={'TRIPPED' if status.get('watchdog_tripped') else 'ok'}",
        f"alerts={len(status.get('alerts', []) or [])}",
    ]
    for key in ("clock", "queue_depth", "model_version"):
        if key in status:
            parts.append(f"{key}={status[key]}")
    return "  ".join(parts)


def _postmortem_main(argv: list) -> int:
    """The address-less subcommand: merge + render recorder bundles."""
    from distkeras_tpu_torch.health import recorder

    ap = argparse.ArgumentParser(
        prog="python -m distkeras_tpu_torch.health.cli postmortem",
        description="Merge the per-process flight-recorder bundles "
                    "(postmortem*.json.p*) a crashed run left behind "
                    "into one cross-process timeline.")
    ap.add_argument("directory",
                    help="directory holding the bundle family (usually "
                         "the run's checkpoint dir)")
    ap.add_argument("--limit", type=int, default=60,
                    help="timeline events to render (newest first)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the merged timeline as JSON")
    args = ap.parse_args(argv)
    paths = recorder.find_bundles(args.directory)
    if not paths:
        print(f"no postmortem bundles under {args.directory}",
              file=sys.stderr)
        return 1
    merged = recorder.merge_bundles(paths)
    print(recorder.render_timeline(merged, limit=args.limit))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(merged, f)
        print(f"wrote merged timeline to {args.json}")
    return 0


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "postmortem":
        return _postmortem_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m distkeras_tpu_torch.health.cli",
        description="Query the live health endpoints of a running "
                    "parameter-server or serving service. The file-based "
                    "`postmortem <dir>` subcommand merges crash bundles "
                    "instead (see `postmortem --help`).")
    ap.add_argument("address", help="host:port of the service")
    ap.add_argument("command", choices=("status", "metrics", "spans",
                                        "watch"))
    ap.add_argument("--token", default=None,
                    help="shared auth token of the service")
    ap.add_argument("--format", choices=("json", "prom"), default="json",
                    help="metrics output format (default json)")
    ap.add_argument("--limit", type=int, default=100,
                    help="span events to fetch (spans command)")
    ap.add_argument("--chrome", metavar="PATH", default=None,
                    help="write spans as a Chrome trace file instead of "
                         "printing JSON")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="seconds between polls (watch command; "
                         "must be > 0)")
    ap.add_argument("--count", type=int, default=0,
                    help="stop watch after N polls (0 = forever)")
    ap.add_argument("--once", action="store_true",
                    help="watch: poll exactly once and exit (for "
                         "scripts/CI; same as --count 1)")
    ap.add_argument("--table", action="store_true",
                    help="watch: one row per worker (heartbeat age, "
                         "window rate, staleness, degraded count, active "
                         "SLO alerts) from the fleet-merged collector "
                         "view when available")
    args = ap.parse_args(argv)
    if args.interval <= 0:
        ap.error(f"--interval must be > 0 (got {args.interval}); "
                 f"use --once or --count for bounded polling")
    if args.once:
        args.count = 1

    with HealthClient(args.address, token=args.token) as client:
        if args.command == "status":
            print(json.dumps(client.status(), indent=2, sort_keys=True))
        elif args.command == "metrics":
            snap = client.metrics_snapshot()
            if args.format == "prom":
                sys.stdout.write(export.snapshot_to_prometheus(snap))
            else:
                print(json.dumps(snap, indent=2, sort_keys=True))
        elif args.command == "spans":
            spans = client.recent_spans(limit=args.limit)
            if args.chrome:
                export.write_chrome_trace(args.chrome, spans)
                print(f"wrote {len(spans)} span events to {args.chrome}")
            else:
                print(json.dumps(spans, indent=2))
        else:  # watch
            n = 0
            prev_windows: dict = {}
            while True:
                # a dead poll is not the end of the watch: HealthClient
                # already tried to re-resolve a moved coordinator
                # (DESIGN.md §17); when even that fails (e.g. the standby's
                # lease has not lapsed yet) keep polling — the next tick
                # lands after promotion
                try:
                    if args.table:
                        rows = _fleet_rows(client)
                        workers = worker_table(rows, time.time())
                        print(_watch_table(
                            workers, prev_windows,
                            args.interval if n else 0.0,
                            fleet_alerts=_fleet_alerts(rows),
                            fleet_versions=_fleet_versions(rows),
                            fleet_decode=_fleet_decode(rows),
                            fleet_data=_fleet_data(rows),
                            fleet_ops=_fleet_ops(rows),
                            fleet_router=_fleet_router(rows),
                            fleet_trends=_fleet_trends(rows)),
                            flush=True)
                        prev_windows = {w: d.get("windows", 0)
                                        for w, d in workers.items()}
                    else:
                        print(_watch_line(client.status()), flush=True)
                except (OSError, RuntimeError) as e:
                    print(f"[watch] {client.address} unreachable "
                          f"({type(e).__name__}: {e}); retrying",
                          flush=True)
                n += 1
                if args.count and n >= args.count:
                    break
                time.sleep(args.interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
