"""Live introspection endpoints (port of
``distkeras_tpu/health/endpoints.py``): handler + poller client.

The health plane does not invent a second server. The parameter-server
control connection (``parallel/remote_ps.py``) and the serving front-end
(``serving/server.py``) already speak the same length-prefixed framing
(``[u32 header_len][JSON header][blobs...]``) behind the same shared-token
auth — so the introspection ops mount as three extra header-only ops on
BOTH services:

===================  ======================================================
op                   reply header
===================  ======================================================
``status``           compact liveness digest: per-worker heartbeat ages,
                     staleness, stragglers, watchdog state, plus
                     service-specific fields the host merges in
                     (PS clock / serving queue depth)
``metrics-snapshot`` ``{"snapshot": MetricsRegistry.snapshot()}`` — the
                     full lock-consistent registry view
``recent-spans``     ``{"spans": [...]}`` — newest ``limit`` span events
``series``           ``{"series": MetricStore.rows(...)}`` — windowed
                     time-series history from the installed store
                     (DESIGN.md §24); ``[]`` when no store is installed
===================  ======================================================

Everything rides in JSON headers (no blobs), so :class:`HealthClient` and
the ``python -m distkeras_tpu.health.cli`` poller work against either
service with one code path.

This module stays import-light: the framing helpers are imported lazily
inside :class:`HealthClient` so ``remote_ps`` (which imports this module to
mount the ops) never forms an import cycle, and nothing here imports jax.
"""

from __future__ import annotations

import socket
import time
from typing import Any, Dict, List, Optional

from distkeras_tpu_torch import telemetry

HEALTH_OPS = ("status", "metrics-snapshot", "recent-spans", "series")

#: A worker whose last heartbeat is older than this (seconds) is reported
#: ``"late"`` in the status digest even if the straggler detector (which
#: only sees *completed* windows) has not flagged it.
LATE_HEARTBEAT_S = 30.0


def _worker_digest(snapshot: dict, now: float) -> Dict[str, dict]:
    """Group the ``health.worker.*`` gauges by worker id into one dict per
    worker: ``{"age_s": ..., "clock": ..., "staleness": ..., "window_s":
    ..., "windows": ..., "straggler": bool, "late": bool}``."""
    from distkeras_tpu_torch.health.export import _parse_key

    workers: Dict[str, dict] = {}

    def bucket(key: str) -> Optional[tuple]:
        name, labels = _parse_key(key)
        if not name.startswith("health.worker.") or "worker" not in labels:
            return None
        return labels["worker"], name[len("health.worker."):]

    for key, value in snapshot.get("gauges", {}).items():
        hit = bucket(key)
        if hit is None:
            continue
        worker, field = hit
        w = workers.setdefault(worker, {})
        if field == "heartbeat_time":
            w["age_s"] = round(now - value, 3)
        elif field == "straggler":
            w["straggler"] = bool(value)
        else:
            w[field] = value
    for key, value in snapshot.get("counters", {}).items():
        hit = bucket(key)
        if hit is not None and hit[1] == "windows":
            workers.setdefault(hit[0], {})["windows"] = value
    for w in workers.values():
        w["late"] = w.get("age_s", 0.0) > LATE_HEARTBEAT_S
    return workers


def handle_health_op(op: str, header: dict,
                     extra_status: Optional[dict] = None) -> dict:
    """Compute the reply header for one introspection op. The hosting
    service passes ``extra_status`` (its own identity + live fields) which
    is merged into the ``status`` digest."""
    reg = telemetry.get_registry()
    if reg is None:
        return {"error": "telemetry is uninstalled in this process"}
    if op == "metrics-snapshot":
        return {"snapshot": reg.snapshot()}
    if op == "recent-spans":
        return {"spans": reg.recent_spans(int(header.get("limit", 100)))}
    if op == "series":
        # time-series history (DESIGN.md §24): the installed MetricStore's
        # tiered rings, optionally filtered to one metric name. Lazy
        # import keeps this module import-light (docstring contract).
        from distkeras_tpu_torch.health import timeseries

        store = timeseries.get_store()
        if store is None:
            return {"series": []}
        return {"series": store.rows(
            name=header.get("name"),
            tier=str(header.get("tier", "raw")),
            max_points=int(header.get("max_points", 120)))}
    if op == "status":
        now = time.time()
        snap = reg.snapshot()
        workers = _worker_digest(snap, now)
        gauges = snap.get("gauges", {})
        status = {
            "time": now,
            "workers": workers,
            "stragglers": sorted(w for w, d in workers.items()
                                 if d.get("straggler")),
            "watchdog_tripped": bool(
                gauges.get("health.watchdog.tripped", 0.0)),
            "counters": {k: v for k, v in
                         snap.get("counters", {}).items()
                         if not k.startswith("health.worker.")},
        }
        # device-memory digest: observability.hbm_stats() publishes the
        # PJRT allocator counters as gauges, so the status op can report
        # HBM pressure without this module ever importing jax
        hbm = {key[len("observability.hbm_"):]: int(value)
               for key, value in gauges.items()
               if key.startswith("observability.hbm_")}
        if hbm:
            status["hbm"] = hbm
        # roofline digest: RooflineReport.publish() leaves per-op share
        # gauges (profile.op.share{bound=...,op=...}); the status op
        # surfaces the top-3 offenders so `watch` can show where the
        # compiled compute actually goes — again without importing jax
        from distkeras_tpu_torch.health.export import _parse_key

        roofline = []
        for key, value in gauges.items():
            name, labels = _parse_key(key)
            if name == "profile.op.share" and "op" in labels:
                roofline.append({"op": labels["op"],
                                 "share": round(value, 4),
                                 "bound": labels.get("bound", "?")})
        if roofline:
            roofline.sort(key=lambda r: (-r["share"], r["op"]))
            status["roofline"] = roofline[:3]
            cov = gauges.get("profile.op.coverage")
            if cov is not None:
                status["roofline_coverage"] = round(cov, 4)
        # SLO judgement (health/slo.py): active alerts of the installed
        # engine ride the digest so `watch` and the CLI see breaches live.
        # Lazy import keeps this module import-light (docstring contract).
        from distkeras_tpu_torch.health import slo as slo_mod

        status["alerts"] = slo_mod.active_alerts()
        # trend judgement (health/timeseries.py, DESIGN.md §24): active
        # long-horizon trends (leaks/stalls/drift) of the installed
        # monitor ride the digest next to the instantaneous alerts
        from distkeras_tpu_torch.health import timeseries as ts_mod

        trends = ts_mod.active_trends()
        if trends:
            status["trends"] = trends
        rec = telemetry.get_recorder()
        if rec is not None and hasattr(rec, "last_dump_path"):
            status["recorder"] = {
                "events": len(getattr(rec, "_ring", ())),
                "last_dump": rec.last_dump_path,
            }
        if extra_status:
            status.update(extra_status)
        return status
    return {"error": f"unknown health op {op!r}"}


class HealthClient:
    """Poller for the introspection ops of either service (PS or serving).

    One persistent control connection, header-only requests; ``token``
    must match the service's shared secret. The wire helpers are imported
    lazily so importing this module never pulls in ``remote_ps`` (which
    itself imports this module to mount the ops).

    ``follow=True`` (default) makes the client survive a coordinator MOVE
    (DESIGN.md §17): status replies advertise the fleet's shard + standby
    addresses, and when the watched service dies or answers "fenced", the
    client asks an advertised peer ``{"op": "coordinator"}`` — the same
    discovery op whose lease check triggers lazy standby promotion — and
    re-attaches to the promoted coordinator instead of erroring out."""

    def __init__(self, address: str, token: Optional[str] = None,
                 timeout: float = 10.0, follow: bool = True):
        from distkeras_tpu_torch.parallel.remote_ps import (recv_message,
                                                            send_message)

        self._send, self._recv = send_message, recv_message
        self.address = address
        self.token = token
        self.timeout = timeout
        self.follow = bool(follow)
        self._alternates: List[str] = []
        self._sock = self._connect(address)

    def _connect(self, address: str) -> socket.socket:
        host, _, port = address.rpartition(":")
        sock = socket.create_connection((host, int(port)),
                                        timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _note_hints(self, reply: dict) -> None:
        # remember every address the service advertises (shard fleet +
        # standby) — the candidate list for coordinator re-resolution
        hints = list(reply.get("shard_addresses") or [])
        if reply.get("standby"):
            hints.append(reply["standby"])
        for addr in hints:
            if addr and addr != self.address \
                    and addr not in self._alternates:
                self._alternates.append(addr)

    def _call_once(self, op: str, fields: dict) -> dict:
        header: Dict[str, Any] = {"op": op, **fields}
        if self.token is not None:
            header["token"] = self.token
        self._send(self._sock, header)
        reply, _ = self._recv(self._sock)
        if "error" in reply:
            if reply.get("error_kind") == "fenced" and self.follow and \
                    self._re_resolve(prefer=reply.get("coordinator")):
                return self._call_once(op, fields)
            raise RuntimeError(
                f"health op {op!r} against {self.address}: "
                f"{reply['error']}")
        self._note_hints(reply)
        reply.pop("blob_lens", None)
        return reply

    def _call(self, op: str, **fields) -> dict:
        try:
            return self._call_once(op, fields)
        except OSError:
            if not self.follow or not self._re_resolve():
                raise
            return self._call_once(op, fields)

    def _re_resolve(self, prefer: Optional[str] = None) -> bool:
        """Find the live coordinator among the advertised peers and point
        this client at it. Returns False when no candidate answers with a
        live (possibly just-promoted) coordinator — e.g. the standby's
        lease window has not lapsed yet; the caller may simply retry."""
        candidates = ([prefer] if prefer else []) + list(self._alternates)
        for addr in candidates:
            try:
                sock = self._connect(addr)
            except OSError:
                continue
            try:
                header: Dict[str, Any] = {"op": "coordinator"}
                if self.token is not None:
                    header["token"] = self.token
                self._send(sock, header)
                view, _ = self._recv(sock)
            except OSError:
                sock.close()
                continue
            if "error" in view:
                sock.close()
                continue
            target = view.get("address") or addr
            if target == addr:
                new_sock = sock  # the probe already holds the coordinator
            else:
                sock.close()
                try:
                    new_sock = self._connect(target)
                except OSError:
                    continue
            self.close()
            self._sock, self.address = new_sock, target
            telemetry.counter("elastic.failover.resolves").inc()
            return True
        return False

    def status(self) -> dict:
        return self._call("status")

    def metrics_snapshot(self) -> dict:
        return self._call("metrics-snapshot")["snapshot"]

    def recent_spans(self, limit: int = 100) -> List[dict]:
        return self._call("recent-spans", limit=int(limit))["spans"]

    def series(self, name: Optional[str] = None, tier: str = "raw",
               max_points: int = 120) -> List[dict]:
        """The peer's stored time-series rows (``[]`` when the peer has no
        MetricStore installed)."""
        fields: Dict[str, Any] = {"tier": tier,
                                  "max_points": int(max_points)}
        if name is not None:
            fields["name"] = name
        return self._call("series", **fields)["series"]

    def merged_rows(self) -> List[dict]:
        """The fleet-merged telemetry rows from the peer's collector
        (parameter-server coordinator only). Raises RuntimeError against
        a service without the op; the CLI falls back to the local
        snapshot."""
        return self._call("telemetry_merged")["rows"]

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "HealthClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
