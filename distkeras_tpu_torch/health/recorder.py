"""Flight recorder (port of ``distkeras_tpu/health/recorder.py``): a
bounded forensic ring + crash-time postmortem bundles.

The telemetry plane records richly but preserves nothing at the moment it
matters: a watchdog trip or a dead fleet yields an exception and (maybe) a
checkpoint, with the last N windows of evidence gone when the process
exits. The :class:`FlightRecorder` is the black box for that moment — a
default-on, bounded, lock-light per-process ring of recent structured
events (span events, wire-protocol outcomes, membership transitions,
host_async window phase profiles, SLO alerts), installed into
``telemetry.set_recorder`` at import so every instrumented call site feeds
it for the cost of one deque append.

On a watchdog trip, a terminal ``PSUnavailable``, an unhandled trainer
exception, or an explicit :func:`dump`, the recorder writes an atomic
**postmortem bundle** next to the crash checkpoint: ring contents, the
health ``status`` digest, the live registry rows, a config/precision/codec
fingerprint, the last trace ids seen, and the git SHA. Bundles carry the
``.p{process_index}`` suffix (``telemetry.per_process_path``) so a
shared-FS fleet leaves one per process; :func:`merge_bundles` +
``python -m distkeras_tpu.health.cli postmortem <dir>`` stitch the family
into one cross-process timeline.

Design constraints (shared with telemetry.py, enforced by tests):

- no device import — recording an event can never sync a device;
- the record path takes NO lock: ``deque(maxlen=)`` appends are atomic in
  CPython, and the counter bump is the same per-thread-sharded path every
  other metric uses;
- automatic dumps fire only when a ``dump_dir`` has been configured
  (trainers bind it to the checkpoint dir), so library users who never
  opted in never find surprise files in their cwd.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

from distkeras_tpu_torch import telemetry

#: Ring capacity: at ~200 bytes/event this bounds the recorder to ~0.5 MiB
#: while holding minutes of window/wire/alert history at realistic rates
#: (a worker window is ~1 s and emits O(10) events).
DEFAULT_CAPACITY = 2048

#: Postmortem bundle filename stem; dumps append ``_<reason>.json`` and
#: the per-process suffix, merges glob ``postmortem*``.
BUNDLE_STEM = "postmortem"


#: the checkout this package lives in (the parent of its directory)
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _git_sha(root: str = _REPO_ROOT) -> Optional[str]:
    """Best-effort repo SHA by reading ``root``/.git/HEAD (no subprocess:
    a crash path must not fork). None when ``root`` holds no .git (an
    unpacked archive): nothing above the checkout is read."""
    git = os.path.join(root, ".git")
    if not os.path.isdir(git):
        return None
    try:
        with open(os.path.join(git, "HEAD")) as f:
            head = f.read().strip()
        if not head.startswith("ref:"):
            return head or None
        ref = head.split(None, 1)[1]
        ref_path = os.path.join(git, *ref.split("/"))
        if os.path.exists(ref_path):
            with open(ref_path) as f:
                return f.read().strip() or None
        packed = os.path.join(git, "packed-refs")
        if os.path.exists(packed):
            with open(packed) as f:
                for line in f:
                    parts = line.strip().split(" ", 1)
                    if len(parts) == 2 and parts[1] == ref:
                        return parts[0]
        return None
    except OSError:
        return None


class FlightRecorder:
    """Bounded per-process event ring with atomic postmortem dumps.

    ``record`` is the universal entry point (``telemetry.record_event``
    forwards here); ``record_span_event`` is the registry's span-timeline
    tap. Both are lock-free appends. ``dump`` serializes everything the
    process knows into one atomic JSON bundle.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.dump_dir: Optional[str] = None
        self.fingerprint: Dict[str, Any] = {}
        self.roofline: Optional[Dict[str, Any]] = None
        # named digest callables polled at bundle time (the fleet router
        # registers status_digest here; anything returning a plain dict
        # qualifies — the recorder stays jax-free)
        self._digest_sources: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self.last_dump_path: Optional[str] = None
        # distinct reasons already auto-dumped: one bundle per failure
        # class per process, not one per retry of the same failure
        self._dumped_reasons: set = set()

    # -- record paths (lock-free) ----------------------------------------
    def record(self, kind: str, /, **fields) -> None:
        self._ring.append((time.time(), kind, fields))
        telemetry.counter("recorder.events", kind=kind).inc()

    def record_span_event(self, name: str, t0: float, dur_s: float,
                          labels: Dict[str, Any]) -> None:
        # span timestamps are perf_counter-based; the ring's own wall
        # clock orders them against non-span events well enough for a
        # postmortem (exact in-process ordering lives in the span t0s)
        self._ring.append((time.time(), "span",
                           {"name": name, "t0": t0, "dur_s": dur_s,
                            "labels": labels}))

    # -- configuration ----------------------------------------------------
    def set_fingerprint(self, **fields) -> None:
        """Merge run-identity fields (config/precision/codec/model) into
        the bundle fingerprint; trainers stamp these at train() start."""
        self.fingerprint.update(
            {k: v for k, v in fields.items() if v is not None})

    def set_roofline(self, digest: Dict[str, Any]) -> None:
        """Stamp the latest op-roofline digest (a plain dict from
        ``profiling.RooflineReport.digest()``) so postmortem bundles say
        where the compiled compute was going when the run died. The
        profiling layer duck-types this setter — the recorder itself
        stays jax-free (it only stores the dict)."""
        self.roofline = dict(digest)

    def set_digest_source(self, name: str,
                          fn: Optional[Callable[[], Dict[str, Any]]]
                          ) -> None:
        """Register (None: remove) a named live-digest callable polled at
        bundle time — ``FleetRouter.status_digest`` registers itself as
        ``"fleet"`` so postmortems carry the routing table, version skew
        and shed counts the moment the run died. Callables must return a
        JSON-serializable dict; a raising source degrades to an error
        string in the bundle, never a failed dump."""
        if fn is None:
            self._digest_sources.pop(name, None)
        else:
            self._digest_sources[name] = fn

    def _collect_digests(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, fn in list(self._digest_sources.items()):
            try:
                out[name] = fn()
            except Exception as e:  # a half-dead source must not kill dumps
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def events(self) -> List[dict]:
        """The ring as row dicts (oldest first)."""
        return [{"time": t, "kind": kind, **({"fields": fields})}
                for t, kind, fields in list(self._ring)]

    def last_trace_ids(self, limit: int = 8) -> List[str]:
        """The newest distinct trace ids on the ring — the breadcrumb that
        links a postmortem to the merged trace view."""
        seen: List[str] = []
        for _, kind, fields in reversed(list(self._ring)):
            if kind != "span":
                continue
            tid = (fields.get("labels") or {}).get("trace_id")
            if tid and tid not in seen:
                seen.append(tid)
                if len(seen) >= limit:
                    break
        return seen

    # -- postmortem bundles ------------------------------------------------
    def bundle(self, reason: str) -> dict:
        """Everything the process knows, as one JSON-serializable dict."""
        reg = telemetry.get_registry()
        rows = list(reg.rows()) if reg is not None else []
        try:  # the status digest is best-effort: a half-dead process
            from distkeras_tpu_torch.health.endpoints import handle_health_op

            status = handle_health_op("status", {})
        except Exception as e:  # pragma: no cover - defensive
            status = {"error": f"{type(e).__name__}: {e}"}
        try:  # installed MetricStore history + active trends (§24)
            from distkeras_tpu_torch.health import timeseries

            store = timeseries.get_store()
            series = store.rows(max_points=60) if store is not None else []
            trends = timeseries.active_trends()
        except Exception:  # pragma: no cover - defensive
            series, trends = [], []
        return {
            "kind": "postmortem",
            "reason": reason,
            "unix_time": time.time(),
            "process_index": telemetry.process_index(),
            "git_sha": _git_sha(),
            "fingerprint": dict(self.fingerprint),
            "roofline": dict(self.roofline) if self.roofline else None,
            "digests": self._collect_digests(),
            "timeseries": series,
            "trends": trends,
            "last_trace_ids": self.last_trace_ids(),
            "status": status,
            "events": self.events(),
            "rows": rows,
        }

    def dump(self, path_or_dir: Optional[str] = None,
             reason: str = "explicit") -> Optional[str]:
        """Write the postmortem bundle atomically (tmp + rename); returns
        the final path, or None when no destination is known. A directory
        (or the configured ``dump_dir``) gets the canonical
        ``postmortem_<reason>.json.p{index}`` name; an explicit file path
        is used as given plus the per-process suffix."""
        dest = path_or_dir if path_or_dir is not None else self.dump_dir
        if dest is None:
            return None
        if os.path.isdir(dest) or dest == self.dump_dir or \
                not os.path.splitext(dest)[1]:
            safe = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in reason)
            dest = os.path.join(dest, f"{BUNDLE_STEM}_{safe}.json")
        final = telemetry.per_process_path(dest)
        try:
            os.makedirs(os.path.dirname(final) or ".", exist_ok=True)
            tmp = f"{final}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self.bundle(reason), f)
            os.replace(tmp, final)  # atomic: readers never see a torn file
        except OSError:
            telemetry.counter("recorder.dump_errors").inc()
            return None
        telemetry.counter("recorder.dumps", reason=reason).inc()
        self.last_dump_path = final
        self.record("dump", reason=reason, path=final)
        return final

    def auto_dump(self, reason: str) -> Optional[str]:
        """Crash-path dump: fires only when ``dump_dir`` is configured and
        only once per distinct reason (retried failures must not thrash
        the disk while the run is dying)."""
        if self.dump_dir is None or reason in self._dumped_reasons:
            return None
        self._dumped_reasons.add(reason)
        return self.dump(self.dump_dir, reason=reason)

    def clear(self) -> None:
        self._ring.clear()
        self._dumped_reasons.clear()
        self.roofline = None
        self.last_dump_path = None


# -- module-level default (the recorder is default-ON, like telemetry) ------

_default = FlightRecorder()
telemetry.set_recorder(_default)


def get_recorder() -> FlightRecorder:
    rec = telemetry.get_recorder()
    return rec if isinstance(rec, FlightRecorder) else _default


def install(rec: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Swap (or with None: disable) the process flight recorder."""
    return telemetry.set_recorder(rec)


def configure(dump_dir: Optional[str] = None, **fingerprint) -> FlightRecorder:
    """Bind the crash-dump destination and/or fingerprint fields onto the
    live recorder (trainers call this with their checkpoint dir)."""
    rec = get_recorder()
    if dump_dir is not None:
        rec.dump_dir = str(dump_dir)
    if fingerprint:
        rec.set_fingerprint(**fingerprint)
    return rec


def auto_dump(reason: str) -> Optional[str]:
    """Module-level crash-path hook: dump the live recorder if (and only
    if) a dump_dir was configured; never raises."""
    rec = telemetry.get_recorder()
    if rec is None or not isinstance(rec, FlightRecorder):
        return None
    try:
        return rec.auto_dump(reason)
    except Exception:  # a dying run's forensics must not mask its error
        return None


# -- cross-process merge ------------------------------------------------------

def find_bundles(directory: str) -> List[str]:
    """Every postmortem bundle under ``directory`` (the ``.p*`` family)."""
    import glob as glob_lib

    return sorted(glob_lib.glob(
        os.path.join(directory, f"{BUNDLE_STEM}*.json*")))


def merge_bundles(paths: List[str]) -> dict:
    """Merge per-process bundles into one cross-process timeline: every
    ring event tagged with its origin pid, sorted by wall-clock time.
    Wall clocks across hosts are only roughly comparable — good enough to
    interleave second-scale windows, and the per-event pid keeps each
    process's exact order recoverable."""
    bundles = []
    for path in paths:
        try:
            with open(path) as f:
                b = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue  # a torn or half-written sibling must not kill the merge
        b["_path"] = path
        bundles.append(b)
    events = []
    for b in bundles:
        pid = b.get("process_index", 0)
        for ev in b.get("events", []):
            events.append(dict(ev, pid=pid))
    events.sort(key=lambda e: e.get("time", 0.0))
    trace_ids: List[str] = []
    for b in bundles:
        for tid in b.get("last_trace_ids", []):
            if tid not in trace_ids:
                trace_ids.append(tid)
    return {
        "bundles": [{
            "path": b["_path"],
            "reason": b.get("reason"),
            "process_index": b.get("process_index", 0),
            "unix_time": b.get("unix_time"),
            "git_sha": b.get("git_sha"),
            "fingerprint": b.get("fingerprint", {}),
            "alerts": [e for e in b.get("events", [])
                       if e.get("kind") == "alert"],
            "rollouts": [e for e in b.get("events", [])
                         if e.get("kind") == "rollout"],
            "trends": [e for e in b.get("events", [])
                       if e.get("kind") == "trend"],
            "fleet": (b.get("digests") or {}).get("fleet"),
        } for b in bundles],
        "processes": sorted({b.get("process_index", 0) for b in bundles}),
        "last_trace_ids": trace_ids,
        "events": events,
        "rows": [dict(row, pid=b.get("process_index", 0))
                 for b in bundles for row in b.get("rows", [])],
    }


def render_timeline(merged: dict, limit: int = 60) -> str:
    """Human rendering of a merged timeline: bundle headers, then the
    newest ``limit`` events as one pid-tagged line each."""
    out = [f"# postmortem: {len(merged.get('bundles', []))} bundle(s), "
           f"processes {merged.get('processes', [])}"]
    for b in merged.get("bundles", []):
        sha = (b.get("git_sha") or "-")[:12]
        out.append(f"  p{b.get('process_index', 0)} reason={b.get('reason')} "
                   f"sha={sha} {b.get('path')}")
        for alert in b.get("alerts", []):
            f = alert.get("fields", {})
            out.append(f"    ALERT {f.get('slo', '?')}: "
                       f"{f.get('message', '')}")
        for ev in b.get("rollouts", []):
            f = ev.get("fields", {})
            desc = " ".join(f"{k}={v}" for k, v in f.items()
                            if k != "action")
            out.append(f"    ROLLOUT {f.get('action', '?')}: {desc}")
        for ev in b.get("trends", []):
            f = ev.get("fields", {})
            state = "resolved" if f.get("resolved") else "active"
            out.append(f"    TREND {f.get('trend', '?')} [{state}]: "
                       f"{f.get('message', '')}")
        fleet = b.get("fleet")
        if isinstance(fleet, dict) and "error" not in fleet:
            out.append(f"    FLEET replicas={len(fleet.get('replicas', []))}"
                       f" requests={fleet.get('requests', 0)}"
                       f" sheds={fleet.get('sheds', 0)}"
                       f" requeued={fleet.get('requeued', 0)}"
                       f" version_skew={fleet.get('version_skew', 0)}")
    if merged.get("last_trace_ids"):
        out.append("last traces: " +
                   ", ".join(merged["last_trace_ids"][:8]))
    events = merged.get("events", [])
    shown = events[-limit:]
    if len(events) > len(shown):
        out.append(f"... {len(events) - len(shown)} older events elided ...")
    for ev in shown:
        t = time.strftime("%H:%M:%S", time.localtime(ev.get("time", 0)))
        fields = ev.get("fields", {})
        if ev.get("kind") == "span":
            desc = (f"span {fields.get('name')} "
                    f"{1e3 * fields.get('dur_s', 0):.1f}ms "
                    f"{fields.get('labels') or ''}")
        else:
            desc = " ".join(f"{k}={v}" for k, v in fields.items())
        out.append(f"{t} p{ev.get('pid', 0)} [{ev.get('kind')}] {desc}")
    return "\n".join(out)


__all__ = [
    "FlightRecorder", "DEFAULT_CAPACITY", "BUNDLE_STEM",
    "get_recorder", "install", "configure", "auto_dump",
    "find_bundles", "merge_bundles", "render_timeline",
]
