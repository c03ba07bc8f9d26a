"""Exporters (port of ``distkeras_tpu/health/export.py``): telemetry
rows/snapshots → Prometheus text + Chrome traces.

Pure format conversion, no framework and no I/O beyond the explicit ``write_*``
helpers, so the CLI, the benchmark summariser, and a scrape-style sidecar
can all share one implementation. Two inputs are accepted everywhere:

- **rows** — the JSONL row dicts ``MetricsRegistry.rows()`` /
  ``load_jsonl`` produce (``{"kind": "counter", "name": ..., ...}``);
- **snapshots** — the wire shape the ``metrics-snapshot`` endpoint returns
  (kind-grouped dicts keyed ``name{label=value,...}``), converted back to
  rows by :func:`snapshot_to_rows`.

Prometheus mapping: counters/gauges map 1:1 (names sanitised to the
``[a-zA-Z_:][a-zA-Z0-9_:]*`` charset); bounded histograms are exposed as
Prometheus *summaries* (``quantile`` labels from the kept p50/p95 plus
``_sum``/``_count``) because the registry stores percentiles-of-a-ring,
not cumulative buckets. Span events are skipped (they are trace data —
use :func:`chrome_trace`).

Chrome mapping: each span event becomes a complete event (``"ph": "X"``)
with microsecond ``ts``/``dur``; one synthetic ``tid`` per distinct
(name, labels) series keeps concurrent series on separate tracks in
``chrome://tracing`` / Perfetto.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Iterable, List

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_KEY_RE = re.compile(r"^(?P<name>[^{]+)(?:\{(?P<labels>.*)\})?$")


def _parse_key(key: str) -> tuple:
    """``"name{k=v,k2=v2}"`` → ``("name", {"k": "v", "k2": "v2"})``.
    Inverse of telemetry's ``_full_name`` (label values round-trip as
    strings; Prometheus/trace output stringifies them anyway)."""
    m = _KEY_RE.match(key)
    if not m:
        return key, {}
    labels: Dict[str, Any] = {}
    raw = m.group("labels")
    if raw:
        for part in raw.split(","):
            k, _, v = part.partition("=")
            labels[k] = v
    return m.group("name"), labels


def snapshot_to_rows(snapshot: dict) -> List[dict]:
    """Flatten a ``metrics-snapshot`` payload back into JSONL-style rows."""
    rows: List[dict] = []
    for key, value in snapshot.get("counters", {}).items():
        name, labels = _parse_key(key)
        rows.append({"kind": "counter", "name": name, "labels": labels,
                     "value": value})
    for key, value in snapshot.get("gauges", {}).items():
        name, labels = _parse_key(key)
        rows.append({"kind": "gauge", "name": name, "labels": labels,
                     "value": value})
    for key, stats in snapshot.get("histograms", {}).items():
        name, labels = _parse_key(key)
        rows.append({"kind": "histogram", "name": name, "labels": labels,
                     **stats})
    rows.extend(snapshot.get("spans", []))
    return rows


def _prom_name(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_labels(labels: Dict[str, Any], extra: Dict[str, str] = None) -> str:
    merged = {str(k): str(v) for k, v in (labels or {}).items()}
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    def esc(v: str) -> str:
        return v.replace("\\", "\\\\").replace('"', '\\"').replace(
            "\n", "\\n")
    inner = ",".join(f'{_prom_name(k)}="{esc(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _prom_num(v: Any) -> str:
    if v is None:
        return "NaN"
    return repr(float(v)) if isinstance(v, float) else str(v)


def rows_to_prometheus(rows: Iterable[dict]) -> str:
    """Render rows in the Prometheus text exposition format (version 0.0.4).
    Span rows are skipped; one ``# TYPE`` line is emitted per metric name."""
    by_name: Dict[str, List[dict]] = {}
    kinds: Dict[str, str] = {}
    for row in rows:
        if row.get("kind") == "span":
            continue
        name = _prom_name(row["name"])
        by_name.setdefault(name, []).append(row)
        kinds[name] = row["kind"]
    lines: List[str] = []
    for name in sorted(by_name):
        kind = kinds[name]
        if kind == "histogram":
            lines.append(f"# TYPE {name} summary")
            for row in by_name[name]:
                labels = row.get("labels") or {}
                for q, field in (("0.5", "p50"), ("0.95", "p95")):
                    lines.append(
                        f"{name}{_prom_labels(labels, {'quantile': q})} "
                        f"{_prom_num(row.get(field))}")
                lines.append(f"{name}_sum{_prom_labels(labels)} "
                             f"{_prom_num(row.get('sum', 0.0))}")
                lines.append(f"{name}_count{_prom_labels(labels)} "
                             f"{_prom_num(row.get('count', 0))}")
        else:
            lines.append(f"# TYPE {name} "
                         f"{'counter' if kind == 'counter' else 'gauge'}")
            for row in by_name[name]:
                lines.append(f"{name}{_prom_labels(row.get('labels'))} "
                             f"{_prom_num(row.get('value'))}")
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot_to_prometheus(snapshot: dict) -> str:
    return rows_to_prometheus(snapshot_to_rows(snapshot))


def chrome_trace(rows: Iterable[dict], pid: int = 0) -> dict:
    """Span rows → a Chrome/Perfetto trace object (counters/gauges are
    skipped — they belong in the Prometheus view). ``ts`` keeps the
    registry's monotonic origin; within one process events line up.

    Merged multi-process streams (collector.merged_rows) carry a ``pid``
    per row, which becomes the Chrome process lane; rows without one fall
    back to the ``pid`` argument. Traced spans carry their
    trace_id/span_id/parent_id into ``args`` so a Perfetto query (or the
    tests) can follow one trace_id across process lanes."""
    tids: Dict[tuple, int] = {}
    events: List[dict] = []
    for row in rows:
        if row.get("kind") != "span":
            continue
        labels = row.get("labels") or {}
        series = (row["name"], tuple(sorted(
            (str(k), str(v)) for k, v in labels.items())))
        tid = tids.setdefault(series, len(tids))
        args = {str(k): v for k, v in labels.items()}
        for key in ("trace_id", "span_id", "parent_id"):
            if key in row:
                args[key] = row[key]
        events.append({
            "name": row["name"], "ph": "X", "cat": "telemetry",
            "ts": float(row["t0"]) * 1e6,
            "dur": float(row["dur_s"]) * 1e6,
            "pid": int(row.get("pid", pid)), "tid": tid,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, rows: Iterable[dict]) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(rows), f)
    return path
