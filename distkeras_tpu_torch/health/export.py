"""Metric-key parsing (port of ``_parse_key`` of
``distkeras_tpu/health/export.py``; its Prometheus and Chrome-trace
exporters are ROADMAP.md Queue A, item 17)."""

from __future__ import annotations

import re
from typing import Any, Dict

_KEY_RE = re.compile(r"^(?P<name>[^{]+)(?:\{(?P<labels>.*)\})?$")


def _parse_key(key: str) -> tuple:
    """``"name{k=v,k2=v2}"`` → ``("name", {"k": "v", "k2": "v2"})``.
    Inverse of telemetry's ``_full_name`` (label values round-trip as
    strings)."""
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
