"""Device memory accounting (port of ``observability.hbm_stats``)."""

from __future__ import annotations

from typing import Optional

import torch

from distkeras_tpu_torch import telemetry


def hbm_stats(device=None) -> Optional[dict]:
    """Live device-memory usage of one CUDA device, published as the
    telemetry gauges ``observability.hbm_{peak,allocated,limit}_bytes``.

    Returns ``{"peak_bytes", "allocated_bytes", "limit_bytes"}`` or None
    on the CPU (no allocator to ask). ``limit_bytes`` is the card's total
    memory from ``torch.cuda.mem_get_info``; the other two are the
    caching allocator's counters."""
    if device is None or torch.device(device).type != "cuda":
        return None
    device = torch.device(device)
    _free, total = torch.cuda.mem_get_info(device)
    stats = torch.cuda.memory_stats(device)
    out = {"peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
           "allocated_bytes": int(stats.get("allocated_bytes.all.current",
                                            0)),
           "limit_bytes": int(total)}
    for key, value in out.items():
        telemetry.gauge(f"observability.hbm_{key}").set(float(value))
    return out
