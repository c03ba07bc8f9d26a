"""Roofline classification of a costed op inventory (port of
``distkeras_tpu/profiling/roofline.py``).

An op needing F FLOPs and B bytes runs in at best ``max(F / peak,
B / bandwidth)``; its arithmetic intensity F/B against the ridge point
``peak / bandwidth`` says which term binds. Ops whose modeled time is
under the dispatch floor are latency-bound. Peaks come from
``observability.PEAK_FLOPS``, bandwidths from :data:`HBM_BANDWIDTH`
below, both matched on the CUDA device name.

The fix tags and the ``profile.op.*`` metric names are the JAX module's,
so the flight recorder's roofline digest (``health/recorder.py``
``set_roofline``) reads the same in both packages. The tags name the
port's kernels (``fix_registry``): ``"pallas-attention"`` is the flash
and paged attention kernels of ``ops/kernels/flash_attention.py``,
``"fp8-matmul"`` the int8 product of ``ops/kernels/int8_matmul.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from distkeras_tpu_torch import observability, telemetry
from distkeras_tpu_torch.profiling.cost_model import OpCost, OpInventory

#: CUDA device-name substring -> HBM bytes/s (NVIDIA's H100 data sheets:
#: SXM 3.35 TB/s, PCIe 2.0 TB/s, NVL 3.9 TB/s); matched like
#: ``observability.PEAK_FLOPS``, the PCIe and NVL parts first
HBM_BANDWIDTH = {
    "h100 pcie": 2.0e12,
    "h100 nvl": 3.9e12,
    "h100 80gb hbm3": 3.35e12,
    "h100": 3.35e12,
}

#: modeled times under this are dispatch overhead, not data or flops
LATENCY_FLOOR_S = 1e-6

_COLLECTIVES = frozenset({
    "all-reduce", "reduce-scatter", "all-gather", "all-to-all",
    "collective-permute"})

#: product-bearing opcodes: XLA's and torch's
_PRODUCTS = frozenset({"dot", "convolution", "mm", "addmm", "bmm",
                       "baddbmm", "convolution_backward", "_int_mm",
                       "_scaled_mm", "int8_matmul_dequant"})


def device_hbm_bandwidth(device=None) -> Optional[float]:
    """HBM bytes/s of one card; None for an unknown card or the CPU."""
    return observability.device_table_entry(HBM_BANDWIDTH, device)


def classify(flops: float, bytes_accessed: float, peak: float,
             bandwidth: float,
             latency_floor_s: float = LATENCY_FLOOR_S) -> str:
    """``"memory" | "compute" | "latency"`` for one op against one card's
    ceilings. Pure data movement (zero FLOPs) is memory-bound unless it
    is too small to cover dispatch."""
    t_compute = flops / peak if peak > 0 else 0.0
    t_memory = bytes_accessed / bandwidth if bandwidth > 0 else 0.0
    if max(t_compute, t_memory) < latency_floor_s:
        return "latency"
    if bytes_accessed <= 0:
        return "compute"
    intensity = flops / bytes_accessed
    ridge = peak / bandwidth
    return "compute" if intensity >= ridge else "memory"


def fix_tag(op: OpCost, bound: str) -> str:
    """The fix that would move this op: attention kernels, a narrower
    matmul, memory-layout work, or none."""
    hint = f"{op.source} {op.name} {' '.join(op.fusion_ops)}".lower()
    if op.opcode in _COLLECTIVES:
        return "comms-overlap"
    if ("attention" in hint or "softmax" in hint or "attn" in hint
            or "bhqk" in hint):
        return "pallas-attention"
    if bound == "compute" and (
            op.opcode in _PRODUCTS
            or any(f in _PRODUCTS for f in op.fusion_ops)):
        return "fp8-matmul"
    if bound == "memory":
        return "memory-layout"
    if bound == "latency":
        return "none-latency"
    return "none-at-roofline"


def fix_registry() -> dict:
    """Fix tag -> the port's kernel behind it (``ops/kernels``):
    ``{"module", "flag", "enabled"}``. The port's kernels have no
    ablation flag (a CUDA tensor goes to the kernel), so each is
    enabled and no row reports a kernel left off."""
    return {
        "pallas-attention": {
            "module": "distkeras_tpu_torch.ops.kernels.flash_attention",
            "flag": None, "enabled": True},
        "fp8-matmul": {
            "module": "distkeras_tpu_torch.ops.kernels.int8_matmul",
            "flag": None, "enabled": True},
    }


@dataclass
class RooflineRow:
    op: str           # grouped display name (module source or op name)
    opcode: str
    bound: str        # memory | compute | latency
    flops: float
    bytes_accessed: float
    intensity: Optional[float]
    est_time_s: float
    headroom_s: float  # time above the pure-compute roofline
    share: float       # est_time_s / report total
    fix: str
    count: int = 1
    measured: bool = False  # est_time_s from a profiler trace
    #: a kernel in the tree implements this fix but is switched off
    fix_available: bool = False

    def to_row(self) -> dict:
        return {"kind": "op", "op": self.op, "opcode": self.opcode,
                "bound": self.bound, "flops": self.flops,
                "bytes": self.bytes_accessed,
                "intensity": (None if self.intensity is None
                              else round(self.intensity, 3)),
                "est_time_s": self.est_time_s,
                "headroom_s": self.headroom_s,
                "share": round(self.share, 4), "fix": self.fix,
                "count": self.count, "measured": self.measured,
                "fix_available": self.fix_available}


@dataclass
class RooflineReport:
    rows: List[RooflineRow] = field(default_factory=list)  # ALL grouped ops
    available: bool = True
    note: str = ""
    dtype: str = "bf16"
    peak_flops: float = 0.0
    hbm_bandwidth: float = 0.0
    top_k: int = 8
    total_time_s: float = 0.0
    coverage: Optional[float] = None   # inventory flops / modeled flops
    measured_share: float = 0.0        # time fraction backed by a trace

    @property
    def ridge(self) -> float:
        """Ridge point, FLOPs/byte: intensity where compute takes over."""
        if self.hbm_bandwidth <= 0:
            return 0.0
        return self.peak_flops / self.hbm_bandwidth

    def top(self) -> List[RooflineRow]:
        """Top-k by headroom (then time): where a fix buys most time."""
        ranked = sorted(self.rows, key=lambda r: (-r.headroom_s,
                                                  -r.est_time_s, r.op))
        return ranked[:self.top_k]

    def digest(self) -> dict:
        """Small deterministic dict for the health status digest and the
        flight recorder's postmortem bundle."""
        out = {"dtype": self.dtype, "available": self.available}
        if not self.available:
            out["note"] = self.note
            return out
        if self.coverage is not None:
            out["coverage"] = round(self.coverage, 3)
        out["top"] = [{"op": r.op, "bound": r.bound,
                       "share": round(r.share, 4), "fix": r.fix,
                       "fix_available": r.fix_available}
                      for r in self.top()[:3]]
        return out

    def publish(self) -> None:
        """``profile.op.share`` gauges per top op, ``profile.op.coverage``,
        and the digest on the flight recorder if one is installed."""
        if self.available:
            for r in self.top():
                telemetry.gauge("profile.op.share", op=r.op.replace(
                    ",", ";"), bound=r.bound).set(r.share)
            if self.coverage is not None:
                telemetry.gauge("profile.op.coverage").set(self.coverage)
        rec = telemetry.get_recorder()
        if rec is not None and hasattr(rec, "set_roofline"):
            rec.set_roofline(self.digest())

    def render(self) -> str:
        """Fixed-width table, biggest headroom first."""
        if not self.available:
            return f"roofline: no cost model on this backend ({self.note})"
        lines = [
            f"roofline vs {self.dtype} peak {self.peak_flops/1e12:.1f} "
            f"TFLOP/s, HBM {self.hbm_bandwidth/1e9:.0f} GB/s "
            f"(ridge {self.ridge:.1f} FLOP/B)"
            + (f", coverage {self.coverage:.1%}"
               if self.coverage is not None else ""),
            f"{'op':<38}{'bound':>8}{'share':>7}{'AI':>9}"
            f"{'GFLOP':>9}{'MB':>9}  fix",
        ]
        for r in self.top():
            ai = "-" if r.intensity is None else f"{r.intensity:.1f}"
            src = "*" if r.measured else " "
            avail = " [kernel in-tree, off]" if r.fix_available else ""
            lines.append(
                f"{r.op[:37]:<38}{r.bound:>8}{r.share:>6.1%}{ai:>9}"
                f"{r.flops/1e9:>9.2f}{r.bytes_accessed/1e6:>9.2f}"
                f" {src}{r.fix}{avail}")
        lines.append("(* = measured time from a profiler trace; others "
                     "modeled from shapes, not DMA counters)")
        return "\n".join(lines)


def build_report(inventory: OpInventory,
                 dtype: str = "bf16",
                 peak_flops: Optional[float] = None,
                 hbm_bandwidth: Optional[float] = None,
                 device=None,
                 measured: Optional[Dict[str, float]] = None,
                 modeled_flops: Optional[float] = None,
                 top_k: int = 8) -> RooflineReport:
    """Classify an op inventory against one card's ceilings.

    ``peak_flops``/``hbm_bandwidth`` default to the card's table entries;
    without them (the CPU) the caller must pass reference ceilings or the
    report declines (``available=False``). ``measured`` maps row names to
    profiled seconds (``OpTimeTable.measured()``); a name several rows
    share (an aten op, a kernel launched once a layer) splits its time
    evenly over them. Measured rows rank by measured time, the rest by
    modeled time. ``modeled_flops`` is the total (``count_flops`` or the
    source inventory's) the coverage fraction is taken against.
    """
    if not inventory.available:
        return RooflineReport(available=False, note=inventory.note,
                              dtype=dtype, top_k=top_k)
    if peak_flops is None:
        peak_flops = observability.device_peak_flops(device, dtype=dtype)
    if hbm_bandwidth is None:
        hbm_bandwidth = device_hbm_bandwidth(device)
    if not peak_flops or not hbm_bandwidth:
        return RooflineReport(
            available=False, dtype=dtype, top_k=top_k,
            note="no peak/bandwidth table entry for this device; pass "
                 "explicit reference ceilings")
    measured = measured or {}
    rows_named: Dict[str, int] = {}
    for r in inventory.rows:
        if r.name in measured:
            rows_named[r.name] = rows_named.get(r.name, 0) + 1

    # group rows by (opcode, source), joining measured times first so a
    # grouped row's time is the sum of its members' times
    groups: Dict[tuple, dict] = {}
    for r in inventory.rows:
        key = (r.opcode, r.source)
        g = groups.setdefault(key, {
            "op": r.source or r.name, "opcode": r.opcode, "flops": 0.0,
            "bytes": 0.0, "count": 0, "measured_s": 0.0, "modeled_s": 0.0,
            "proto": r})
        g["flops"] += r.flops
        g["bytes"] += r.bytes_accessed
        g["count"] += 1
        t_model = max(r.flops / peak_flops,
                      r.bytes_accessed / hbm_bandwidth, LATENCY_FLOOR_S)
        if r.name in measured:
            g["measured_s"] += measured[r.name] / rows_named[r.name]
        else:
            g["modeled_s"] += t_model

    rows: List[RooflineRow] = []
    total_t = measured_t = 0.0
    for g in groups.values():
        total_t += g["measured_s"] + g["modeled_s"]
        measured_t += g["measured_s"]
    total_t = total_t or 1.0
    registry = fix_registry()
    for key in sorted(groups):
        g = groups[key]
        est = g["measured_s"] + g["modeled_s"]
        bound = classify(g["flops"], g["bytes"], peak_flops, hbm_bandwidth)
        intensity = (g["flops"] / g["bytes"]) if g["bytes"] > 0 else None
        headroom = max(0.0, est - g["flops"] / peak_flops)
        fix = fix_tag(g["proto"], bound)
        kernel = registry.get(fix)
        rows.append(RooflineRow(
            op=g["op"], opcode=g["opcode"], bound=bound,
            flops=g["flops"], bytes_accessed=g["bytes"],
            intensity=intensity, est_time_s=est, headroom_s=headroom,
            share=est / total_t, fix=fix,
            count=g["count"], measured=g["measured_s"] > 0,
            fix_available=bool(kernel) and not kernel["enabled"]))

    coverage = None
    if modeled_flops:
        coverage = inventory.total_flops / modeled_flops
    return RooflineReport(
        rows=rows, dtype=dtype, peak_flops=peak_flops,
        hbm_bandwidth=hbm_bandwidth, top_k=top_k, total_time_s=total_t,
        coverage=coverage, measured_share=measured_t / total_t)
