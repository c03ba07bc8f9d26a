"""Opt-in measured op timing through ``torch.profiler`` (port of
``distkeras_tpu/profiling/capture.py``).

Never default-on: the profiler perturbs the steps it measures. The
capture runs a step N times under ``torch.profiler.profile(activities=
[CPU, CUDA])`` and reads ``key_averages()``: each device kernel's time
(the hand-written kernels appear under their CUDA names, joined to their
wrappers by :data:`~distkeras_tpu_torch.ops.kernels.accounting.KERNEL_SYMBOLS`),
each aten op's self device time (the kernels it launched itself), and
the device's busy share of the window (kernel time over wall time). The
JAX module's varint xplane walker has no counterpart: the profiler
hands the events over.

Off the card, or when the trace holds no device kernel, the condition is
counted once (``profile.op.capture_unavailable``) and a typed empty table
comes back (``available=False``); nothing is measured on the CPU.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from distkeras_tpu_torch import telemetry


@dataclass
class OpTimeTable:
    """Per-step measured device seconds.

    - ``seconds``: device kernel name -> seconds a step;
    - ``ops``: aten op name (``"aten::mm"``) -> self device seconds a step;
    - ``wall_s``: wall seconds a step; ``busy_share``: kernel time over
      wall time (None when unavailable).
    """
    seconds: Dict[str, float] = field(default_factory=dict)
    available: bool = True
    note: str = ""
    steps: int = 0
    ops: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, float] = field(default_factory=dict)
    wall_s: float = 0.0
    busy_share: Optional[float] = None

    def total(self) -> float:
        return sum(self.seconds.values())

    def kernels(self) -> Dict[str, float]:
        """Hand-written kernel wrapper -> device seconds a step (the
        kernels this capture saw)."""
        from distkeras_tpu_torch.ops.kernels import accounting

        out: Dict[str, float] = {}
        for name, s in self.seconds.items():
            wrapper = accounting.wrapper_of(name)
            if wrapper is not None:
                out[wrapper] = out.get(wrapper, 0.0) + s
        return out

    def measured(self) -> Dict[str, float]:
        """Seconds a step keyed by the op inventory's row names (aten ops
        and kernel wrappers): ``build_report``'s ``measured=``."""
        return {**self.ops, **self.kernels()}

    def top(self, n: int = 5) -> list:
        """The ``n`` device kernels with the most time: ``[(name,
        seconds a step, launches a step)]``."""
        ranked = sorted(self.seconds.items(), key=lambda kv: -kv[1])[:n]
        return [(k, s, self.counts.get(k, 0.0)) for k, s in ranked]


_capture_noted = False


def _note_unavailable(note: str, steps: int = 0) -> OpTimeTable:
    global _capture_noted
    if not _capture_noted:
        _capture_noted = True
        telemetry.counter("profile.op.capture_unavailable").inc()
    return OpTimeTable(available=False, note=note, steps=steps)


def _sync(out) -> None:
    from distkeras_tpu_torch.observability import _tensors

    for t in _tensors(out):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return
    torch.cuda.synchronize()


def capture_op_times(step_fn: Callable[[], object], steps: int = 3,
                     logdir: Optional[str] = None) -> OpTimeTable:
    """Run ``step_fn`` (a zero-argument closure over warmed-up work)
    ``steps`` times under the profiler and return per-step device seconds
    per kernel and per op, and the busy share. Each step's output is
    synchronized on before the window closes. ``logdir`` also keeps the
    Chrome trace (``trace.json``) there. Opt-in only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = max(1, int(steps))
    if not torch.cuda.is_available():
        return _note_unavailable(
            "no CUDA device: measured op timing needs the card", steps)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                _sync(step_fn())
            wall = time.perf_counter() - t0
        events = prof.key_averages()
    except (RuntimeError, AssertionError) as exc:
        return _note_unavailable(f"profiler trace failed: {exc!r}", steps)
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    # the device timeline also mirrors user annotations (such as
    # torch.optim's ``Optimizer.step#AdamW.step``) that enclose kernels
    # already counted: keep the keys that are not host events
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    seconds, counts, ops = {}, {}, {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.key not in host:
            seconds[e.key] = e.self_device_time_total / 1e6 / steps
            counts[e.key] = e.count / steps
        elif e.device_type == DeviceType.CPU and e.key.startswith("aten::") \
                and e.self_device_time_total > 0:
            ops[e.key] = e.self_device_time_total / 1e6 / steps
    if not seconds:
        return _note_unavailable(
            "no device kernel in the trace (the profiler recorded no CUDA "
            "activity)", steps)
    busy = sum(seconds.values()) * steps
    return OpTimeTable(seconds=seconds, steps=steps, ops=ops, counts=counts,
                       wall_s=wall / steps, busy_share=busy / wall)
