"""Observability (port of ``distkeras_tpu/observability.py``): the card's
peak table, an analytic FLOPs counter, MFU, a calibration probe, step
timers, a profiler context and device memory accounting.

The compute side of the measurement plane; ``telemetry.py`` is the
system side. Where the JAX module reads a compiled XLA executable, the
port reads what PyTorch has: ``torch.utils.flop_counter`` for FLOPs
(plus the hand-written kernels' own formulas,
:mod:`~distkeras_tpu_torch.ops.kernels.accounting`), a captured
``torch.cuda.CUDAGraph`` for "compiled" memory, ``torch.profiler`` for
traces. Nothing here measures the CPU as if it were the card: the
peaks, the calibration and MFU are None off the card.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch

from distkeras_tpu_torch import telemetry

# Peak dense FLOP/s of one card by compute dtype, from NVIDIA's H100 data
# sheets (dense rates, no sparsity; the sheets print the sparse rate for
# the tensor-core types, twice the dense one). "f32" is the CUDA cores'
# FP32 rate, "tf32" the tensor cores' rate on float32 operands. The rates
# assume the card's full power limit (700 W for the SXM part); a card set
# lower runs slower under load, so a measured rate is written beside the
# card's name and power limit.
_H100_SXM = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12,
             "fp8": 1979e12, "int8": 1979e12}
_H100_PCIE = {"f32": 51e12, "tf32": 378e12, "bf16": 756e12,
              "fp8": 1513e12, "int8": 1513e12}
_H100_NVL = {"f32": 60e12, "tf32": 417.5e12, "bf16": 835.5e12,
             "fp8": 1670.5e12, "int8": 1670.5e12}

#: ``torch.cuda.get_device_name()`` substring (lower case) -> {dtype: peak
#: FLOP/s}; the first key that matches wins, so the PCIe and NVL parts
#: come before the bare "h100" (the SXM part, "NVIDIA H100 80GB HBM3")
PEAK_FLOPS = {
    "h100 pcie": _H100_PCIE,
    "h100 nvl": _H100_NVL,
    "h100 80gb hbm3": _H100_SXM,
    "h100": _H100_SXM,
}

def device_name(device=None) -> str:
    """Lower-case CUDA device name of ``device`` (``cuda:0`` when None and
    a card is present); "" for the CPU or no card."""
    if device is None:
        if not torch.cuda.is_available():
            return ""
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type != "cuda":
        return ""
    return torch.cuda.get_device_name(device).lower()


def device_table_entry(table: dict, device):
    """The value of the first key of ``table`` (a device-name substring)
    that ``device``'s CUDA name holds; None for the CPU or no match."""
    kind = device_name(device)
    if not kind:
        return None
    for key, value in table.items():
        if key in kind:
            return value
    return None


def device_peak_flops(device=None, dtype: str = "bf16") -> Optional[float]:
    """Peak FLOP/s of one card for a compute dtype (``"f32" | "tf32" |
    "bf16" | "fp8" | "int8"``); None for an unknown card or the CPU."""
    columns = next(iter(PEAK_FLOPS.values()))
    if dtype not in columns:
        raise ValueError(f"unknown peak-table dtype {dtype!r}; expected one "
                         f"of {tuple(columns)}")
    peaks = device_table_entry(PEAK_FLOPS, device)
    return None if peaks is None else peaks[dtype]


_cost_analysis_noted = False


def _note_cost_unavailable() -> None:
    global _cost_analysis_noted
    if not _cost_analysis_noted:
        _cost_analysis_noted = True
        telemetry.counter("observability.cost_analysis_unavailable").inc()


def compiled_flops(compiled) -> Optional[float]:
    """FLOPs of one replay of a captured computation: the ``flops`` its
    owner recorded for it (from :func:`count_flops` of the captured
    function), since a ``torch.cuda.CUDAGraph`` carries no cost analysis.
    None when there is none to read, counted once a process
    (``observability.cost_analysis_unavailable``)."""
    flops = getattr(compiled, "flops", None)
    if flops:
        return float(flops)
    _note_cost_unavailable()
    return None


# -- the analytic FLOPs counter ----------------------------------------------

def _grad_input_flops(grad_input_shape, w_shape, groups) -> float:
    """The JAX package's count of a convolution's input gradient: XLA
    lowers it to a convolution over the (stride-dilated) output gradient
    whose output is the input, so every input position counts every tap
    (``observability._eqn_flops`` at JAX ``observability.py:102``)."""
    c_out, _, *taps = w_shape
    n = 1
    for s in grad_input_shape:
        n *= int(s)
    k = 1
    for s in taps:
        k *= int(s)
    return 2.0 * n * (c_out // groups) * k


def flop_formulas() -> dict:
    """FLOP formulas that replace or add to torch's registry, so that the
    count follows the JAX package's convention (``FlopCounterMode``'s
    ``custom_mapping``; each call makes fresh state):

    - ``convolution_backward``: the input gradient counts every tap at
      every input position (torch counts it at the output's positions,
      1/stride² as much for a strided convolution). An input that went
      through an explicit ``constant_pad_nd`` (the port pads flax's
      asymmetric "SAME" before the convolution) counts at its unpadded
      size, as JAX, whose convolution pads inside. The weight gradient
      counts as the forward, as both do;
    - ``_int_mm`` (no formula in torch's registry): 2 FLOPs a
      multiply-add, as ``mm``.
    """
    aten = torch.ops.aten
    padded = {}  # (data_ptr, shape) of a padded tensor -> (it, unpadded)

    def pad(x, pads, *rest, out_val=None, **kwargs):
        padded[(out_val.data_ptr(), tuple(out_val.shape))] = (
            out_val, tuple(x.shape))
        return 0

    def conv_backward(grad_out, x, w, bias_sizes, stride, padding, dilation,
                      transposed, output_padding, groups, output_mask,
                      out_val=None, **kwargs):
        flops = 0.0
        if output_mask[0]:
            if transposed:
                from torch.utils.flop_counter import conv_flop_count

                flops += conv_flop_count(tuple(grad_out.shape),
                                         tuple(w.shape), tuple(x.shape),
                                         transposed=False)
            else:
                hit = padded.get((x.data_ptr(), tuple(x.shape)))
                shape = hit[1] if hit is not None and hit[0] is not None \
                    else tuple(x.shape)
                flops += _grad_input_flops(shape, tuple(w.shape), groups)
        if output_mask[1]:
            from torch.utils.flop_counter import conv_flop_count

            flops += conv_flop_count(tuple(x.shape), tuple(w.shape),
                                     tuple(grad_out.shape))
        return int(flops)

    def int_mm(a, b, out_val=None, **kwargs):
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]

    for fn in (pad, conv_backward, int_mm):
        fn._get_raw = True  # FlopCounterMode passes the tensors themselves
    return {aten.constant_pad_nd: pad,
            aten.convolution_backward: conv_backward, aten._int_mm: int_mm}


class _KernelTally:
    """Sums the FLOPs of the hand-written kernels' launches (which no
    dispatch mode sees), by kernel name."""

    def __init__(self):
        self.flops = 0.0
        self.by_kernel: dict = {}

    def __call__(self, call) -> None:
        self.flops += call.flops
        self.by_kernel[call.name] = self.by_kernel.get(call.name, 0.0) \
            + call.flops


def count_flops(fn, *args, **kwargs) -> float:
    """Analytic matmul and convolution FLOPs (2 a multiply-add) of one
    call of ``fn`` on these arguments, as the JAX package counts them.

    The call runs (eagerly: torch has no trace without running) under
    ``torch.utils.flop_counter.FlopCounterMode`` with
    :func:`flop_formulas`, plus each hand-written kernel's formula for
    its launches (:mod:`~distkeras_tpu_torch.ops.kernels.accounting`): on
    the card the kernels run and report themselves; on the CPU their
    plain versions run as aten ops and are counted; both give one
    number. Elementwise FLOPs are not counted (MFU's definition)."""
    from torch.utils.flop_counter import FlopCounterMode

    from distkeras_tpu_torch.ops.kernels import accounting

    tally = _KernelTally()
    counter = FlopCounterMode(display=False, custom_mapping=flop_formulas())
    with counter, accounting.listen(tally):
        fn(*args, **kwargs)
    return float(counter.get_total_flops()) + tally.flops


# -- calibration -------------------------------------------------------------

#: Acceptance band of the calibration ratio (achieved / book bf16 peak of
#: a chained 16384^2 bf16 product, timed as MFU is). Set from the sweep
#: measured on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit
#: (``chip_smoke.py`` phase 25, PERF.md, PR 16): 16384^2 0.8525, 8192^2
#: 0.8198, 4096^2 0.8464 of 989 TFLOP/s (``bench_torch.py``'s own run of
#: the default shape: 0.8533). 0.75 bounds the default shape's
#: run-to-run spread while catching a timing fault that inflates MFU by
#: 1.13x or more (or a card throttled below its book rate); above 1.05
#: the FLOPs counter overcounts. The JAX package's (0.80, 1.05) came
#: from a TPU sweep and does not carry over. Callers refuse to report
#: MFU outside the band.
CAL_BAND = (0.75, 1.05)


def calibrate_peak(size: int = 16384, chain: int = 64, repeats: int = 3,
                   device=None) -> Optional[dict]:
    """Measure achieved bf16 matmul FLOP/s with the method MFU uses
    (analytic 2·MAC FLOPs; host clock around work that ends in
    ``torch.cuda.synchronize()``) and compare it with the peak table:
    ``chain`` chained ``[size, size]`` bf16 products by an identity
    matrix (``torch.matmul``; values stay bounded), median of
    ``repeats``. Returns ``{"achieved", "peak", "ratio"}`` FLOP/s and
    publishes them as gauges; None off the card or for a card the table
    does not know (nothing is measured then)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    peak = device_peak_flops(device, "bf16")
    if device.type != "cuda" or peak is None:
        return None
    x = torch.ones((size, size), dtype=torch.bfloat16, device=device)
    w = torch.eye(size, dtype=torch.bfloat16, device=device)

    def run():
        y = x
        for _ in range(chain):
            y = torch.matmul(y, w)
        return y

    flops = 2.0 * float(size) ** 3 * chain
    run()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    achieved = flops / dt
    telemetry.gauge("observability.achieved_flops").set(achieved)
    telemetry.gauge("observability.peak_flops").set(peak)
    telemetry.gauge("observability.calibration_ratio").set(achieved / peak)
    return {"achieved": achieved, "peak": peak, "ratio": achieved / peak}


def mfu(flops_per_step: float, step_time_s: float, num_chips: int = 1,
        peak_per_chip: Optional[float] = None,
        dtype: str = "bf16") -> Optional[float]:
    """Model FLOPs utilization in [0, 1]; None off the card or without a
    FLOPs count. ``dtype`` picks the peak-table column (a precision
    policy's ``mfu_dtype``) and labels the published gauge."""
    peak = peak_per_chip if peak_per_chip is not None \
        else device_peak_flops(dtype=dtype)
    if peak is None or not flops_per_step or step_time_s <= 0:
        return None
    value = flops_per_step / (step_time_s * peak * num_chips)
    telemetry.gauge("observability.mfu", dtype=dtype).set(value)
    telemetry.gauge("observability.flops_per_step").set(flops_per_step)
    return value


# -- memory ------------------------------------------------------------------

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


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def compiled_memory_bytes(graph, static_inputs=(),
                          static_outputs=()) -> Optional[dict]:
    """Memory of a captured ``torch.cuda.CUDAGraph``, the port's
    counterpart of an executable's ``memory_analysis()``:

    - ``temp_bytes``: the segments of the graph's private memory pool
      (``torch.cuda.memory._snapshot()``), where the captured work's
      intermediates live (a pool shared by several graphs counts whole);
    - ``argument_bytes`` / ``output_bytes``: the static input and output
      tensors the caller passes (a graph replays on fixed addresses);
    - ``generated_code_bytes``: 0 (a graph replays kernels already
      loaded; it generates no code).

    None (counted once, ``observability.cost_analysis_unavailable``) for
    anything that is not a captured graph on a card."""
    try:
        pool = graph.pool()
        segments = torch.cuda.memory._snapshot()["segments"]
        temp = sum(int(s["total_size"]) for s in segments
                   if tuple(s.get("segment_pool_id", ())) == tuple(pool))
    except (AttributeError, RuntimeError, KeyError, TypeError):
        _note_cost_unavailable()
        return None
    return {"temp_bytes": temp,
            "argument_bytes": sum(t.numel() * t.element_size()
                                  for t in _tensors(static_inputs)),
            "output_bytes": sum(t.numel() * t.element_size()
                                for t in _tensors(static_outputs)),
            "generated_code_bytes": 0}


# -- timing ------------------------------------------------------------------

def _sync(tree) -> None:
    """Wait for the device of the first tensor in ``tree`` (no-op for
    host tensors)."""
    for t in _tensors(tree):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        return


class StepTimer:
    """Wall-clock timing of steps, ending on device completion.

    Usage::
        timer = StepTimer()
        for _ in range(warmup): out = step(...)
        with timer.measure(steps):
            for _ in range(steps): out = step(...)
            torch.cuda.synchronize()
        timer.mean_step_s
    """

    def __init__(self):
        self.mean_step_s: Optional[float] = None
        self.total_s: Optional[float] = None
        self.steps = 0

    @contextlib.contextmanager
    def measure(self, steps: int):
        t0 = time.perf_counter()
        yield self
        self.total_s = time.perf_counter() - t0
        self.steps = steps
        # steps=0 measured nothing: no per-step mean
        self.mean_step_s = self.total_s / steps if steps > 0 else None


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """``torch.profiler`` trace around a block (host and, with a card,
    device activity), written to ``logdir`` by
    ``tensorboard_trace_handler`` as a Chrome trace (``*.pt.trace.json``;
    chrome://tracing, Perfetto or TensorBoard read it)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def time_threaded_steps(step_fn: Callable, state, batch, warmup: int = 2,
                        steps: int = 10) -> tuple:
    """Time a state-threading train step (``state, aux = step(state,
    batch)``): ``warmup + 1`` untimed steps, then ``steps`` back to back
    ending in a sync on the output's device. Returns ``(final_state,
    timer)``."""
    for _ in range(warmup + 1):
        state, aux = step_fn(state, batch)
    _sync(aux)
    timer = StepTimer()
    with timer.measure(steps):
        for _ in range(steps):
            state, aux = step_fn(state, batch)
        _sync(aux)
    return state, timer
