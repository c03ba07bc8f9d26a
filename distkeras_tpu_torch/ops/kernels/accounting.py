"""The work a hand-written kernel's launch does, for the measurement plane.

The kernels launch through ``ctypes``, so no ``TorchDispatchMode`` (and
so neither ``torch.utils.flop_counter.FlopCounterMode`` nor the op
inventory of :mod:`distkeras_tpu_torch.profiling.cost_model`) sees them.
Each wrapper therefore reports a launch here with its FLOPs, its bytes
and a callable that reruns its plain version; listeners
(:func:`distkeras_tpu_torch.observability.count_flops`, the op inventory)
subscribe with :func:`listen`. With no listener a report costs one list
test.

Each formula is the FlopCounterMode count of the kernel's plain version
on the same inputs, so that one call counts the same on the card (the
kernel) and on the CPU (the plain version, whose aten ops the counter
sees). That is also the JAX package's convention for the same call: it
counts every grid cell of a Pallas body, masked causal blocks included,
so a causal attention counts the full ``t x t`` square.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch


class KernelCall(NamedTuple):
    """One launch: ``plain(*inputs)`` reruns the plain version (on meta
    copies of the inputs, in the op inventory's source view)."""

    name: str
    flops: float
    bytes_moved: float
    inputs: tuple
    plain: Callable


#: the active listeners, innermost last
_listeners: list = []


def active() -> bool:
    """Whether any listener is subscribed (a wrapper reports only then)."""
    return bool(_listeners)


@contextlib.contextmanager
def listen(fn: Callable[[KernelCall], None]):
    """Call ``fn(call)`` for every kernel launch inside the block."""
    _listeners.append(fn)
    try:
        yield
    finally:
        _listeners.remove(fn)


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def note(name: str, flops: float, bytes_moved: float, inputs: tuple,
         plain: Callable) -> None:
    """Report one launch to every listener."""
    call = KernelCall(name, float(flops), float(bytes_moved), inputs, plain)
    for fn in list(_listeners):
        fn(call)


# -- the formulas (each the plain version's FlopCounterMode count) ----------

def attention_flops(b: int, tq: int, tk: int, h: int, d: int,
                    products: int) -> float:
    """``products`` ``[tq, tk] x d`` products a (batch, head), 2 FLOPs a
    multiply-add: the forward has two (q.k, p.v), dq three (q.k, dout.v,
    ds.k), dk/dv four (q.k, dout.v, p.dout, ds.q)."""
    return 2.0 * products * b * h * tq * tk * d


def matmul_flops(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


#: wrapper name -> fragments of the CUDA symbols its launches run (what a
#: profiler trace names): the measurement plane joins the two
KERNEL_SYMBOLS = {
    "flash_attention_fwd": ("flash_fwd_",),
    "flash_attention_bwd_dq": ("flash_bwd_dq_",),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv_",),
    "paged_flash_attention": ("paged_logits_kernel", "paged_values_kernel"),
    "int8_matmul_dequant": ("int8_matmul_sm90",),
    "group_norm_fwd": ("gn_fwd_kernel",),
    "group_norm_bwd": ("gn_bwd_kernel",),
}


def wrapper_of(symbol: str):
    """The wrapper whose kernel a CUDA symbol is, or None."""
    for name, fragments in KERNEL_SYMBOLS.items():
        if any(f in symbol for f in fragments):
            return name
    return None
