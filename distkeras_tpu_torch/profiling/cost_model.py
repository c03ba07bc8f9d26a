"""Per-op cost inventory of one call (port of
``distkeras_tpu/profiling/cost_model.py``).

The JAX module walks a compiled executable's HLO text. Eager torch has
no such text, so the inventory here runs the call once under a
``TorchDispatchMode`` and keeps one row per aten op as it is dispatched:

- FLOPs from torch's formula registry
  (``torch.utils.flop_counter``) with the JAX convention's formulas of
  :func:`distkeras_tpu_torch.observability.flop_formulas`: matmul and
  convolution work only (2 a multiply-add), so the inventory's total is
  :func:`~distkeras_tpu_torch.observability.count_flops`' number;
- bytes: each tensor input read once and each output written once
  (shape arithmetic, not DMA counters); views and allocations move none
  and get no row;
- source: the module path the op ran under
  (``torch.utils.module_tracker``), forward or backward.

Each hand-written kernel's launch is ONE row (opcode ``"kernel"``, its
formula's FLOPs and bytes), as the JAX inventory keeps a fusion whole;
no dispatch mode sees the kernel itself, so its wrapper reports it
(:mod:`distkeras_tpu_torch.ops.kernels.accounting`).
:func:`source_inventory` is the same function with each kernel row
replaced by its plain version's aten rows (rerun on meta tensors: shapes
only, no device work), so ``op_inventory / source_inventory`` FLOPs is
the share of the model's compute the kernel-path table attributes. On
the CPU no kernel launches and the two inventories are equal.

Never raises: a failure comes back as a typed empty inventory
(``available=False``) and is counted once a process
(``profile.op.inventory_unavailable``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distkeras_tpu_torch import telemetry

_DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred",
}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _DTYPE_NAMES[getattr(torch, _name)] = \
            "f8e4m3fn" if "e4m3" in _name else "f8e5m2"

#: metadata queries the dispatch mode passes through uncounted
#: (FlopCounterMode's list)
_QUERIES = frozenset(
    getattr(torch.ops.aten, op).default for op in (
        "is_contiguous", "is_strides_like_format",
        "is_non_overlapping_and_dense", "size", "sym_size", "stride",
        "sym_stride", "storage_offset", "sym_storage_offset", "numel",
        "sym_numel", "dim") if hasattr(torch.ops.aten, op))

#: allocations: no data moved, no row
_ALLOC = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                    "new_empty_strided", "empty_permuted"})


@dataclass
class OpCost:
    """One costed aten op (or one hand-written kernel's launch)."""
    name: str
    opcode: str
    flops: float
    bytes_accessed: float
    output_bytes: float
    dtype: str = "f32"
    source: str = ""
    fusion_ops: Tuple[str, ...] = ()
    count: int = 1  # >1 after by-source grouping

    @property
    def intensity(self) -> Optional[float]:
        """FLOPs per byte (None for pure data movement)."""
        if self.bytes_accessed <= 0:
            return None
        return self.flops / self.bytes_accessed


@dataclass
class OpInventory:
    """Typed inventory of one call's ops. ``available=False`` is the
    no-inventory result: zero rows and a note, never a made-up table.
    (The JAX inventory's ``xla_*`` aggregates and while-loop floor have
    no counterpart: an eager call has no cost analysis and no loop left
    uncounted.)"""
    rows: List[OpCost] = field(default_factory=list)
    available: bool = True
    note: str = ""

    @property
    def total_flops(self) -> float:
        return sum(r.flops for r in self.rows)

    @property
    def total_bytes(self) -> float:
        return sum(r.bytes_accessed for r in self.rows)

    def by_source(self) -> List[OpCost]:
        """Rows aggregated by (opcode, module source), most FLOPs first."""
        groups: Dict[Tuple[str, str], OpCost] = {}
        for r in self.rows:
            key = (r.opcode, r.source)
            g = groups.get(key)
            if g is None:
                groups[key] = OpCost(
                    name=r.source or r.opcode, opcode=r.opcode,
                    flops=r.flops, bytes_accessed=r.bytes_accessed,
                    output_bytes=r.output_bytes, dtype=r.dtype,
                    source=r.source, fusion_ops=r.fusion_ops, count=1)
            else:
                g.flops += r.flops
                g.bytes_accessed += r.bytes_accessed
                g.output_bytes += r.output_bytes
                g.count += 1
        return sorted(groups.values(), key=lambda g: -g.flops)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _is_view(func) -> bool:
    """Whether ``func`` returns a view of an input (no bytes moved);
    in-place ops alias an input too but write it."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


class _InventoryMode(TorchDispatchMode):
    """Records an :class:`OpCost` for each aten op and each kernel launch
    (``source=True``: each launch's plain version instead)."""

    def __init__(self, source: bool):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        from torch.utils.module_tracker import ModuleTracker

        from distkeras_tpu_torch import observability

        self.registry = FlopCounterMode(
            display=False,
            custom_mapping=observability.flop_formulas()).flop_registry
        self.tracker = ModuleTracker()
        self.source = source
        self.rows: List[OpCost] = []

    def where(self) -> str:
        names = [p for p in self.tracker.parents if p != "Global"]
        return max(names, key=len) if names else ""

    def on_kernel(self, call) -> None:
        if self.source:
            # the plain version's ops, on shapes alone
            call.plain(*(t.to("meta") if isinstance(t, torch.Tensor)
                         else t for t in call.inputs))
            return
        self.rows.append(OpCost(
            name=call.name, opcode="kernel", flops=call.flops,
            bytes_accessed=call.bytes_moved, output_bytes=0.0,
            dtype=_DTYPE_NAMES.get(call.inputs[0].dtype, "f32"),
            source=self.where(), fusion_ops=(call.name,)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        packet = func._overloadpacket
        if packet not in self.registry:
            # as FlopCounterMode: a decomposable op is costed by its parts
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = packet.__name__
        if name in _ALLOC or _is_view(func):
            return out
        formula = self.registry.get(packet)
        flops = float(formula(*args, **kwargs, out_val=out)) if formula \
            else 0.0
        out_b = _nbytes(out)
        first = next(_tensors(out), None)
        self.rows.append(OpCost(
            name=func._schema.name, opcode=name, flops=flops,
            bytes_accessed=float(_nbytes((args, kwargs)) + out_b),
            output_bytes=float(out_b),
            dtype=_DTYPE_NAMES.get(first.dtype, "f32") if first is not None
            else "f32", source=self.where()))
        return out


_inventory_noted = False


def _note_unavailable(note: str) -> OpInventory:
    """Once-a-process counter and a typed empty inventory."""
    global _inventory_noted
    if not _inventory_noted:
        _inventory_noted = True
        telemetry.counter("profile.op.inventory_unavailable").inc()
    return OpInventory(rows=[], available=False, note=note)


def _inventory(source: bool, fn, args, kwargs) -> OpInventory:
    from distkeras_tpu_torch.ops.kernels import accounting

    try:
        mode = _InventoryMode(source)
        with mode.tracker, mode, accounting.listen(mode.on_kernel):
            fn(*args, **kwargs)
    except Exception as exc:  # a boundary: report, never raise
        return _note_unavailable(f"inventory run failed: {exc!r}")
    if not mode.rows:
        return _note_unavailable("no costed ops in the call")
    return OpInventory(rows=mode.rows)


def op_inventory(fn, *args, **kwargs) -> OpInventory:
    """Costed op inventory of one call of ``fn`` (run once; a train step
    takes its step). Hand-written kernels are one row each. Never
    raises."""
    return _inventory(False, fn, args, kwargs)


def source_inventory(fn, *args, **kwargs) -> OpInventory:
    """The inventory of the same call with every kernel replaced by its
    plain version's ops (the coverage denominator). Never raises."""
    return _inventory(True, fn, args, kwargs)
