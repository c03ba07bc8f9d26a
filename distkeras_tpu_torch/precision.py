"""Mixed-precision policies (port of ``distkeras_tpu/precision.py``).

Only the policies with no quantization are ported: ``None`` (the model's
own dtype), ``"f32"`` and ``"bf16"``. Both keep float32 master weights
(the port's parameters are stored in float32 and cast at each call) and
have ``loss_scale == 1.0``, so the step engine applies no loss scaling.
The quantized policies (``"int8"``, ``"fp8-sim"``) and ``overflow_guard``
come with the int8 matmul kernel (ROADMAP.md Queue A, item 15).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """A named compute-precision contract (the JAX package's fields)."""

    name: str
    compute_dtype: torch.dtype
    quant: Optional[str] = None
    loss_scale: float = 1.0


_POLICIES = {"f32": PrecisionPolicy("f32", torch.float32),
             "bf16": PrecisionPolicy("bf16", torch.bfloat16)}


def _not_ported(precision):
    return NotImplementedError(
        f"precision={precision!r} is not ported yet (ROADMAP.md Queue A, "
        f"item 15, 'Precision and accounting', with the int8 matmul kernel)")


def get_policy(precision: Union[str, PrecisionPolicy, None]
               ) -> Optional[PrecisionPolicy]:
    """``None`` -> None; a policy passes through; a name -> its policy."""
    if precision is None or isinstance(precision, PrecisionPolicy):
        return precision
    if precision in _POLICIES:
        return _POLICIES[precision]
    if precision in ("int8", "fp8-sim"):
        raise _not_ported(precision)
    raise ValueError(
        f"unknown precision {precision!r}; expected None, 'f32' or 'bf16'")


def resolve(precision, dtype: torch.dtype) -> torch.dtype:
    """The compute dtype of a model whose ``precision`` field is
    ``precision`` and whose ``dtype`` field is ``dtype``."""
    policy = get_policy(precision)
    return dtype if policy is None else policy.compute_dtype


def current_scale(opt_state) -> None:
    """The live loss scale of an ``overflow_guard``-wrapped optimizer
    state; the guard is not ported, so always None (no scaling)."""
    return None
