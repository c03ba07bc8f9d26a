"""Mixed-precision policy resolution (port of ``distkeras_tpu/precision.py``).

Only the policies the serving slice needs are ported: ``None`` (the
model's own dtype), ``"f32"`` and ``"bf16"``. The quantized policies
(``"int8"``, ``"fp8-sim"``) come with the int8 matmul kernel.
"""

from __future__ import annotations

import torch

_POLICY_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def resolve(precision, dtype: torch.dtype) -> torch.dtype:
    """The compute dtype of a model whose ``precision`` field is
    ``precision`` and whose ``dtype`` field is ``dtype``."""
    if precision is None:
        return dtype
    if precision in _POLICY_DTYPES:
        return _POLICY_DTYPES[precision]
    if precision in ("int8", "fp8-sim"):
        raise NotImplementedError(
            f"precision={precision!r} is not ported yet (ROADMAP.md Queue "
            f"A, 'Precision and accounting', with the int8 matmul kernel)")
    raise ValueError(
        f"unknown precision {precision!r}; expected None, 'f32' or 'bf16'")
