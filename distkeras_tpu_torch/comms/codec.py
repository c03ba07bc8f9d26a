"""The affine quantization rule (port of the three helpers of
``distkeras_tpu/comms/codec.py``).

One scale rule serves the parameter-server wire codec (``lo=min``,
``hi=max``, ``levels=255``) and the in-step int8 quantizer of
:mod:`distkeras_tpu_torch.precision` (``lo=-amax``, ``hi=+amax``,
``levels=254``). The codecs themselves are not ported yet (ROADMAP.md
Queue A, item 13).
"""

from __future__ import annotations

import torch


def affine_qparams(lo, hi, levels: int):
    """Quantization step of an affine grid of ``levels + 1`` codes
    spanning ``[lo, hi]``."""
    return (hi - lo) / levels


def affine_quantize(a: torch.Tensor, lo, scale: torch.Tensor,
                    levels: int) -> torch.Tensor:
    """Codes in ``[0, levels]`` (float) for the grid ``lo + scale * q``.
    Division, not a multiply by the reciprocal, and round half to even,
    as the wire arithmetic does; a zero scale (a constant leaf) maps every
    element to code 0."""
    ok = scale > 0
    safe = torch.where(ok, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round((a - lo) / safe), 0, levels)
    return torch.where(ok, q, torch.zeros_like(q))


def affine_dequantize(q: torch.Tensor, lo, scale) -> torch.Tensor:
    """Inverse of :func:`affine_quantize`: ``lo + scale * q``."""
    return lo + scale * q
