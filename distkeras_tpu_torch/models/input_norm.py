"""On-device input normalization of the image models (port of
``distkeras_tpu/models/input_norm.py``).

Image trainers stage raw uint8 bytes (4x fewer host-to-device bytes than
float32) and the model normalizes on the device as ``(x - 127.5) / 58``,
about ``(x - mean) / std`` for natural images. One definition, so that
the constants cannot drift apart between models.
"""

from __future__ import annotations

import torch


def normalize_image_input(x: torch.Tensor, dtype: torch.dtype,
                          normalize_uint8: bool = True) -> torch.Tensor:
    """``x`` in ``dtype``; a uint8 ``x`` is first normalized on the device
    in ``dtype`` (unless ``normalize_uint8`` is False, e.g. masks or
    pre-scaled bytes). Float inputs are only cast."""
    if x.dtype == torch.uint8 and normalize_uint8:
        return (x.to(dtype) - 127.5) / 58.0
    return x.to(dtype)
