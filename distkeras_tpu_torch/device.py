"""Device resolution for the port's entry points.

The port serves on the card: ``device=None`` means ``cuda:0``, and a host
without CUDA is an error, never a silent run on the CPU. The CPU is used
only when the caller names it, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises :class:`RuntimeError` when no CUDA
    device is present); anything else -> ``torch.device(device)``, with a
    CUDA device checked for presence."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested (the default when device is "
                f"None) but torch.cuda.is_available() is False; pass "
                f"device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
