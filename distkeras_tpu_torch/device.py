"""Device resolution for the port's entry points.

The port serves on the card: ``device=None`` means this process's card
(``cuda:0`` on a plain host), and a host without CUDA is an error, never
a silent run on the CPU. The CPU is used only when the caller names it,
as the tests do.

A mesh's default devices are :func:`visible_devices`: every visible card
in one process (JAX's ``jax.devices()``), this process's card inside a
``torch.distributed`` group (JAX's ``jax.local_devices()`` under one card
a process).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current card, ``cuda:0`` unless
    ``torch.cuda.set_device`` chose another (as
    ``distributed.initialize`` does for a rank's card); raises
    :class:`RuntimeError` when no CUDA device is present. Anything else
    -> ``torch.device(device)``, with a CUDA device checked for presence
    (a bare ``cuda`` is the current card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested (the default when device is "
                f"None) but torch.cuda.is_available() is False; pass "
                f"device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices() -> list:
    """The devices a mesh takes by default: ``[cuda:0, ..., cuda:N-1]``,
    every visible card in order, in one process; this process's card
    (``torch.cuda.current_device()``, which ``distributed.initialize``
    sets) inside a ``torch.distributed`` group. Raises
    :class:`RuntimeError` without a card, as :func:`resolve_device`
    does."""
    home = resolve_device(None)  # this process's card
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return [home]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
