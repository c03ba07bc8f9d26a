"""The inference forward pass (port of ``make_forward_fn`` of
``distkeras_tpu/predictors.py``; its dataset predictors are ROADMAP.md
Queue A, item 12)."""

from __future__ import annotations

import torch


def make_forward_fn(model: torch.nn.Module):
    """The inference forward pass ``x -> model(x)``, in eval mode and
    without autograd: the function the online
    :class:`~distkeras_tpu_torch.serving.engine.ServingEngine` captures
    per bucket. ``model`` holds its weights (the JAX function takes them
    as an argument); the engine passes each of its weight banks."""
    model.eval()

    @torch.no_grad()
    def forward(x):
        return model(x)

    return forward
