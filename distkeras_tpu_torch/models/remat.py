"""Activation rematerialization (port of ``distkeras_tpu/models/remat.py``).

Every model family takes ``remat=`` among :data:`REMAT_POLICIES`:

``none``
    Save every activation (autograd's default).
``blocks``
    Run each residual block / encoder layer through
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
    backward pass recomputes the block's forward from its input, so the
    live activations are the block BOUNDARIES, not their interiors.
``dots_saveable``
    The same wrapping under a selective-checkpoint policy
    (``torch.utils.checkpoint.create_selective_checkpoint_contexts``) that
    keeps the outputs of the matrix products (``aten.mm``, ``addmm``,
    ``bmm``, ``baddbmm``, ``_scaled_mm``, ``_int_mm``) and recomputes the
    rest (JAX's ``dots_saveable``). The hand-written kernels (flash
    attention, the int8 product) are not aten ops: their outputs are
    recomputed under every policy, so their forward launches twice a
    step.
``full``
    ``blocks`` plus the stem modules before the blocks (GPT's token
    embedding, the ResNet stem convolution, ViT's patch embedding).

:func:`remat_call` is the one entry the models use. Two things the JAX
transform gets for free are explicit here:

- dropout in the port draws from an explicit ``torch.Generator`` that
  the step engine passes (``preserve_rng_state`` covers only the global
  generators): the recompute gets a copy of that generator in its state
  at the block's entry, so it replays the same draws and leaves the
  caller's generator alone;
- under ``torch.func.functional_call`` (the engine's ``functional=True``
  grad functions, the substrate and host_async) the parameters the
  forward ran on are swapped back out before the backward: the recompute
  runs the block on the tensors it saw at its entry.

A recompute runs under :func:`~distkeras_tpu_torch.models.aux_losses.suppressed`,
so a sown auxiliary loss (Switch-MoE's) counts once. Without gradients
(``torch.no_grad``, serving) a wrapped call is a plain call.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from distkeras_tpu_torch.models import aux_losses

REMAT_POLICIES = ("none", "blocks", "dots_saveable", "full")

#: the ops whose outputs ``dots_saveable`` keeps (those this build has)
_DOT_OPS = frozenset(
    getattr(torch.ops.aten, name).default
    for name in ("mm", "addmm", "bmm", "baddbmm", "_scaled_mm", "_int_mm")
    if hasattr(torch.ops.aten, name))


def validate_remat(remat: str) -> str:
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, "
                         f"got {remat!r}")
    return remat


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint_context(remat: str):
    """The ``context_fn`` of ``checkpoint`` for a policy (None: save
    nothing inside the block)."""
    if remat == "dots_saveable":
        return functools.partial(ckpt.create_selective_checkpoint_contexts,
                                 _dots_policy)
    return None


def _generator_copy(generator: torch.Generator, state: torch.Tensor):
    copy = torch.Generator(device=generator.device)
    copy.set_state(state)
    return copy


def remat_call(module: nn.Module, remat: str, *args,
               generator: Optional[torch.Generator] = None,
               stem: bool = False, **kwargs):
    """``module(*args, **kwargs)`` (plus ``generator=`` when one is
    given) through ``checkpoint`` per the policy, or plainly under
    ``"none"``, without gradients, and for a ``stem`` module under any
    policy but ``"full"``."""
    validate_remat(remat)
    if generator is not None:
        kwargs["generator"] = generator
    if (remat == "none" or (stem and remat != "full")
            or not torch.is_grad_enabled()):
        return module(*args, **kwargs)
    # the tensors this call runs on (functional_call's, if it swapped them
    # in) and the generator's state at the block's entry, for the recompute
    tensors = {**dict(module.named_parameters()),
               **dict(module.named_buffers())}
    state = None if generator is None else generator.get_state()
    calls = [0]

    def run(*inputs):
        calls[0] += 1
        if calls[0] == 1:
            return module(*inputs, **kwargs)
        again = dict(kwargs)
        if state is not None:
            again["generator"] = _generator_copy(generator, state)
        with aux_losses.suppressed():
            return torch.func.functional_call(module, tensors, inputs,
                                              again)

    context = checkpoint_context(remat)
    extra = {} if context is None else {"context_fn": context}
    return ckpt.checkpoint(run, *args, use_reentrant=False, **extra)
