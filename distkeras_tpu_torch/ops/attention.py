"""Attention ops (port of ``distkeras_tpu/ops/attention.py``).

``dot_product_attention`` is the plain path: the JAX package leaves it to
XLA, so the port leaves it to PyTorch's matmuls. Layout is the JAX
package's ``[batch, seq, heads, head_dim]``.

``apply_attention(..., attention=)`` is the dispatch switch: ``"xla"``
(the default) is ``dot_product_attention``; ``"flash"`` is the fused
flash-attention function of
:mod:`distkeras_tpu_torch.ops.kernels.flash_attention` (the Hopper kernels
for CUDA tensors, their plain versions for CPU tensors). Where the JAX
switch falls back SILENTLY to the XLA path for a shape the kernel's
``fits`` rejects or for a padding mask (``ops/attention.py:83-99``), the
port raises ValueError: on the card, ``"flash"`` runs the hand-written
kernels or nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

# Large-but-finite mask value (the JAX package's value): keeps softmax
# defined even for a row whose keys are all masked, and makes a masked
# key's weight exactly zero, since exp(MASK_VALUE - max) underflows.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

#: legal values of the ``attention=`` switch (gpt's ``attention="flash"``
#: field routes through the same dispatch)
ATTENTION_MODES = ("xla", "flash")


def resolve_attention(attention: Optional[str]) -> str:
    """Normalize the ``attention=`` field (None -> ``"xla"``)."""
    mode = attention or "xla"
    if mode not in ATTENTION_MODES:
        raise ValueError(
            f"attention={attention!r}; expected one of {ATTENTION_MODES}")
    return mode


def apply_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    attention: Optional[str] = None) -> torch.Tensor:
    """Dispatch one attention call per the resolved mode (module
    docstring). ``"flash"`` raises ValueError for a ``mask`` (the kernels
    know only the causal mask), and ``flash_attention`` raises it for a
    shape ``fits`` rejects."""
    mode = resolve_attention(attention)
    if mode == "xla":
        return dot_product_attention(q, k, v, mask=mask, causal=causal)
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    if mask is not None:
        raise ValueError("attention='flash' takes no mask (the kernels know "
                         "only the causal mask); use attention='xla'")
    return fa.flash_attention(q, k, v, causal=causal)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          causal: bool = False) -> torch.Tensor:
    """Attention over ``[batch, seq, heads, head_dim]`` tensors.

    The logits are computed in the input dtype, then scaled and
    softmaxed in float32; the weights are cast back to the input dtype
    before the value product, as the JAX package does."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits, MASK_VALUE)
    if mask is not None:
        # mask: [batch, kv_seq] (padding) or broadcastable to [b, h, q, k]
        if mask.dim() == 2:
            mask = mask[:, None, None, :]
        logits = torch.where(mask, logits, MASK_VALUE)
    weights = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)
