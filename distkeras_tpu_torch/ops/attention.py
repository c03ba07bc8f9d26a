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
from torch import nn

from distkeras_tpu_torch import precision as precision_lib

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


class MultiHeadAttention(nn.Module):
    """Multi-head attention with a fused QKV projection over ``[batch,
    seq, width]``: ``qkv`` (``Dense(width, 3 * features)``) split as ``[q |
    k | v]`` into ``[batch, seq, heads, head_dim]``, then
    :func:`apply_attention` under ``mask``, ``causal`` and ``attention``,
    then ``out`` (``Dense(features, width)``). Both projections compute in
    ``precision``'s dtype (or ``dtype``) and quantize under its policy;
    the softmax is float32 on either path. ``features`` is
    ``qkv_features`` or ``width``."""

    def __init__(self, width: int, num_heads: int,
                 qkv_features: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16, causal: bool = False,
                 precision: Optional[str] = None,
                 attention: Optional[str] = None):
        super().__init__()
        # Dense lives with the models, which import this module
        from distkeras_tpu_torch.models.transformer import Dense

        features = qkv_features or width
        if features % num_heads:
            raise ValueError(f"qkv features {features} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads, self.features = num_heads, features
        self.causal = causal
        self.attention = resolve_attention(attention)
        compute = precision_lib.resolve(precision, dtype)
        self.qkv = Dense(width, 3 * features, compute, precision)
        self.out = Dense(features, width, compute, precision)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        head_dim = self.features // self.num_heads
        q, k, v = (z.reshape(b, t, self.num_heads, head_dim)
                   for z in self.qkv(x).split(self.features, dim=-1))
        out = apply_attention(q, k, v, mask=mask, causal=self.causal,
                              attention=self.attention)
        return self.out(out.reshape(b, t, self.features))
