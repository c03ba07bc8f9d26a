"""Transformer building blocks (port of ``distkeras_tpu/models/transformer.py``):
the Dense and embedding layers every family shares, the MLP block, and
the pre-LN encoder of BERT and ViT (:class:`EncoderBlock`,
:class:`Encoder`).

Parameters follow flax: every weight is STORED in float32 (the master
copy an optimizer updates) and cast to the layer's compute dtype inside
``forward``, as flax's ``Dense``/``Embed`` cast their float32 params at
each call. Storing a bf16 weight instead would round every training
update to bf16's 8-bit mantissa; for serving the two agree, since the
cast is deterministic.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.models.remat import remat_call, validate_remat

#: flax's LayerNorm epsilon (torch's default is 1e-5)
LN_EPS = 1e-6


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 -
    rate`` and scale the kept ones by ``1 / (1 - rate)``; identity when
    not training or at rate 0. The mask is drawn from ``generator`` (the
    step engine's), or from torch's global generator when None."""
    if not training or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dense(nn.Linear):
    """``nn.Linear`` with float32 parameters computing in
    ``compute_dtype`` (flax ``nn.Dense(dtype=...)``). Under a quantizing
    ``precision`` policy the product goes through the policy's hook
    (:func:`~distkeras_tpu_torch.precision.make_dot_general`): after the
    weight's cast to the compute dtype (flax's ``promote_dtype``), ``int8``
    computes ``scaled_int8_matmul(x, w) + b``, ``fp8-sim`` the product of
    the fake-quantized operands plus ``b``."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32,
                 precision: Optional[str] = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype
        self._dot = precision_lib.make_dot_general(
            precision_lib.get_policy(precision))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.compute_dtype)
        b = self.bias.to(self.compute_dtype)
        if self._dot is None:
            return F.linear(x, w, b)
        return self._dot(x, w) + b


class Embed(nn.Embedding):
    """``nn.Embedding`` with a float32 table looked up in
    ``compute_dtype`` (flax ``nn.Embed(dtype=...)``: the table is cast,
    then gathered)."""

    def __init__(self, num_embeddings: int, features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_embeddings, features)
        self.compute_dtype = compute_dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight.to(self.compute_dtype))


class MlpBlock(nn.Module):
    """``fc1`` -> GELU (tanh approximation, flax's ``nn.gelu`` default)
    (-> dropout in training) -> ``fc2``, both :class:`Dense` in the
    compute dtype under ``precision``."""

    def __init__(self, width: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 precision: Optional[str] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.fc1 = Dense(width, mlp_dim, dtype, precision)
        self.fc2 = Dense(mlp_dim, width, dtype, precision)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = F.gelu(self.fc1(x), approximate="tanh")
        y = dropout(y, self.dropout_rate, self.training, generator)
        return self.fc2(y)


class EncoderBlock(nn.Module):
    """Pre-LN encoder block: float32 LayerNorm (eps 1e-6) -> bidirectional
    :class:`~distkeras_tpu_torch.ops.attention.MultiHeadAttention` under
    the padding ``mask`` (-> dropout) -> residual, then LayerNorm ->
    :class:`MlpBlock` -> residual. Flax's module names (``ln1``,
    ``attn``, ``ln2``, ``mlp``)."""

    def __init__(self, width: int, num_heads: int, mlp_dim: int,
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 precision: Optional[str] = None,
                 attention: Optional[str] = None):
        super().__init__()
        from distkeras_tpu_torch.ops.attention import MultiHeadAttention

        self.dropout_rate = float(dropout_rate)
        self.dtype = precision_lib.resolve(precision, dtype)
        self.ln1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = MultiHeadAttention(width, num_heads, dtype=dtype,
                                       precision=precision,
                                       attention=attention)
        self.ln2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = MlpBlock(width, mlp_dim, self.dtype, precision,
                            dropout_rate)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.attn(self.ln1(x.float()).to(self.dtype), mask)
        x = x + dropout(y, self.dropout_rate, self.training, generator)
        return x + self.mlp(self.ln2(x.float()).to(self.dtype), generator)


class Encoder(nn.Module):
    """A stack of :class:`EncoderBlock` (``layers.{i}``) and a final
    float32 LayerNorm (``ln_final``); each block runs through
    :func:`~distkeras_tpu_torch.models.remat.remat_call` under
    ``remat``. The output is float32."""

    def __init__(self, width: int, num_layers: int, num_heads: int,
                 mlp_dim: int, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, remat: str = "none",
                 precision: Optional[str] = None,
                 attention: Optional[str] = None):
        super().__init__()
        self.remat = validate_remat(remat)
        self.layers = nn.ModuleList(
            EncoderBlock(width, num_heads, mlp_dim, dropout_rate, dtype,
                         precision, attention)
            for _ in range(num_layers))
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for block in self.layers:
            x = remat_call(block, self.remat, x, mask, generator=generator)
        return self.ln_final(x.float())


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in flax's initializer families (normal, not
    truncated) for the encoder families (BERT, ViT, the MoE classifier),
    made on the CPU from ``generator`` and copied into ``model`` in place:
    Dense/Linear and convolution kernels normal with std ``fan_in **
    -0.5`` (LeCun; stacked experts per expert), embeddings and position
    tables normal with std 0.02, ``cls`` and biases zero, LayerNorm
    scales one."""
    def normal(p, std):
        p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=generator))

    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = model.get_submodule(name.rpartition(".")[0])
            if isinstance(owner, nn.LayerNorm):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias" or leaf == "cls":
                p.zero_()
            elif isinstance(owner, nn.Embedding) or leaf == "pos_embed":
                normal(p, 0.02)
            else:  # [out, in, ...] kernels, or stacked [E, out, in]
                fan_in = p.shape[-1] if p.dim() == 3 else p[0].numel()
                normal(p, fan_in ** -0.5)
    return model
