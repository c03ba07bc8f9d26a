"""Transformer building blocks (port of ``distkeras_tpu/models/transformer.py``).

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
    -> ``fc2``, both :class:`Dense` in the compute dtype under
    ``precision``."""

    def __init__(self, width: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 precision: Optional[str] = None):
        super().__init__()
        self.fc1 = Dense(width, mlp_dim, dtype, precision)
        self.fc2 = Dense(mlp_dim, width, dtype, precision)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
