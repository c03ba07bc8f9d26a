"""Transformer building blocks (port of ``distkeras_tpu/models/transformer.py``)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class MlpBlock(nn.Module):
    """``fc1`` -> GELU (tanh approximation, flax's ``nn.gelu`` default)
    -> ``fc2``. Weights are held in the compute dtype, as flax's Dense
    casts its float32 params to ``dtype`` at every call."""

    def __init__(self, width: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc1 = nn.Linear(width, mlp_dim, dtype=dtype)
        self.fc2 = nn.Linear(mlp_dim, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
