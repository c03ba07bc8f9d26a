"""MLP (port of ``distkeras_tpu/models/mlp.py``): the reference's MNIST
model family, BASELINE config 1.

Float32 parameters (the flax layout, carried across by
:mod:`distkeras_tpu_torch.utils.bridge`: ``dense_{i}`` and ``head``),
hidden layers computed in ``dtype`` or the ``precision`` policy's dtype
(:class:`~distkeras_tpu_torch.models.transformer.Dense`), and a float32
head under every policy.

Dropout draws its mask from the ``generator`` passed to ``forward``
(the step engine and the substrate pass one per step, seeded from the
trainer's seed, the worker, the round and the step), or from torch's
global generator when none is given; it is active only in training mode
(``model.train()``), as flax's ``deterministic=not train``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.models.transformer import Dense, dropout


class MLP(nn.Module):
    """Dense -> ReLU (-> Dropout) stacks, then a float32 head. Inputs of
    any trailing shape are flattened to ``[batch, -1]``; ``in_features``
    is their flattened width (flax infers it at init)."""

    def __init__(self, features: Sequence[int] = (512, 256),
                 num_classes: int = 10, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 precision: Optional[str] = None, in_features: int = 784):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.num_classes = int(num_classes)
        self.dropout_rate = float(dropout_rate)
        self.precision = precision
        self.dtype = precision_lib.resolve(precision, dtype)
        self.in_features = int(in_features)
        width = int(in_features)
        for i, out in enumerate(self.features):
            setattr(self, f"dense_{i}",
                    Dense(width, out, self.dtype, precision))
            width = out
        self.head = Dense(width, self.num_classes, torch.float32)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(len(self.features)):
            x = torch.relu(getattr(self, f"dense_{i}")(x))
            x = dropout(x, self.dropout_rate, self.training, generator)
        return self.head(x.float()).float()


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in flax's ``Dense`` defaults, made on the
    CPU from ``generator`` and copied in place: kernels LeCun normal
    (std ``fan_in ** -0.5``), biases zero; for :class:`MLP` and
    :class:`~distkeras_tpu_torch.models.cnn.CIFARConvNet` alike."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.empty(m.weight.shape).normal_(
                    0.0, fan_in ** -0.5, generator=generator))
                m.bias.zero_()
    return model


def mnist_mlp(**kw) -> MLP:
    """The BASELINE config-1 model: 784 -> 512 -> 256 -> 10."""
    return MLP(**kw)
