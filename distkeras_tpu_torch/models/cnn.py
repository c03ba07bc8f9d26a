"""Convolutional net (port of ``distkeras_tpu/models/cnn.py``): the
reference's CIFAR example model, BASELINE config 2.

Takes NHWC images like the JAX model (uint8 normalized on the device,
:mod:`.input_norm`; flat ``[batch, 3 * side²]`` vectors are reshaped to
``[batch, side, side, 3]``), computes NCHW with ``nn.Conv2d`` (OIHW
weights; the bridge turns flax's HWIO around), and flattens the last
feature map in NHWC order before the dense layer, so the dense kernel is
flax's as it stands. Two blocks of conv-ReLU-conv-ReLU-maxpool (3x3
convolutions with flax's ``"SAME"`` padding, 2x2 max pooling), a dense
layer with ReLU and dropout (:func:`~distkeras_tpu_torch.models.mlp.dropout`),
and a float32 head. Parameters are float32; convolutions and the hidden
dense compute in ``dtype`` or the ``precision`` policy's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.models.input_norm import normalize_image_input
from distkeras_tpu_torch.models.mlp import dropout, init_params  # noqa: F401
from distkeras_tpu_torch.models.transformer import Dense


class _Conv3x3(nn.Conv2d):
    """A 3x3 ``"SAME"`` convolution with float32 weights cast to the
    compute dtype at each call (fake-quantized under a quantizing
    policy)."""

    def __init__(self, in_channels: int, out_channels: int,
                 compute_dtype: torch.dtype, precision: Optional[str]):
        super().__init__(in_channels, out_channels, 3, padding=1)
        self.compute_dtype = compute_dtype
        self._conv = precision_lib.make_conv_general(
            precision_lib.get_policy(precision)) or F.conv2d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.weight.to(self.compute_dtype),
                          bias=self.bias.to(self.compute_dtype), padding=1)


class CIFARConvNet(nn.Module):
    """Conv stack for 32x32 RGB images (CIFAR-10 shape); ``image_size``
    and ``in_channels`` fix the dense layer's input width (flax infers it
    at init)."""

    def __init__(self, channels: Sequence[int] = (64, 128),
                 dense_width: int = 256, num_classes: int = 10,
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 normalize_uint8: bool = True,
                 precision: Optional[str] = None, image_size: int = 32,
                 in_channels: int = 3):
        super().__init__()
        self.channels = tuple(int(c) for c in channels)
        self.dropout_rate = float(dropout_rate)
        self.normalize_uint8 = normalize_uint8
        self.precision = precision
        self.dtype = precision_lib.resolve(precision, dtype)
        # the remaining constructor kwargs, kept for serialize_model
        self.dense_width, self.num_classes = int(dense_width), int(num_classes)
        self.image_size, self.in_channels = int(image_size), int(in_channels)
        cin, side = in_channels, image_size
        for i, ch in enumerate(self.channels):
            setattr(self, f"conv_{i}a",
                    _Conv3x3(cin, ch, self.dtype, precision))
            setattr(self, f"conv_{i}b",
                    _Conv3x3(ch, ch, self.dtype, precision))
            cin, side = ch, side // 2
        self.dense = Dense(cin * side * side, dense_width, self.dtype,
                           precision)
        self.head = Dense(dense_width, num_classes, torch.float32)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = normalize_image_input(x, self.dtype, self.normalize_uint8)
        if x.dim() == 2:  # flat feature vectors -> NHWC
            side = int(round((x.shape[-1] // 3) ** 0.5))
            x = x.reshape(x.shape[0], side, side, 3)
        x = x.permute(0, 3, 1, 2)
        for i in range(len(self.channels)):
            x = torch.relu(getattr(self, f"conv_{i}a")(x))
            x = torch.relu(getattr(self, f"conv_{i}b")(x))
            x = F.max_pool2d(x, 2, stride=2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = torch.relu(self.dense(x))
        x = dropout(x, self.dropout_rate, self.training, generator)
        return self.head(x.float()).float()


def cifar10_cnn(**kw) -> CIFARConvNet:
    """The BASELINE config-2 model."""
    return CIFARConvNet(**kw)
