"""ResNet family (port of ``distkeras_tpu/models/resnet.py``), the
flagship model of dist-keras: ResNet v1.5 with GroupNorm (``norm="gn"``,
the default) or norm-free Scaled Weight Standardization (``norm="nf"``).

Layouts: the model takes NHWC images like the JAX model (uint8 images
are normalized on the device, :mod:`.input_norm`) and keeps its
activations as NCHW tensors in ``torch.channels_last`` memory, which is
NHWC in memory. So each GroupNorm input is a free ``[B, HW, C]`` view for
the GroupNorm kernels (:mod:`distkeras_tpu_torch.ops.kernels.groupnorm`),
and cuDNN's convolutions get their fast layout. Convolution weights are
stored OIHW (``nn.Conv2d``'s layout; the bridge turns flax's HWIO
around) and cast to the compute dtype, in channels_last, at each call.

Numerics follow the JAX model: float32 parameters, compute in ``dtype``
(or the ``precision`` policy's dtype, whose quantizing policies
fake-quantize both operands of every convolution), flax's ``"SAME"``
padding (asymmetric where the JAX model's is: a stride-2 3x3 conv of an
even input pads (0, 1)), GroupNorm with ``gcd(32, C)`` groups and eps
1e-6, a float32 classifier head. Attribute names are flax's module names
(``conv_stem``, ``norm_stem``, ``stage{i}_block{j}``, ``conv1`` ...
``norm_proj``, ``head``), so that carrying weights across is mechanical
(:mod:`distkeras_tpu_torch.utils.bridge`).

``remat`` (:mod:`distkeras_tpu_torch.models.remat`) checkpoints each
residual block, and under ``"full"`` the stem convolution too.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.models.input_norm import normalize_image_input
from distkeras_tpu_torch.models.remat import remat_call, validate_remat
from distkeras_tpu_torch.ops.kernels.groupnorm import GroupNorm

#: variance compensation after the branch-internal ReLUs of norm-free
#: blocks: Var[relu(z)] = (1 - 1/pi) / 2 for unit-normal z, so the gain
#: is sqrt(2 / (1 - 1/pi))
_RELU_GAIN = 1.7128585504496627

Padding = Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]


def group_norm(channels: int, scale_init: str = "ones") -> GroupNorm:
    """GroupNorm whose group count divides ``channels`` (32 at ImageNet
    widths, fewer for tiny test models), eps 1e-6."""
    return GroupNorm(channels, math.gcd(32, channels), eps=1e-6,
                     scale_init=scale_init)


def _relu_gain(x: torch.Tensor) -> torch.Tensor:
    """``relu(x) * _RELU_GAIN`` with the gain rounded to x's dtype first,
    as JAX rounds a Python constant to a bf16 operand's type."""
    gain = torch.tensor(_RELU_GAIN, dtype=x.dtype).item()
    return F.relu(x) * gain


def _nhwc_norm(norm: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm of an NCHW (channels_last) activation through its NHWC
    view, which is contiguous."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad(x: torch.Tensor, kernel_size, strides, padding: Padding):
    """``(x, conv padding)``: symmetric padding goes to the convolution,
    asymmetric padding is applied to ``x`` first."""
    if padding == "SAME":
        pads = tuple(_same_pads(s, k, st) for s, k, st in
                     zip(x.shape[2:], kernel_size, strides))
    else:
        pads = tuple(tuple(p) for p in padding)
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    (hl, hh), (wl, wh) = pads
    return F.pad(x, (wl, wh, hl, hh)), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, dtype=compute_dtype)`` on an NCHW
    (channels_last) activation: float32 ``weight [O, I, kh, kw]`` cast to
    the compute dtype at each call; a quantizing ``precision``
    fake-quantizes both operands."""

    def __init__(self, in_channels: int, features: int, kernel_size,
                 strides=(1, 1), padding: Padding = "SAME",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 precision: Optional[str] = None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels,
                                               *self.kernel_size))
        nn.init.normal_(self.weight, 0.0, self.fan_in ** -0.5)
        self._conv = precision_lib.make_conv_general(
            precision_lib.get_policy(precision)) or F.conv2d

    @property
    def fan_in(self) -> int:
        return self.weight[0].numel()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = _pad(x.to(self.compute_dtype), self.kernel_size,
                      self.strides, self.padding)
        w = self.weight.to(self.compute_dtype,
                           memory_format=torch.channels_last)
        return self._conv(x, w, stride=self.strides, padding=pad)


class ScaledWSConv(nn.Module):
    """Conv with Scaled Weight Standardization (the NF-ResNet / NFNet
    recipe): each output channel's kernel is standardized over its fan-in
    (population variance) and scaled by ``rsqrt(var * fan_in + 1e-4)``,
    times a learnable per-channel ``gain``, all in float32 on the weights,
    then cast once to the compute dtype; plus a float32 ``bias``."""

    def __init__(self, in_channels: int, features: int, kernel_size,
                 strides=(1, 1), padding: Padding = "SAME",
                 dtype: torch.dtype = torch.bfloat16,
                 gain_init: str = "ones", precision: Optional[str] = None):
        super().__init__()
        if gain_init not in ("ones", "zeros"):
            raise ValueError(f"gain_init must be 'ones' or 'zeros', got "
                             f"{gain_init!r}")
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.gain_init = gain_init
        self.precision = precision
        self._policy = precision_lib.get_policy(precision)
        self.weight = nn.Parameter(torch.empty(features, in_channels,
                                               *self.kernel_size))
        nn.init.normal_(self.weight, 0.0, 1.0)
        self.gain = nn.Parameter(torch.ones(features) if gain_init == "ones"
                                 else torch.zeros(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = precision_lib.resolve(self.precision, self.dtype)
        kernel = self.weight
        fan_in = kernel[0].numel()
        mu = kernel.mean(dim=(1, 2, 3), keepdim=True)
        var = kernel.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = (kernel - mu) * torch.rsqrt(var * fan_in + 1e-4)
        w = w * self.gain[:, None, None, None]
        x, pad = _pad(x.to(dtype), self.kernel_size, self.strides,
                      self.padding)
        w = w.to(dtype, memory_format=torch.channels_last)
        y = F.conv2d(precision_lib.fake_quant(self._policy, x),
                     precision_lib.fake_quant(self._policy, w),
                     stride=self.strides, padding=pad)
        return y + self.bias.to(dtype)[None, :, None, None]


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (output ``4 * filters`` channels) with
    a projection shortcut where the shape changes."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "gn",
                 precision: Optional[str] = None):
        super().__init__()
        out, s = 4 * filters, (strides, strides)
        self.norm = norm
        projected = in_channels != out or strides != 1
        if norm == "nf":
            conv = functools.partial(ScaledWSConv, dtype=dtype,
                                     precision=precision)
            self.conv1 = conv(in_channels, filters, (1, 1))
            self.conv2 = conv(filters, filters, (3, 3), strides=s)
            # zero-init gain: the block starts as the identity
            self.conv3 = conv(filters, out, (1, 1), gain_init="zeros")
            self.proj = conv(in_channels, out, (1, 1), strides=s) \
                if projected else None
            return
        conv = functools.partial(
            Conv, compute_dtype=precision_lib.resolve(precision, dtype),
            precision=precision)
        self.conv1 = conv(in_channels, filters, (1, 1))
        self.norm1 = group_norm(filters)
        self.conv2 = conv(filters, filters, (3, 3), strides=s)
        self.norm2 = group_norm(filters)
        self.conv3 = conv(filters, out, (1, 1))
        # zero-init scale of the last norm: the block starts as the identity
        self.norm3 = group_norm(out, scale_init="zeros")
        if projected:
            self.proj = conv(in_channels, out, (1, 1), strides=s)
            self.norm_proj = group_norm(out)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.norm == "nf":
            y = _relu_gain(self.conv1(x))
            y = _relu_gain(self.conv2(y))
            y = self.conv3(y)
            if self.proj is not None:
                residual = self.proj(residual)
            return F.relu(residual + y)
        y = F.relu(_nhwc_norm(self.norm1, self.conv1(x)))
        y = F.relu(_nhwc_norm(self.norm2, self.conv2(y)))
        y = _nhwc_norm(self.norm3, self.conv3(y))
        if self.proj is not None:
            residual = _nhwc_norm(self.norm_proj, self.proj(residual))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "gn",
                 precision: Optional[str] = None):
        super().__init__()
        s = (strides, strides)
        self.norm = norm
        projected = in_channels != filters or strides != 1
        if norm == "nf":
            conv = functools.partial(ScaledWSConv, dtype=dtype,
                                     precision=precision)
            self.conv1 = conv(in_channels, filters, (3, 3), strides=s)
            self.conv2 = conv(filters, filters, (3, 3), gain_init="zeros")
            self.proj = conv(in_channels, filters, (1, 1), strides=s) \
                if projected else None
            return
        conv = functools.partial(
            Conv, compute_dtype=precision_lib.resolve(precision, dtype),
            precision=precision)
        self.conv1 = conv(in_channels, filters, (3, 3), strides=s)
        self.norm1 = group_norm(filters)
        self.conv2 = conv(filters, filters, (3, 3))
        self.norm2 = group_norm(filters, scale_init="zeros")
        if projected:
            self.proj = conv(in_channels, filters, (1, 1), strides=s)
            self.norm_proj = group_norm(filters)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.norm == "nf":
            y = self.conv2(_relu_gain(self.conv1(x)))
            if self.proj is not None:
                residual = self.proj(residual)
            return F.relu(residual + y)
        y = F.relu(_nhwc_norm(self.norm1, self.conv1(x)))
        y = _nhwc_norm(self.norm2, self.conv2(y))
        if self.proj is not None:
            residual = _nhwc_norm(self.norm_proj, self.proj(residual))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 (stride 2 in the 3x3 conv of downsampling
    bottlenecks) over NHWC images; see the module docstring.
    ``in_channels`` is the image's channel count (flax infers it at
    init)."""

    def __init__(self, stage_sizes: Sequence[int], block=BottleneckBlock,
                 num_classes: int = 1000, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "gn",
                 normalize_uint8: bool = True, space_to_depth: bool = False,
                 remat: str = "none", precision: Optional[str] = None,
                 in_channels: int = 3):
        super().__init__()
        validate_remat(remat)
        if norm not in ("gn", "nf"):
            raise ValueError(f"norm must be 'gn' or 'nf', got {norm!r}")
        # the constructor kwargs, kept for serialize_model
        self.stage_sizes, self.block = tuple(stage_sizes), block
        self.num_classes, self.width = int(num_classes), int(width)
        self.remat, self.in_channels = remat, int(in_channels)
        self.norm = norm
        self.normalize_uint8 = normalize_uint8
        self.space_to_depth = space_to_depth
        self.precision = precision
        #: compute dtype of the convolutions and activations
        self.dtype = precision_lib.resolve(precision, dtype)
        if space_to_depth:
            stem = dict(kernel_size=(4, 4), strides=(1, 1), padding="SAME")
            stem_in = 4 * in_channels
        else:
            stem = dict(kernel_size=(7, 7), strides=(2, 2),
                        padding=((3, 3), (3, 3)))
            stem_in = in_channels
        if norm == "nf":
            self.conv_stem = ScaledWSConv(stem_in, width, dtype=dtype,
                                          precision=precision, **stem)
        else:
            self.conv_stem = Conv(stem_in, width, compute_dtype=self.dtype,
                                  precision=precision, **stem)
            self.norm_stem = group_norm(width)
        self._blocks = []
        channels = width
        for i, num_blocks in enumerate(stage_sizes):
            for j in range(num_blocks):
                name = f"stage{i}_block{j}"
                filters = width * 2 ** i
                setattr(self, name, block(channels, filters,
                                          2 if i > 0 and j == 0 else 1,
                                          dtype, norm, precision))
                self._blocks.append(name)
                channels = filters * block.expansion
        self.head = nn.Linear(channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images (uint8 or float) -> float32 logits."""
        x = normalize_image_input(x, self.dtype, self.normalize_uint8)
        if self.space_to_depth:
            n, h, w, c = x.shape
            x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
        # channels_last NCHW
        x = remat_call(self.conv_stem, self.remat, x.permute(0, 3, 1, 2),
                       stem=True)
        if self.norm == "nf":
            x = _relu_gain(x)
        else:
            x = F.relu(_nhwc_norm(self.norm_stem, x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self._blocks:
            x = remat_call(getattr(self, name), self.remat, x)
        x = x.mean(dim=(2, 3))  # global average pool
        return self.head(x.float())


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in flax's initializer families (normal, not
    truncated), made on the CPU from ``generator`` and copied into
    ``model`` in place: convolution and head kernels normal with std
    ``fan_in ** -0.5`` (LeCun); ScaledWSConv kernels standard normal;
    gains and GroupNorm scales one, or zero where the layer asks for a
    zero init; biases zero."""
    def normal(p, std):
        p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=generator))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ScaledWSConv):
                normal(m.weight, 1.0)
                m.gain.fill_(1.0 if m.gain_init == "ones" else 0.0)
                m.bias.zero_()
            elif isinstance(m, Conv):
                normal(m.weight, m.fan_in ** -0.5)
            elif isinstance(m, GroupNorm):
                m.weight.fill_(1.0 if m.scale_init == "ones" else 0.0)
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                normal(m.weight, m.in_features ** -0.5)
                m.bias.zero_()
    return model


def resnet18(**kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block=BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block=BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    """ResNet-50 with GroupNorm (the default ``norm="gn"``)."""
    return ResNet(stage_sizes=(3, 4, 6, 3), block=BottleneckBlock, **kw)


def resnet50_nf(**kw) -> ResNet:
    """The norm-free ResNet-50 recipe: Scaled Weight Standardization
    instead of GroupNorm, and on-device uint8 normalization."""
    kw.setdefault("norm", "nf")
    return ResNet(stage_sizes=(3, 4, 6, 3), block=BottleneckBlock, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), block=BottleneckBlock, **kw)
