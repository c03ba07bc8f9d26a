"""Vision Transformer (port of ``distkeras_tpu/models/vit.py``), BASELINE
config 5's model (ViT-L/16).

``model(images)`` takes NHWC images (uint8 ones are normalized on the
device, :mod:`.input_norm`) and returns float32 logits. A strided
convolution cuts the image into ``patch_size`` patches (``patch_embed``,
with a bias), the patch grid is flattened row-major (flax's
``reshape(b, h * w, c)`` order), a learned ``cls [1, 1, width]`` token is
prepended and ``pos_embed [1, h * w + 1, width]`` added; then the pre-LN
:class:`~distkeras_tpu_torch.models.transformer.Encoder` and a float32
``head`` on token 0.

flax infers the image size and channels at init; the port takes them at
construction (``image_size``, ``in_channels``), since ``pos_embed``'s
length depends on them. The sequence, ``h * w + 1`` (197 at 224/16), is
never a multiple of 128 at square grids, so ``fits`` rejects it: ViT runs
``attention="xla"``, and ``attention="flash"`` raises ValueError at the
first forward where the JAX switch falls back silently.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.models.input_norm import normalize_image_input
from distkeras_tpu_torch.models.remat import remat_call
from distkeras_tpu_torch.models.transformer import Encoder, init_params

__all__ = ["PatchEmbed", "ViT", "init_params", "vit_base", "vit_large",
           "vit_tiny"]


class PatchEmbed(nn.Module):
    """flax ``nn.Conv(width, (p, p), strides=(p, p), padding="VALID")``
    with a bias: float32 ``weight [width, in_channels, p, p]`` and
    ``bias``, cast to the compute dtype at each call; a quantizing
    ``precision`` fake-quantizes both operands. NHWC in, ``[b, h * w,
    width]`` out."""

    def __init__(self, in_channels: int, width: int, patch_size: int,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 precision: Optional[str] = None):
        super().__init__()
        self.patch_size = patch_size
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(width, in_channels,
                                               patch_size, patch_size))
        nn.init.normal_(self.weight, 0.0, self.weight[0].numel() ** -0.5)
        self.bias = nn.Parameter(torch.zeros(width))
        self._conv = precision_lib.make_conv_general(
            precision_lib.get_policy(precision)) or F.conv2d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, dt = self.patch_size, self.compute_dtype
        y = self._conv(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                       stride=(p, p))
        y = y + self.bias.to(dt)[None, :, None, None]
        return y.flatten(2).transpose(1, 2)


class ViT(nn.Module):
    """Vision Transformer; see the module docstring."""

    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 num_layers: int = 24, num_heads: int = 16,
                 width: int = 1024, mlp_dim: int = 4096,
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 normalize_uint8: bool = True, remat: str = "none",
                 precision: Optional[str] = None,
                 attention: Optional[str] = None, image_size: int = 224,
                 in_channels: int = 3):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"patch_size {patch_size}")
        self.num_classes, self.patch_size = num_classes, patch_size
        self.num_layers, self.num_heads = num_layers, num_heads
        self.width, self.mlp_dim = width, mlp_dim
        self.dropout_rate = float(dropout_rate)
        self.normalize_uint8 = normalize_uint8
        self.remat, self.precision, self.attention = remat, precision, \
            attention
        self.image_size, self.in_channels = image_size, in_channels
        #: compute dtype of the patch embedding and the Dense layers
        self.dtype = precision_lib.resolve(precision, dtype)
        grid = image_size // patch_size
        self.patch_embed = PatchEmbed(in_channels, width, patch_size,
                                      self.dtype, precision)
        self.cls = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, width))
        self.encoder = Encoder(width, num_layers, num_heads, mlp_dim,
                               dropout_rate, dtype, remat, precision,
                               attention)
        self.head = nn.Linear(width, num_classes)  # float32

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = normalize_image_input(x, self.dtype, self.normalize_uint8)
        x = remat_call(self.patch_embed, self.remat, x, stem=True)
        b, _, c = x.shape
        x = torch.cat([self.cls.expand(b, 1, c).to(self.dtype), x], dim=1)
        x = x + self.pos_embed.to(self.dtype)
        x = self.encoder(x, None, generator)
        return self.head(x[:, 0].float())


def vit_base(**kw) -> ViT:
    """ViT-B/16: 12 layers, 12 heads, width 768."""
    defaults = dict(num_layers=12, num_heads=12, width=768, mlp_dim=3072)
    defaults.update(kw)
    return ViT(**defaults)


def vit_large(**kw) -> ViT:
    """BASELINE config-5 model (ViT-L/16)."""
    return ViT(**kw)


def vit_tiny(**kw) -> ViT:
    """Test-sized ViT (2 layers, 2 heads, width 32, patch 4) over 16x16
    images, float32."""
    defaults = dict(num_classes=10, patch_size=4, num_layers=2, num_heads=2,
                    width=32, mlp_dim=64, dtype=torch.float32, image_size=16)
    defaults.update(kw)
    return ViT(**defaults)
