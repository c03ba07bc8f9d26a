"""BERT masked-language model (port of ``distkeras_tpu/models/bert.py``),
BASELINE config 4 (BERT-base MLM).

``model(input_ids, segment_ids=None)`` takes ``[batch, seq]`` token ids
of any integer dtype (config 4 stages int16; the ids are cast on the
device) and returns float32 MLM logits ``[batch, seq, vocab]``. Token id
``pad_id`` is masked out of attention on the key side. Pair it with the
``masked_lm`` loss (labels < 0 are ignored positions).

Layers under flax's names: ``tok_embed``, ``pos_embed [max_len, width]``,
``seg_embed`` (when ``num_segments > 0``), ``ln_embed``, the
:class:`~distkeras_tpu_torch.models.transformer.Encoder` (``encoder``)
and the MLM head (``mlm_dense`` -> tanh GELU -> ``mlm_ln`` -> float32
``mlm_head``). Parameters are float32; the embeddings, the encoder's
Dense layers and ``mlm_dense`` compute in ``dtype`` (or ``precision``'s
dtype, whose int8 policy sends those products through the int8 kernel);
the LayerNorms and the head compute in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.models.transformer import (LN_EPS, Dense, Embed,
                                                    Encoder, init_params)
from distkeras_tpu_torch.ops.attention import resolve_attention

__all__ = ["BertMLM", "bert_base", "bert_tiny", "init_params"]


class BertMLM(nn.Module):
    """BERT MLM; see the module docstring.

    Two differences from the JAX model, both by design:

    - ``attention="flash"`` raises ValueError here. BERT always passes its
      padding mask, and the port's flash dispatch refuses a mask where the
      JAX switch silently runs its XLA path instead;
    - flax makes ``seg_embed`` at init only when ``segment_ids`` are
      given; the port makes it when ``num_segments > 0`` (the default
      2). A flax tree made without it loads into
      ``BertMLM(num_segments=0)``.
    """

    def __init__(self, vocab_size: int = 30592, max_len: int = 512,
                 num_layers: int = 12, num_heads: int = 12, width: int = 768,
                 mlp_dim: int = 3072, num_segments: int = 2,
                 dropout_rate: float = 0.0, pad_id: int = 0,
                 dtype: torch.dtype = torch.bfloat16, remat: str = "none",
                 precision: Optional[str] = None,
                 attention: Optional[str] = None):
        super().__init__()
        if resolve_attention(attention) == "flash":
            raise ValueError(
                "BertMLM(attention='flash'): BERT always passes its padding "
                "mask and the flash kernels take none; use attention='xla' "
                "(the JAX package falls back to it silently)")
        self.vocab_size, self.max_len = vocab_size, max_len
        self.num_layers, self.num_heads = num_layers, num_heads
        self.width, self.mlp_dim = width, mlp_dim
        self.num_segments, self.pad_id = num_segments, pad_id
        self.dropout_rate = float(dropout_rate)
        self.remat, self.precision, self.attention = remat, precision, \
            attention
        #: compute dtype of the embeddings and the Dense layers
        self.dtype = precision_lib.resolve(precision, dtype)
        self.tok_embed = Embed(vocab_size, width, self.dtype)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, width))
        if num_segments > 0:
            self.seg_embed = Embed(num_segments, width, self.dtype)
        self.ln_embed = nn.LayerNorm(width, eps=LN_EPS)
        self.encoder = Encoder(width, num_layers, num_heads, mlp_dim,
                               dropout_rate, dtype, remat, precision,
                               attention)
        self.mlm_dense = Dense(width, width, self.dtype, precision)
        self.mlm_ln = nn.LayerNorm(width, eps=LN_EPS)
        # float32 and unquantized under every policy
        self.mlm_head = nn.Linear(width, vocab_size)

    def forward(self, input_ids: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ids = input_ids.long()
        t = ids.shape[1]
        x = self.tok_embed(ids) + self.pos_embed[:t].to(self.dtype)
        if segment_ids is not None:
            x = x + self.seg_embed(segment_ids.long())
        x = self.ln_embed(x.float()).to(self.dtype)
        mask = ids != self.pad_id  # [b, seq], key side
        x = self.encoder(x, mask, generator)
        x = F.gelu(self.mlm_dense(x.to(self.dtype)), approximate="tanh")
        return self.mlm_head(self.mlm_ln(x.float()))


def bert_base(**kw) -> BertMLM:
    """BASELINE config-4 model (BERT-base: 12 layers, 12 heads, 768)."""
    return BertMLM(**kw)


def bert_tiny(**kw) -> BertMLM:
    """Test-sized BERT (2 layers, 2 heads, width 64), float32."""
    defaults = dict(vocab_size=256, max_len=64, num_layers=2, num_heads=2,
                    width=64, mlp_dim=128, dtype=torch.float32)
    defaults.update(kw)
    return BertMLM(**defaults)
