"""Causal LM (port of ``distkeras_tpu/models/gpt.py``).

Three paths, as in the JAX package:

- the **full forward** (``model(ids)``, the training path): causal
  attention over the block through
  :func:`~distkeras_tpu_torch.ops.attention.apply_attention`: its
  ``"xla"`` mode (the plain ``dot_product_attention``, the reference the
  serving path is held to) under ``attention="full"``, its ``"flash"``
  mode (the Hopper flash-attention kernels, forward and backward) under
  ``attention="flash"``;
- the **rectangular cache path** (``model(ids, cache=rows,
  cache_index=lengths)``): ``cache`` is the per-layer cache of
  :func:`init_cache`, ``[batch, max_len, heads, head_dim]`` per
  ``{"k", "v"}``. Each layer scatters the block's K/V to ``[row,
  cache_index + j]`` IN PLACE, dropping a position ``>= max_len`` (the
  JAX package's ``mode="drop"``: the decode step's ghost never
  overwrites the last real cell), then attends with the plain
  :func:`~distkeras_tpu_torch.ops.attention.dot_product_attention` over
  all ``max_len`` keys under the mask ``key_pos <= pos`` (the JAX package
  computes it outside any Pallas kernel too);
- the **paged cache path** (``model(ids, cache=pages,
  cache_index=lengths, page_table=tables)``): ``cache`` is the per-layer
  page pool of :func:`init_paged_cache`, ``[num_pages + 1, page_size,
  heads, head_dim]`` per ``{"k", "v"}`` (the last page is scratch),
  ``page_table[b, j]`` names the physical page behind row ``b``'s
  positions ``[j * page_size, (j + 1) * page_size)`` and
  ``cache_index[b]`` is the position of the block's first token. Each
  layer first scatters the block's K/V to its physical cells, IN PLACE
  (the JAX package returns a new pool; here the pool tensors are updated
  and returned), with ghost and overflow positions (``>= max_len``)
  routed to the scratch page; then it attends through the paged kernel
  (:mod:`distkeras_tpu_torch.ops.kernels.flash_attention`). As in the
  JAX package, the cache path needs ``attention="full"``.

Parameters follow flax's dtype rules: every parameter is stored in
float32 (the master weights an optimizer updates); the token embedding
and the Dense layers of each block cast theirs to the model's compute
dtype at each call (:class:`~distkeras_tpu_torch.models.transformer.Dense`,
:class:`~distkeras_tpu_torch.models.transformer.Embed`), while the
LayerNorms (eps 1e-6, flax's), the position table and the LM head
compute in float32. ``precision`` (:mod:`distkeras_tpu_torch.precision`)
sets the compute dtype and, for ``"int8"``/``"fp8-sim"``, quantizes the
products of every block Dense (qkv, out, fc1, fc2; under ``"int8"`` through
the int8 matmul kernel); the LM head stays float32 and unquantized.

Not ported yet: ``attention="ring"``, ``remat`` other than ``"none"``,
and int8 KV pages (ROADMAP.md Queue A).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.models.transformer import Dense, Embed, MlpBlock
from distkeras_tpu_torch.ops.attention import (apply_attention,
                                               dot_product_attention)
from distkeras_tpu_torch.ops.kernels import flash_attention as fa

#: flax's LayerNorm epsilon (torch's default is 1e-5)
LN_EPS = 1e-6


class CausalSelfAttention(nn.Module):
    def __init__(self, width: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16,
                 attention: str = "full", precision: Optional[str] = None):
        super().__init__()
        if attention == "ring":
            raise NotImplementedError(
                "attention='ring' is not ported yet (ROADMAP.md Queue A, "
                "item 16, with sequence parallelism)")
        if attention not in ("full", "flash"):
            raise ValueError(f"Unknown attention {attention!r}; expected "
                             f"'full', 'flash', or 'ring'")
        self.num_heads = num_heads
        self.attention = attention
        self.qkv = Dense(width, 3 * width, dtype, precision)
        self.out = Dense(width, width, dtype, precision)

    def forward(self, x, cache=None, cache_index=None, page_table=None):
        b, t, width = x.shape
        head_dim = width // self.num_heads
        q, k, v = (z.reshape(b, t, self.num_heads, head_dim).contiguous()
                   for z in self.qkv(x).split(width, dim=-1))
        if cache is None:
            mode = "flash" if self.attention == "flash" else "xla"
            out = apply_attention(q, k, v, causal=True, attention=mode)
            return self.out(out.reshape(b, t, width))
        if self.attention != "full":
            raise ValueError(f"KV-cache decode requires attention='full', "
                             f"got {self.attention!r}")
        if "k_scale" in cache:
            raise NotImplementedError(
                "int8 KV pages are not ported yet (ROADMAP.md Queue A, "
                "item 5)")
        pos = (cache_index.long()[:, None]
               + torch.arange(t, device=x.device)[None, :])
        if page_table is None:
            out = _rect_attention(q, k, v, cache, pos)
            return self.out(out.reshape(b, t, width)), cache
        ps = cache["k"].shape[1]
        pmax = page_table.shape[1]
        max_len = pmax * ps
        scratch_page = cache["k"].shape[0] - 1
        # scatter the block to its PHYSICAL cells first; ghost/overflow
        # positions (>= max_len) and unmapped table entries land in the
        # scratch page, so padding never touches a live page
        page_idx = (pos // ps).clamp(0, pmax - 1)
        phys = torch.gather(page_table.long(), 1, page_idx)
        inside = pos < max_len
        phys = torch.where(inside, phys, scratch_page)
        off = torch.where(inside, pos % ps, 0)
        cache["k"][phys, off] = k
        cache["v"][phys, off] = v
        out = fa.paged_flash_attention(q, cache["k"], cache["v"],
                                       page_table, cache_index)
        return self.out(out.reshape(b, t, width)), cache


def _rect_attention(q, k, v, cache, pos):
    """The rectangular cache branch: scatter ``k``/``v`` to ``[row,
    pos]`` in place, dropping positions ``>= max_len``, then attend over
    every cell with the mask ``key_pos <= pos``.

    A dropped position is written to the row's last cell with the value
    that cell holds after the scatter anyway (the in-call token at
    ``max_len - 1``, else its current value), so the write is a no-op
    and the scatter keeps fixed shapes (no data-dependent index list,
    which a CUDA graph could not hold)."""
    b, t = pos.shape
    max_len = cache["k"].shape[1]
    rows = torch.arange(b, device=q.device)
    inside = (pos < max_len)[..., None, None]
    last = max_len - 1 - pos[:, 0]  # the in-call index of cell max_len-1
    has_last = ((last >= 0) & (last < t))[:, None, None]
    col = pos.clamp(max=max_len - 1)
    for name, new in (("k", k), ("v", v)):
        tail = torch.where(has_last, new[rows, last.clamp(0, t - 1)],
                           cache[name][:, max_len - 1])
        cache[name][rows[:, None], col] = torch.where(inside, new,
                                                      tail[:, None])
    key_pos = torch.arange(max_len, device=q.device)
    mask = key_pos[None, None, None, :] <= pos[:, None, :, None]
    return dot_product_attention(q, cache["k"], cache["v"], mask=mask)


class DecoderBlock(nn.Module):
    def __init__(self, width: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 attention: str = "full", precision: Optional[str] = None):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = CausalSelfAttention(width, num_heads, dtype, attention,
                                        precision)
        self.ln2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = MlpBlock(width, mlp_dim, dtype, precision)

    def forward(self, x, cache=None, cache_index=None, page_table=None):
        y = self.ln1(x.float()).to(self.dtype)
        if cache is not None:
            y, new_cache = self.attn(y, cache, cache_index, page_table)
        else:
            y, new_cache = self.attn(y), None
        x = x + y
        x = x + self.mlp(self.ln2(x.float()).to(self.dtype))
        return x if new_cache is None else (x, new_cache)


class CausalLM(nn.Module):
    """GPT-style decoder; see the module docstring for its two paths."""

    def __init__(self, vocab_size: int = 32000, max_len: int = 2048,
                 num_layers: int = 12, num_heads: int = 12, width: int = 768,
                 mlp_dim: int = 3072, dtype: torch.dtype = torch.bfloat16,
                 attention: str = "full", remat: str = "none",
                 precision: Optional[str] = None):
        super().__init__()
        if remat != "none":
            raise NotImplementedError(
                f"remat={remat!r} is not ported yet (ROADMAP.md Queue A, "
                f"item 10, models/remat.py)")
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.width = width
        self.mlp_dim = mlp_dim
        self.precision = precision
        #: compute dtype of the embedding and the blocks' Dense layers
        self.dtype = precision_lib.resolve(precision, dtype)
        self.tok_embed = Embed(vocab_size, width, self.dtype)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, width))
        self.layers = nn.ModuleList(
            DecoderBlock(width, num_heads, mlp_dim, self.dtype, attention,
                         self.precision)
            for _ in range(num_layers))
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)
        # float32 and unquantized under every policy (the JAX model's head
        # takes no dense_kw)
        self.lm_head = nn.Linear(width, vocab_size)

    def forward(self, input_ids, cache=None, cache_index=None,
                page_table=None):
        ids = input_ids.long()
        t = ids.shape[1]
        x = self.tok_embed(ids)
        if cache is not None:
            # a ghost position may sit at max_len; JAX clamps the gather
            idx = (cache_index.long()[:, None]
                   + torch.arange(t, device=ids.device)[None, :])
            pos = self.pos_embed[idx.clamp(max=self.max_len - 1)]
        else:
            pos = self.pos_embed[:t]
        x = x + pos.to(self.dtype)
        if cache is not None:
            for block, layer_cache in zip(self.layers, cache):
                x, _ = block(x, layer_cache, cache_index, page_table)
        else:
            for block in self.layers:
                x = block(x)
        logits = self.lm_head(self.ln_final(x.float()))
        return logits if cache is None else (logits, cache)


def init_params(model: CausalLM, generator: torch.Generator) -> CausalLM:
    """Seeded random weights, made on the CPU from ``generator`` and
    copied into ``model`` in place: Linear weights normal with std
    ``fan_in ** -0.5`` (flax's LeCun normal, untruncated), embeddings and
    positions normal with std 0.02, biases zero, LayerNorm scale one."""
    def normal(p, std):
        p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=generator))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                normal(m.weight, m.in_features ** -0.5)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal(m.weight, 0.02)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        normal(model.pos_embed, 0.02)
    return model


def inference_copy(model: CausalLM) -> CausalLM:
    """A copy of ``model`` for serving whose embedding and Dense weights
    are STORED in the compute dtype, so that their casts in ``forward``
    are no-ops: the same function (the float32 -> compute-dtype cast is
    deterministic) without one cast kernel per weight per call. The
    LayerNorms, positions and LM head stay float32. The copy does not
    follow later updates of ``model``. A float32 model is returned as is
    (nothing to cast)."""
    if model.dtype == torch.float32:
        return model
    out = copy.deepcopy(model)
    for m in out.modules():
        if isinstance(m, (Dense, Embed)):
            m.to(m.compute_dtype)
    return out


def init_cache(model: CausalLM, batch: int,
               dtype: Optional[torch.dtype] = None, device=None):
    """Zeroed rectangular cache for ``batch`` rows of ``model.max_len``
    context: a tuple (one entry per layer) of ``{"k", "v"}`` tensors
    ``[batch, max_len, heads, head_dim]`` in the compute dtype (the
    qkv projection's), on ``device`` (None: the model's own device, that
    of its first parameter). ``cache_bytes_per_row`` bytes a row."""
    dtype = model.dtype if dtype is None else dtype
    if device is None:
        device = next(model.parameters()).device
    shape = (batch, model.max_len, model.num_heads,
             model.width // model.num_heads)
    return tuple({"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)}
                 for _ in range(model.num_layers))


def init_paged_cache(model: CausalLM, num_pages: int, page_size: int,
                     dtype: Optional[torch.dtype] = None, kv_dtype=None,
                     device=None):
    """Zeroed shared page pool: a tuple (one entry per layer) of
    ``{"k", "v"}`` tensors ``[num_pages + 1, page_size, heads, head_dim]``
    on ``device`` (None: the model's own device, that of its first
    parameter). The extra LAST page is scratch. Native dtype only."""
    if kv_dtype == "int8":
        raise NotImplementedError(
            "int8 KV pages are not ported yet (ROADMAP.md Queue A, item 5)")
    if kv_dtype not in (None, "native"):
        raise ValueError(
            f"kv_dtype must be None, 'native', or 'int8', got {kv_dtype!r}")
    dtype = model.dtype if dtype is None else dtype
    if device is None:
        device = next(model.parameters()).device
    shape = (num_pages + 1, page_size, model.num_heads,
             model.width // model.num_heads)
    return tuple({"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)}
                 for _ in range(model.num_layers))


def page_bytes(model: CausalLM, page_size: int,
               dtype: Optional[torch.dtype] = None) -> int:
    """Device bytes one logical page costs (k + v cells, every layer)."""
    dtype = model.dtype if dtype is None else dtype
    return 2 * model.num_layers * page_size * model.width * dtype.itemsize


def cache_bytes_per_row(model: CausalLM,
                        dtype: Optional[torch.dtype] = None) -> int:
    """Device bytes one full-context cache row costs (k + v, every
    layer)."""
    return page_bytes(model, model.max_len, dtype)


def gpt_small(**kw) -> CausalLM:
    """GPT-2-small shape (124M)."""
    return CausalLM(vocab_size=50304, max_len=1024, num_layers=12,
                    num_heads=12, width=768, mlp_dim=3072, **kw)


def gpt_tiny(**kw) -> CausalLM:
    """Test-sized causal LM."""
    defaults = dict(vocab_size=256, max_len=128, num_layers=2, num_heads=2,
                    width=32, mlp_dim=64, dtype=torch.float32)
    defaults.update(kw)
    return CausalLM(**defaults)
