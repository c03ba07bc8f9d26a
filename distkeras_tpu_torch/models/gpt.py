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
  JAX package, the cache path needs ``attention="full"``;
- the **int8 paged cache path**: when the page pool carries
  ``k_scale``/``v_scale`` (:func:`init_paged_cache` with
  ``kv_dtype="int8"``), pages hold symmetric int8 codes with one float32
  scale a page (:func:`quantize_kv_page`) and each layer runs
  :func:`_paged_int8_attention`: the JAX package's default order
  (dequantize, overlay the exact in-call block, requantize only the
  touched pages, attend), with the attention through the paged kernel
  over the dense view.

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

``attention="ring"`` is the sequence-parallel forward
(:mod:`distkeras_tpu_torch.parallel.sequence` drives it): the model
takes a LIST of per-shard ``[batch, t]`` id blocks, block ``j`` holding
global positions ``j * t ... (j + 1) * t``, and returns the list of
their logits. Every layer runs block by block, in step across the
shards, each block computed on its shard's device (the parameters'
device, as on a mesh that repeats ``cuda:0``; or another card of this
process, through a replica of the weights there, as JAX replicates the
parameters over ``jax.devices()``), and its attention folds the blocks' q/k/v
through :func:`~distkeras_tpu_torch.ops.ring_attention.ring_attention`.
A block that another process holds is a
:class:`~distkeras_tpu_torch.ops.ring_attention.Remote` in the list, and
in the returned list: this process computes its own blocks only, and
the ring's hops cross to the other processes (no ``remat`` then: a
recompute would repeat the hops). Block
``j`` adds rows ``j * t ... (j + 1) * t`` of the position table; a
global length ``t * shards`` past ``max_len`` raises ValueError before
any row is sliced (a torch slice would silently come up short). The
weights are those of ``"full"``/``"flash"`` (the same state dict). A
single tensor, a decode or a serving call under ``"ring"`` raises, as
in the JAX package.

``remat`` (:mod:`distkeras_tpu_torch.models.remat`) checkpoints each
decoder block of the full and ring forwards, and under ``"full"`` the
token embedding too; the cache paths (serving, CUDA-graph captures) run
un-rematted, as in the JAX package.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn
from torch.nn.parallel import replicate

from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.comms import codec
from distkeras_tpu_torch.models.remat import remat_call, validate_remat
from distkeras_tpu_torch.models.transformer import (LN_EPS, Dense, Embed,
                                                    MlpBlock)
from distkeras_tpu_torch.ops.attention import (apply_attention,
                                               dot_product_attention)
from distkeras_tpu_torch.ops.kernels import flash_attention as fa
from distkeras_tpu_torch.ops.ring_attention import is_remote, ring_attention


class CausalSelfAttention(nn.Module):
    def __init__(self, width: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16,
                 attention: str = "full", precision: Optional[str] = None):
        super().__init__()
        if attention not in ("full", "flash", "ring"):
            raise ValueError(f"Unknown attention {attention!r}; expected "
                             f"'full', 'flash', or 'ring'")
        self.num_heads = num_heads
        self.attention = attention
        self.qkv = Dense(width, 3 * width, dtype, precision)
        self.out = Dense(width, width, dtype, precision)

    def _heads(self, x):
        b, t, width = x.shape
        head_dim = width // self.num_heads
        return tuple(z.reshape(b, t, self.num_heads, head_dim).contiguous()
                     for z in self.qkv(x).split(width, dim=-1))

    def forward(self, x, cache=None, cache_index=None, page_table=None):
        if cache is None and self.attention == "ring":
            raise ValueError(
                "attention='ring' runs over sequence shards: call the model "
                "on a list of per-shard id blocks "
                "(parallel/sequence.py's build_sp_train_step does)")
        b, t, width = x.shape
        q, k, v = self._heads(x)
        if cache is None:
            mode = "flash" if self.attention == "flash" else "xla"
            out = apply_attention(q, k, v, causal=True, attention=mode)
            return self.out(out.reshape(b, t, width))
        if self.attention != "full":
            raise ValueError(f"KV-cache decode requires attention='full', "
                             f"got {self.attention!r}")
        pos = (cache_index.long()[:, None]
               + torch.arange(t, device=x.device)[None, :])
        if page_table is None:
            out = _rect_attention(q, k, v, cache, pos)
            return self.out(out.reshape(b, t, width)), cache
        if "k_scale" in cache:
            out = _paged_int8_attention(q, k, v, cache, page_table, pos,
                                        cache_index)
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


#: levels of the symmetric int8 KV grid (codes -127..127 after
#: centering): ``precision.py``'s int8 grid, so KV pages, the wire codec
#: and fake-quant training share one affine arithmetic
KV_QUANT_LEVELS = 254


def quantize_kv_page(x, valid=None):
    """Per-page symmetric int8 quantization of K/V page data.

    ``x`` is ``[..., page_size, heads, head_dim]`` (leading dims index
    pages); returns ``(codes int8, scale float32 [...])`` on the codec's
    grid: ``scale = symmetric_int8_qparams(amax) = amax / 127``, codes
    centered at zero. ``valid`` (``[..., page_size]`` bool) zeroes cells
    past a row's length before ``amax``, so stale cells never inflate a
    page's scale; masked cells store code 0, and an all-zero page scale
    0 and codes 0. One encode's per-cell error is at most ``scale / 2``."""
    x = x.float()
    if valid is not None:
        x = torch.where(valid[..., None, None], x, 0.0)
    amax = x.abs().amax(dim=(-3, -2, -1))
    scale = precision_lib.symmetric_int8_qparams(amax)
    sc = scale[..., None, None, None]
    codes = codec.affine_quantize(x, -amax[..., None, None, None], sc,
                                  KV_QUANT_LEVELS) - 127.0
    codes = torch.where(sc > 0, codes, 0.0)
    return codes.to(torch.int8), scale


def dequantize_kv_page(codes, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv_page`: ``scale * codes`` in float32,
    broadcast per page, then ``dtype``."""
    return (codes.float() * scale[..., None, None, None]).to(dtype)


def _paged_int8_attention(q, k, v, cache, page_table, pos, cache_index):
    """One paged step over int8 KV pages, in the JAX package's default
    order: gather codes and scales through the page table into the dense
    float32 ``[b, max_len]`` view and dequantize; overlay the EXACT
    in-call K/V block at ``pos`` (in-call positions attend at full
    precision, only history is round-tripped; a position ``>= max_len``,
    the decode ghost, is dropped); requantize IN PLACE only the window
    of ``ceil(t / page_size) + 1`` pages the block touched, from
    ``cache_index // page_size``, with cells at or past ``cache_index +
    t`` zeroed before ``amax`` (untouched pages keep their codes bit for
    bit); then attend over the view in ``q``'s dtype through the paged
    kernel, the view handed over as ``b * pmax`` pages behind a fixed
    identity page table (fixed shapes, so a CUDA graph holds the call)."""
    b, t = pos.shape
    heads, head_dim = k.shape[2], k.shape[3]
    ps = cache["k"].shape[1]
    pmax = page_table.shape[1]
    max_len = pmax * ps
    scratch_page = cache["k"].shape[0] - 1
    table = page_table.long()
    rows = torch.arange(b, device=q.device)[:, None]
    # a position past the view lands in one extra cell, cut off after
    ghost = pos.clamp(max=max_len)

    def dense_view(codes, scale, block):
        view = torch.empty((b, max_len + 1, heads, head_dim),
                           dtype=torch.float32, device=q.device)
        view[:, :max_len] = dequantize_kv_page(codes[table],
                                               scale[table]).reshape(
            b, max_len, heads, head_dim)
        view[rows, ghost] = block.float()
        return view[:, :max_len]

    k_dense = dense_view(cache["k"], cache["k_scale"], k)
    v_dense = dense_view(cache["v"], cache["v_scale"], v)
    # positions [cache_index, cache_index + t) span at most ceil(t/ps) + 1
    # logical pages from cache_index // ps (the cursor may sit mid-page)
    ci = cache_index.long()
    n_touch = -(-t // ps) + 1
    first = (ci // ps).clamp(0, pmax - 1)
    win = first[:, None] + torch.arange(n_touch, device=q.device)[None, :]
    last = ((ci + t - 1) // ps).clamp(0, pmax - 1)
    ok_w = (win <= last[:, None]) & (win < pmax)
    win_c = win.clamp(0, pmax - 1)
    phys_w = torch.where(ok_w, torch.gather(table, 1, win_c), scratch_page)
    cell = win_c[..., None] * ps + torch.arange(ps, device=q.device)
    valid = cell < (ci + t)[:, None, None]
    bidx = torch.arange(b, device=q.device)[:, None, None]
    for name, dense in (("k", k_dense), ("v", v_dense)):
        codes, scale = quantize_kv_page(dense[bidx, cell], valid)
        cache[name][phys_w] = codes
        cache[f"{name}_scale"][phys_w] = scale
    view_pages = lambda dense: dense.to(q.dtype).reshape(
        b * pmax, ps, heads, head_dim).contiguous()
    identity = torch.arange(b * pmax, dtype=torch.int32,
                            device=q.device).reshape(b, pmax)
    return fa.paged_flash_attention(q, view_pages(k_dense),
                                    view_pages(v_dense), identity,
                                    cache_index)


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
        if isinstance(x, (list, tuple)):  # the ring, in step over shards
            return _ring_layer([None if is_remote(xi) else self for xi in x],
                               x)
        y = self.ln1(x.float()).to(self.dtype)
        if cache is not None:
            y, new_cache = self.attn(y, cache, cache_index, page_table)
        else:
            y, new_cache = self.attn(y), None
        x = x + y
        x = x + self.mlp(self.ln2(x.float()).to(self.dtype))
        return x if new_cache is None else (x, new_cache)

    def _ring_tail(self, x):
        return x + self.mlp(self.ln2(x.float()).to(self.dtype))


def _ring_layer(views, xs):
    """One decoder block over the ring's shards, in step: shard ``j``
    through ``views[j]`` (the block, or its replica on shard ``j``'s
    card; None for another process's shard), the attention folding every
    shard's q/k/v through the ring."""
    hs = [x if v is None else v.ln1(x.float()).to(v.dtype)
          for v, x in zip(views, xs)]
    qs, ks, vs = zip(*((h,) * 3 if v is None else v.attn._heads(h)
                       for v, h in zip(views, hs)))
    out = ring_attention(qs, ks, vs, causal=True)
    return [x if v is None else v._ring_tail(x + v.attn.out(o.flatten(2)))
            for v, x, o in zip(views, xs, out)]


class CausalLM(nn.Module):
    """GPT-style decoder; see the module docstring for its two paths."""

    def __init__(self, vocab_size: int = 32000, max_len: int = 2048,
                 num_layers: int = 12, num_heads: int = 12, width: int = 768,
                 mlp_dim: int = 3072, dtype: torch.dtype = torch.bfloat16,
                 attention: str = "full", remat: str = "none",
                 precision: Optional[str] = None):
        super().__init__()
        validate_remat(remat)
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.width = width
        self.mlp_dim = mlp_dim
        self.attention, self.remat = attention, remat
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
        if isinstance(input_ids, (list, tuple)):
            return self._ring_forward(input_ids)
        ids = input_ids.long()
        t = ids.shape[1]
        if cache is None:
            x = remat_call(self.tok_embed, self.remat, ids, stem=True)
        else:
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
                x = remat_call(block, self.remat, x)
        logits = self.lm_head(self.ln_final(x.float()))
        return logits if cache is None else (logits, cache)

    def _ring_forward(self, blocks):
        """The sequence-parallel forward (module docstring): per-shard id
        blocks in, per-shard logits out."""
        if self.attention != "ring":
            raise ValueError(f"a list of sequence shards needs "
                             f"attention='ring', got {self.attention!r}")
        num, own = len(blocks), [b for b in blocks if not is_remote(b)]
        if not own:
            raise ValueError("a ring forward needs one block of this "
                             "process at least")
        t = own[0].shape[1]
        if any(b.shape != own[0].shape for b in own):
            raise ValueError("sequence shards must be equal blocks")
        # before any slicing: a short slice of the table would not fail
        if t * num > self.max_len:
            raise ValueError(f"global sequence {t}*{num} exceeds max_len "
                             f"{self.max_len}")
        home = self.pos_embed.device
        cards = list(dict.fromkeys(b.device for b in own if b.device != home))
        if cards and not all(d.type == "cuda" for d in cards + [home]):
            raise ValueError(
                f"sequence shards on {[str(b.device) for b in own]}, the "
                f"parameters on {home}: each shard of this process computes "
                f"on the parameters' device, or on another card of this "
                f"process (through a replica of the weights)")
        if len(own) < num and self.remat != "none":
            raise ValueError(
                f"remat={self.remat!r} over a ring that spans processes: a "
                f"recompute would repeat the ring's hops")
        if cards and self.remat != "none":
            raise ValueError(
                f"remat={self.remat!r} over a ring across cards of one "
                f"process: a recompute would run on the replicas")
        # a shard on another card than the parameters' computes through a
        # replica of the weights there (differentiable copies whose
        # gradients are summed back onto the parameters)
        on = {}
        if cards:
            replicas = replicate(self, [home] + cards,
                                 detach=not torch.is_grad_enabled())
            on = dict(zip(cards, replicas[1:]))
        views = [None if is_remote(b) else on.get(b.device, self)
                 for b in blocks]
        xs = [b if v is None else
              remat_call(v.tok_embed, self.remat, b.long(), stem=True)
              + v.pos_embed[j * t:(j + 1) * t].to(self.dtype)
              for j, (v, b) in enumerate(zip(views, blocks))]
        for i, block in enumerate(self.layers):
            if on:  # each shard through its card's block (remat is "none")
                xs = _ring_layer([None if v is None else v.layers[i]
                                  for v in views], xs)
            else:
                xs = remat_call(block, self.remat, xs)
        return [x if v is None else v.lm_head(v.ln_final(x.float()))
                for v, x in zip(views, xs)]


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, made on the CPU from ``generator`` and
    copied into ``model`` (a :class:`CausalLM`, or any module of its
    parts, as :class:`~distkeras_tpu_torch.parallel.pipeline.PipelinedLM`)
    in place, module by module in ``modules()`` order, then the position
    tables: Linear weights normal with std ``fan_in ** -0.5`` (flax's
    LeCun normal, untruncated), embeddings and positions (every parameter
    named ``pos_embed``) normal with std 0.02, biases zero, LayerNorm
    scale one."""
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
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] == "pos_embed":
                normal(p, 0.02)
    return model


def inference_copy(model: CausalLM, new: bool = False) -> CausalLM:
    """A copy of ``model`` for serving whose embedding and Dense weights
    are STORED in the compute dtype, so that their casts in ``forward``
    are no-ops: the same function (the float32 -> compute-dtype cast is
    deterministic) without one cast kernel per weight per call. The
    LayerNorms, positions and LM head stay float32. The copy does not
    follow later updates of ``model``; :func:`load_weights` writes new
    weights into it in place. A float32 model is returned as is (nothing
    to cast) unless ``new`` asks for a module of its own (a serving
    engine's weight bank)."""
    if model.dtype == torch.float32 and not new:
        return model
    out = copy.deepcopy(model)
    for m in out.modules():
        if isinstance(m, (Dense, Embed)):
            m.to(m.compute_dtype)
    return out


@torch.no_grad()
def load_weights(bank: torch.nn.Module, state_dict) -> None:
    """Copy ``state_dict`` (name -> tensor, the float32 masters of
    ``model.state_dict()``) into ``bank``'s own tensors IN PLACE, each
    cast to that tensor's dtype and device (an :func:`inference_copy`
    stores some in the compute dtype). The tensors keep their addresses,
    so CUDA graphs captured over ``bank`` run on the new weights; the
    cast is deterministic, so loading the same masters again gives the
    same bits. Runs on the current stream."""
    for name, own in bank.state_dict().items():
        own.copy_(state_dict[name])


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
    parameter). The extra LAST page is scratch. ``kv_dtype="int8"``
    stores int8 codes and adds float32 ``k_scale``/``v_scale``
    ``[num_pages + 1]`` (the attention path tells the format by them)."""
    if kv_dtype not in (None, "native", "int8"):
        raise ValueError(
            f"kv_dtype must be None, 'native', or 'int8', got {kv_dtype!r}")
    dtype = model.dtype if dtype is None else dtype
    if device is None:
        device = next(model.parameters()).device
    shape = (num_pages + 1, page_size, model.num_heads,
             model.width // model.num_heads)
    if kv_dtype == "int8":
        zeros = lambda *s, dt: torch.zeros(s, dtype=dt, device=device)
        return tuple({"k": zeros(*shape, dt=torch.int8),
                      "v": zeros(*shape, dt=torch.int8),
                      "k_scale": zeros(num_pages + 1, dt=torch.float32),
                      "v_scale": zeros(num_pages + 1, dt=torch.float32)}
                     for _ in range(model.num_layers))
    return tuple({"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)}
                 for _ in range(model.num_layers))


def page_bytes(model: CausalLM, page_size: int,
               dtype: Optional[torch.dtype] = None, kv_dtype=None) -> int:
    """Device bytes one logical page costs (k + v cells, every layer);
    under ``kv_dtype="int8"`` one byte a cell plus a float32 scale per
    layer and k/v."""
    if kv_dtype == "int8":
        return (2 * model.num_layers * page_size * model.width
                + 2 * model.num_layers * 4)
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
