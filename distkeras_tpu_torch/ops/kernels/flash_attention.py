"""Attention kernels: the hand-written Hopper kernels and their plain
versions.

Port of ``distkeras_tpu/ops/pallas/flash_attention.py``. Two functions,
as in the JAX module:

- :func:`flash_attention` -- the TRAINING kernel: causal or full
  attention over ``[batch, t, heads, head_dim]`` with an online softmax,
  differentiable through a ``torch.autograd.Function`` whose backward
  recomputes the probability tiles from ``(q, k, lse)`` (three kernels:
  ``csrc/flash_attention_fwd.cu`` for ``_fwd_kernel``,
  ``csrc/flash_attention_bwd.cu`` for ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``). :func:`fits` is the JAX module's shape predicate.
- :func:`paged_flash_attention` -- attention of an in-call query block
  over a shared KV page pool (``csrc/paged_attention.cu`` for
  ``_paged_kernel``; two launches a call, split over the keys)::

    q            [batch, t, heads, head_dim]      (already scattered
    k_pages      [num_pages + 1, page_size, heads, head_dim]  into pages)
    v_pages      [num_pages + 1, page_size, heads, head_dim]
    page_table   [batch, pages_per_row] int32
    cache_index  [batch] int32
    -> out       [batch, t, heads, head_dim] in q's dtype

  where row ``b``'s logical key position ``p`` lives in
  ``pages[page_table[b, p // page_size], p % page_size]`` and query ``i``
  sees key ``p`` iff ``p <= cache_index[b] + i`` (the fixed-contraction-
  length masked softmax of the JAX package, not an online softmax).

Dispatch: a CUDA tensor goes to the kernel (built on first use by
:mod:`._build`); a CPU tensor goes to the plain version
(``*_reference``). A build or launch failure raises; nothing falls back.
Each kernel wrapper adds one to its ``launches`` count per launch; a call
recorded into a CUDA graph launches nothing and adds one to its
``captured`` count instead (the graph's owner adds the calls it captured
to ``launches`` at each replay).
"""

from __future__ import annotations

import ctypes

import torch

from distkeras_tpu_torch.ops.attention import MASK_VALUE, dot_product_attention
from distkeras_tpu_torch.ops.kernels import accounting

#: keys a CTA of the paged kernel covers (a split), by choice of the
#: wrapper; must match csrc/paged_attention.cu (multiples of its 64-key
#: chunk, at most 256)
SPLIT_KEYS = (64, 128, 256)
#: queries a CTA of the paged kernel takes
_TILE_Q = 16
#: split CTAs a call may have (batch rows x heads x splits) before the
#: next larger split size is taken: about six per SM of the H100's 132
#: (PERF.md: each split size timed at phase 3's shapes)
_MAX_SPLIT_CTAS = 768
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_flash_libs: dict = {}
_paged_counters: dict = {}
_retired_counters: list = []


def _kernel_lib():
    global _lib
    if _lib is None:
        from distkeras_tpu_torch.ops.kernels import _build

        lib = _build.load("paged_attention", ["paged_attention.cu"])
        lib.paged_attention_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def split_keys(max_len: int, heads_rows: int) -> int:
    """Keys a CTA of the paged kernel covers at this context length over
    ``heads_rows`` (batch rows x heads): the smallest of
    :data:`SPLIT_KEYS` that leaves at most ``_MAX_SPLIT_CTAS`` splits in
    all, else the largest. Fewer, longer splits pay less for the
    statistics and the partials' sum once the card is full. A function
    of the shapes only, never of the cursors."""
    for split in SPLIT_KEYS:
        if heads_rows * -(-max_len // split) <= _MAX_SPLIT_CTAS:
            return split
    return SPLIT_KEYS[-1]


def paged_fits(q_shape, pages_shape, page_table_shape) -> bool:
    """Whether the kernel takes these shapes: matching heads and
    head_dim, and ``1 <= head_dim <= 256`` (the largest instantiation).
    Any context length: nothing in the kernel grows with it."""
    if len(q_shape) != 4 or len(pages_shape) != 4 \
            or len(page_table_shape) != 2:
        return False
    _, _, h, d = q_shape
    _, _, hp, dp = pages_shape
    return (h, d) == (hp, dp) and 1 <= d <= 256


def paged_flash_attention_reference(q, k_pages, v_pages, page_table,
                                    cache_index):
    """Plain PyTorch version: gather each row's pages into a dense
    ``[batch, max_len, heads, head_dim]`` view and run the masked
    :func:`dot_product_attention` over it (the JAX package's dense-gather
    path)."""
    b, t, h, d = q.shape
    max_len = page_table.shape[1] * k_pages.shape[1]
    page_table = page_table.long()
    k = k_pages[page_table].reshape(b, max_len, h, d)
    v = v_pages[page_table].reshape(b, max_len, h, d)
    pos = (cache_index.long()[:, None]
           + torch.arange(t, device=q.device)[None, :])
    key_pos = torch.arange(max_len, device=q.device)
    mask = key_pos[None, None, None, :] <= pos[:, None, :, None]
    return dot_product_attention(q, k, v, mask=mask)


def paged_flops(q_shape, max_len: int) -> float:
    """FLOPs of one call, the plain version's count: q.k and p.v over
    every position of each row's page table."""
    b, t, h, d = q_shape
    return accounting.attention_flops(b, t, max_len, h, d, 2)


def paged_bytes(q, k_pages, page_table, cache_index) -> int:
    """Bytes of one call: q and the output, the page table and cursors,
    and the K and V pages the table names (what the plain version
    gathers)."""
    b, _, h, d = q.shape
    kv = 2 * b * page_table.shape[1] * k_pages.shape[1] * h * d \
        * k_pages.element_size()
    return 2 * accounting.tensor_bytes(q) + kv + accounting.tensor_bytes(
        page_table, cache_index)


def _check(q, k_pages, v_pages, page_table, cache_index):
    tensors = (q, k_pages, v_pages, page_table, cache_index)
    if any(x.device != q.device for x in tensors):
        raise ValueError("paged_flash_attention: all tensors must be on "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged_flash_attention: dtype {q.dtype} not "
                         f"supported (float32, bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_flash_attention: q and pages must share a "
                         "dtype")
    if page_table.dtype != torch.int32 or cache_index.dtype != torch.int32:
        raise ValueError("paged_flash_attention: page_table and "
                         "cache_index must be int32")
    if k_pages.shape != v_pages.shape:
        raise ValueError("paged_flash_attention: k/v page shapes differ")
    b = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(cache_index.shape) != (b,):
        raise ValueError("paged_flash_attention: page_table must be "
                         "[batch, pages_per_row] and cache_index [batch]")
    if not paged_fits(q.shape, k_pages.shape, page_table.shape):
        raise ValueError(
            f"paged_flash_attention: kernel does not take q {tuple(q.shape)}"
            f", pages {tuple(k_pages.shape)}, table "
            f"{tuple(page_table.shape)} (heads and head_dim must match, "
            f"1 <= head_dim <= 256)")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged_flash_attention: tensors must be contiguous")


def reserve_counters(device, stream: int, n: int = 4096) -> torch.Tensor:
    """The paged kernel's arrival counters for calls on ``stream`` (a
    ``cuda_stream`` handle) of ``device``: a persistent zeroed int32
    buffer of at least ``n`` entries, allocated or grown here. Each call
    leaves the entries it used at zero, so the calls of one stream,
    which run in turn, share it; each stream has its own. Grown, never
    shrunk. Call it before capturing a CUDA graph on ``stream``: a
    capture finds the buffer and never allocates one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # one key a card: a bare "cuda" is the current card
        device = torch.device("cuda", torch.cuda.current_device())
    buf = _paged_counters.get((device, stream))
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"paged attention: the arrival counters of stream "
                f"{stream:#x} hold {0 if buf is None else buf.numel()} of "
                f"the {n} entries this call needs, and a CUDA graph is "
                f"being captured: call reserve_counters before the "
                f"capture (an allocation here would land in the graph's "
                f"pool)")
        if buf is not None:
            # a graph captured earlier may hold the old buffer: keep it
            _retired_counters.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _paged_counters[(device, stream)] = buf
    return buf


def counters_needed(b: int, t: int, h: int) -> int:
    """Arrival counters a paged call over ``[b, t, h, *]`` queries uses
    (one a query tile of a row and head)."""
    return b * h * -(-t // _TILE_Q)


def paged_flash_attention(q, k_pages, v_pages, page_table, cache_index):
    """Paged attention (module docstring): the Hopper kernel for CUDA
    tensors, the plain version for CPU tensors. A kernel call is two
    launches (the split logits and statistics, then the normalized
    ``P . V`` with the partials' sum) and adds one to
    ``paged_flash_attention.launches``; a call recorded into a CUDA graph
    launches nothing and adds one to ``paged_flash_attention.captured``
    instead (the graph's owner counts its launches at each replay). The
    keys a CTA covers are :func:`split_keys` of the shapes."""
    if q.device.type == "cpu":
        return paged_flash_attention_reference(q, k_pages, v_pages,
                                               page_table, cache_index)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention: no kernel for device "
                         f"{q.device}")
    _check(q, k_pages, v_pages, page_table, cache_index)
    b, t, h, d = q.shape
    max_len = page_table.shape[1] * k_pages.shape[1]
    split = split_keys(max_len, b * h)
    nsplit = -(-max_len // split)
    lib = _kernel_lib()
    out = torch.empty_like(q)
    # one float32 workspace: the logits [b, h, t, nsplit * split], the
    # split statistics [2, b, h, t, nsplit] and the partials [b, h,
    # nsplit, t, d] (one allocation a call: serving is bound by the host)
    n_logits, n_stats = b * h * t * nsplit * split, 2 * b * h * t * nsplit
    ws = torch.empty(n_logits + n_stats + (b * h * nsplit * t * d
                                           if nsplit > 1 else 0),
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = reserve_counters(q.device, stream,
                                    counters_needed(b, t, h))
        err = lib.paged_attention_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_table.data_ptr(), cache_index.data_ptr(),
            out.data_ptr(), ws.data_ptr(), ws.data_ptr() + 4 * n_logits,
            ws.data_ptr() + 4 * (n_logits + n_stats), counters.data_ptr(),
            b, t, h, d,
            k_pages.shape[1], page_table.shape[1], split, d ** -0.5,
            MASK_VALUE, stream)
    if err != 0:
        raise RuntimeError(
            f"paged attention kernel launch failed: cudaError {err} "
            f"({lib.paged_attention_error_string(err).decode()})")
    if torch.cuda.is_current_stream_capturing():
        paged_flash_attention.captured += 1
    else:
        paged_flash_attention.launches += 1
    if accounting.active():
        accounting.note(
            "paged_flash_attention", paged_flops(q.shape, max_len),
            paged_bytes(q, k_pages, page_table, cache_index),
            (q, k_pages, v_pages, page_table, cache_index),
            paged_flash_attention_reference)
    return out


paged_flash_attention.launches = 0
paged_flash_attention.captured = 0


# -- training kernel: forward, dq, dk/dv ------------------------------------

_POINTER, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _flash_lib(part: str):
    """The built ``flash_attention_{fwd,bwd}`` library (``part``)."""
    if part not in _flash_libs:
        from distkeras_tpu_torch.ops.kernels import _build

        lib = _build.load(f"flash_attention_{part}",
                          [f"flash_attention_{part}.cu"])
        tail = [_INT] * 4 + [_FLOAT, _FLOAT, _INT, _POINTER]  # b, t, h, d, ...
        sigs = {"fwd": {"flash_attention_fwd_launch": 5},
                "bwd": {"flash_attention_bwd_dq_launch": 7,
                        "flash_attention_bwd_dkv_launch": 8}}[part]
        for fn, pointers in sigs.items():
            getattr(lib, fn).argtypes = [_INT] + [_POINTER] * pointers + tail
            getattr(lib, fn).restype = _INT
        err_fn = getattr(lib, f"flash_attention_{part}_error_string")
        err_fn.argtypes = [_INT]
        err_fn.restype = ctypes.c_char_p
        _flash_libs[part] = lib
    return _flash_libs[part]


def fits(q_shape) -> bool:
    """The JAX module's predicate at its default 128-row blocks
    (``flash_attention.py:97-110``), kept so that the same shapes take
    the kernel in both packages: a ``[batch, t, heads, head_dim]`` shape
    with ``t >= 128``, ``t`` a multiple of 128 and ``8 <= head_dim <=
    128``, ``head_dim % 8 == 0`` (the Hopper kernels need ``t % 64 ==
    0``)."""
    if len(q_shape) != 4:
        return False
    _, t, _, d = q_shape
    return t >= 128 and t % 128 == 0 and 8 <= d <= 128 and d % 8 == 0


def _logits(q, k, causal):
    """f32 ``[b, h, tq, tk]`` logits of both kernels: ``q . k`` in f32
    times ``head_dim ** -0.5``, MASK_VALUE where causal and ``i < j``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        q.shape[-1] ** -0.5)
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, MASK_VALUE)
    return s


def flash_attention_reference(q, k, v, causal: bool = True):
    """Plain version of the forward kernel: ``(out, lse)`` from an exact
    (not online) masked softmax in f32, P rounded to the input dtype
    before ``P . V`` as in the kernel, ``out`` in q's dtype and ``lse``
    f32 ``[b, h, t]``."""
    s = _logits(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    out = pv / l.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_delta(out, dout):
    """``delta = rowsum(dout * out)`` in f32, ``[b, h, t]``: the
    backward's correction term, from the forward's output in its own
    dtype upcast to f32 (``flash_attention.py:341``). Plain torch on
    every device, as in the JAX package."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()


def _probs_and_ds(q, k, v, dout, lse, delta, causal):
    p = torch.exp(_logits(q, k, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta,
                                     causal: bool = True):
    """Plain version of the dq kernel: ``(ds . k) * scale`` in q's dtype,
    with ``p = exp(s - lse)`` and ``ds = p * (dout . v^T - delta)``, every
    product in f32."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * (
        q.shape[-1] ** -0.5)
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                      causal: bool = True):
    """Plain version of the dk/dv kernel: ``((ds^T . q) * scale,
    p^T . dout)`` in k's and v's dtypes, every product in f32."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * (
        q.shape[-1] ** -0.5)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                  causal: bool = True):
    """Plain version of the whole backward: ``(dq, dk, dv)``."""
    delta = flash_attention_delta(out, dout)
    dq = flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                               causal)
    return dq, dk, dv


def _check_flash(name, tensors, rows=()):
    """Raise ValueError on what the training kernels do not take:
    ``tensors`` are ``[b, t, h, d]`` of one shape and dtype, ``rows``
    f32 ``[b, h, t]``; all contiguous, 16-byte aligned, on one device."""
    q = tensors[0]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (float32, "
                         f"bfloat16)")
    if not fits(q.shape):
        raise ValueError(f"{name}: kernel does not take shape "
                         f"{tuple(q.shape)} (fits(): t >= 128, t % 128 == 0,"
                         f" 8 <= head_dim <= 128, head_dim % 8 == 0)")
    b, t, h, _ = q.shape
    for x in tensors:
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"{name}: q, k, v (and dout) must share shape "
                             f"and dtype")
    for x in rows:
        if tuple(x.shape) != (b, h, t) or x.dtype != torch.float32:
            raise ValueError(f"{name}: lse and delta must be float32 "
                             f"[b, h, t]")
    for x in (*tensors, *rows):
        if x.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte"
                             f" aligned (the kernels read 16-byte vectors)")


def _launch_flash(part, fn, wrapper, args, shape, causal, device):
    lib = _flash_lib(part)
    b, t, h, d = shape
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, b, t, h, d, d ** -0.5, MASK_VALUE,
                               int(causal), stream)
    if err != 0:
        msg = getattr(lib, f"flash_attention_{part}_error_string")(err)
        raise RuntimeError(f"{fn} failed: cudaError {err} ({msg.decode()})")
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1  # the graph's owner counts each replay
    else:
        wrapper.launches += 1


#: products a (batch, head) of each training kernel (accounting)
FLASH_PRODUCTS = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 3,
                  "flash_attention_bwd_dkv": 4}


def flash_flops(name: str, q_shape) -> float:
    """FLOPs of one call of a training kernel, the plain version's
    count: its ``[t, t] x d`` products over the whole square, masked
    causal blocks included (the JAX package's count of the same call)."""
    b, t, h, d = q_shape
    return accounting.attention_flops(b, t, t, h, d, FLASH_PRODUCTS[name])


def _note_flash(name, inputs, outputs, plain):
    q = inputs[0]
    accounting.note(name, flash_flops(name, q.shape),
                    accounting.tensor_bytes(*inputs, *outputs), inputs,
                    plain)


def _require_cuda(name, device):
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")


def flash_attention_fwd(q, k, v, causal: bool = True):
    """Forward: ``(out, lse)``; the Hopper kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    _require_cuda("flash_attention_fwd", q.device)
    _check_flash("flash_attention_fwd", (q, k, v))
    b, t, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _launch_flash("fwd", "flash_attention_fwd_launch", flash_attention_fwd,
                  (_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), lse.data_ptr()),
                  q.shape, causal, q.device)
    if accounting.active():
        _note_flash("flash_attention_fwd", (q, k, v), (out, lse),
                    lambda *a: flash_attention_reference(*a, causal))
    return out, lse


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True):
    """dq: the Hopper kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta,
                                                causal)
    _require_cuda("flash_attention_bwd_dq", q.device)
    _check_flash("flash_attention_bwd_dq", (q, k, v, dout), (lse, delta))
    dq = torch.empty_like(q)
    _launch_flash("bwd", "flash_attention_bwd_dq_launch",
                  flash_attention_bwd_dq,
                  (_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), dq.data_ptr()),
                  q.shape, causal, q.device)
    if accounting.active():
        _note_flash("flash_attention_bwd_dq",
                    (q, k, v, dout, lse, delta), (dq,),
                    lambda *a: flash_attention_bwd_dq_reference(*a, causal))
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True):
    """``(dk, dv)``: the Hopper kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                                 causal)
    _require_cuda("flash_attention_bwd_dkv", q.device)
    _check_flash("flash_attention_bwd_dkv", (q, k, v, dout), (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_flash("bwd", "flash_attention_bwd_dkv_launch",
                  flash_attention_bwd_dkv,
                  (_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
                  q.shape, causal, q.device)
    if accounting.active():
        _note_flash("flash_attention_bwd_dkv",
                    (q, k, v, dout, lse, delta), (dk, dv),
                    lambda *a: flash_attention_bwd_dkv_reference(*a, causal))
    return dk, dv


flash_attention_fwd.launches = flash_attention_fwd.captured = 0
flash_attention_bwd_dq.launches = flash_attention_bwd_dq.captured = 0
flash_attention_bwd_dkv.launches = flash_attention_bwd_dkv.captured = 0


class _FlashAttention(torch.autograd.Function):
    """The JAX module's ``custom_vjp`` (``_flash``): the forward saves
    ``(q, k, v, out, lse)``; the backward takes ``delta`` in plain torch
    and runs the dq and dk/dv passes."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_attention_delta(out, dout)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """Differentiable fused attention over ``[batch, t, heads, head_dim]``
    (self-attention: q, k, v of one shape). Raises ValueError for a shape
    :func:`fits` rejects, on every device, as the JAX function does; the
    kernels take CUDA tensors, the plain versions CPU tensors."""
    if not fits(q.shape) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention: fits() rejected q {tuple(q.shape)} (k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}: t >= 128, t % 128 == 0,"
            f" 8 <= head_dim <= 128, head_dim % 8 == 0); the port has no "
            f"silent fallback, use the plain attention for such shapes")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal)
