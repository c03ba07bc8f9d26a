"""Paged attention: the hand-written Hopper kernel and its plain version.

Port of ``distkeras_tpu/ops/pallas/flash_attention.py``'s paged decode
kernel (``_paged_kernel`` / ``paged_flash_attention``). The function is
attention of an in-call query block over a shared KV page pool::

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

Dispatch: a CUDA tensor goes to the kernel (``csrc/paged_attention.cu``,
built on first use by :mod:`._build`); a CPU tensor goes to
:func:`paged_flash_attention_reference`. A build or launch failure raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from distkeras_tpu_torch.ops.attention import MASK_VALUE, dot_product_attention

#: dynamic shared memory one block may opt into on Hopper (H100 and H200:
#: 227 KiB of the SM's 256 KiB)
SMEM_OPTIN_BYTES = 232448
#: head_dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)
_TILE_Q, _CHUNK = 16, 64  # must match csrc/paged_attention.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from distkeras_tpu_torch.ops.kernels import _build

        lib = _build.load("paged_attention", ["paged_attention.cu"])
        lib.paged_attention_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def smem_bytes(max_len: int, head_dim: int) -> int:
    """Dynamic shared memory one block of the kernel uses: the f32 logits
    of a 16-query tile over every key, the query tile, and one staged
    64-key chunk (rows padded by one float)."""
    return 4 * (_TILE_Q * max_len + _TILE_Q * head_dim
                + _CHUNK * (head_dim + 1))


def paged_fits(q_shape, pages_shape, page_table_shape) -> bool:
    """Whether the kernel takes these shapes: matching heads and
    head_dim, a head_dim it is instantiated for, and a logits buffer
    within the card's opt-in shared memory."""
    if len(q_shape) != 4 or len(pages_shape) != 4 \
            or len(page_table_shape) != 2:
        return False
    _, _, h, d = q_shape
    _, ps, hp, dp = pages_shape
    if (h, d) != (hp, dp) or d not in KERNEL_HEAD_DIMS:
        return False
    return smem_bytes(page_table_shape[1] * ps, d) <= SMEM_OPTIN_BYTES


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
            f"{tuple(page_table.shape)} (head_dim in {KERNEL_HEAD_DIMS}, "
            f"{smem_bytes(page_table.shape[1] * k_pages.shape[1], q.shape[3])}"
            f" B of shared memory against {SMEM_OPTIN_BYTES})")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged_flash_attention: tensors must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_flash_attention: page pools must be 16-byte "
                         "aligned (the kernel reads them in 16-byte loads)")


def paged_flash_attention(q, k_pages, v_pages, page_table, cache_index):
    """Paged attention (module docstring): the Hopper kernel for CUDA
    tensors, the plain version for CPU tensors. Each kernel launch adds
    one to ``paged_flash_attention.launches``."""
    if q.device.type == "cpu":
        return paged_flash_attention_reference(q, k_pages, v_pages,
                                               page_table, cache_index)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention: no kernel for device "
                         f"{q.device}")
    _check(q, k_pages, v_pages, page_table, cache_index)
    lib = _kernel_lib()
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_table.data_ptr(), cache_index.data_ptr(),
            out.data_ptr(), b, t, h, d, k_pages.shape[1], page_table.shape[1],
            d ** -0.5, MASK_VALUE, stream)
    if err != 0:
        raise RuntimeError(
            f"paged attention kernel launch failed: cudaError {err} "
            f"({lib.paged_attention_error_string(err).decode()})")
    paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0
