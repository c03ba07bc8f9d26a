"""Scaled int8 matrix product: the hand-written Hopper kernel and its
plain version.

Port of ``distkeras_tpu/ops/pallas/int8_matmul.py``: the product of the
``int8`` precision policy (``precision._int8_dot_impl``)::

    qx   int8 [M, K]
    qw   int8 [N, K]      (the nn.Linear layout; the JAX kernel takes the
                           transpose, [K, N])
    sxw  float32, one element on the operands' device (sx * sw)
    -> out [M, N] = float32(sum_k qx[m, k] * qw[n, k]) * sxw, rounded
       once to ``out_dtype`` (float32 or bfloat16)

The int32 sum is exact and converted to float32 round-to-nearest, so the
kernel (``csrc/int8_matmul.cu``) and the plain version agree bitwise.
The kernel runs ``wgmma`` s8 on operands that TMA copies into swizzled
shared memory, in persistent CTAs that walk 128 x 256 output tiles;
:func:`plan` is its schedule for a call (the C entry computes the same
one, which ``int8_matmul_plan`` reports on the card).

Dispatch: a CUDA tensor goes to the kernel (built on first use by
:mod:`._build`), a CPU tensor to the plain version. A build or launch
failure raises; nothing falls back. Each launch adds one to
``int8_matmul_dequant.launches``. Unlike the JAX module there is no
switch that routes a card tensor past the kernel: on the card the
kernel computes this function for every call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from distkeras_tpu_torch.ops.kernels import accounting

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's tile (output rows, output columns, int8 of K a stage),
#: ring stages, threads a CTA (a producer and two consumer warpgroups)
#: and dynamic shared memory (1024 to align, the stages, two 16-row x
#: 128-byte output buffers for each of the 8 consumer warps, a full and
#: an empty mbarrier a stage): csrc/int8_matmul.cu
BLOCK_M, BLOCK_N, BLOCK_K, STAGES, THREADS = 128, 256, 128, 4, 384
SMEM_BYTES = (1024 + STAGES * (BLOCK_M + BLOCK_N) * BLOCK_K
              + 8 * 2 * 16 * 128 + 2 * STAGES * 8)

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from distkeras_tpu_torch.ops.kernels import _build

        lib = _build.load("int8_matmul", ["int8_matmul.cu"])
        lib.int8_matmul_dequant_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.int8_matmul_dequant_launch.restype = ctypes.c_int
        lib.int8_matmul_plan.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
        lib.int8_matmul_plan.restype = ctypes.c_int
        lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fits(x_shape, w_shape) -> bool:
    """Whether the kernel takes ``qx`` of ``x_shape`` and ``qw`` of
    ``w_shape``: both 2-D, one K, K a positive multiple of 16 (the
    kernel's 16-byte copies). M and N may be ragged."""
    if len(x_shape) != 2 or len(w_shape) != 2:
        return False
    m, k = x_shape
    n, k2 = w_shape
    return k == k2 and k >= 16 and k % 16 == 0 and m >= 1 and n >= 1 \
        and -(-m // 128) <= 65535


class Plan(NamedTuple):
    """How the kernel computes one call: ``tiles_m`` x ``tiles_n`` output
    tiles of ``block_m`` x ``block_n``, K in slices of ``block_k`` through
    a ring of ``stages``; ``grid`` persistent CTAs of ``threads`` threads
    and ``smem`` bytes of dynamic shared memory, CTA b taking tiles b, b +
    grid, ... (tile i at row tile i // tiles_n, column tile i % tiles_n);
    ``wide_store``: the output's row pitch is a multiple of 16 bytes, so
    the epilogue stores by TMA, else a value at a time."""
    block_m: int
    block_n: int
    block_k: int
    stages: int
    tiles_m: int
    tiles_n: int
    grid: int
    wide_store: bool
    threads: int
    smem: int


def plan(m: int, n: int, k: int, out_dtype, num_sms: int) -> Plan:
    """The schedule of ``qx [m, k] @ qw [n, k].T`` into ``out_dtype`` on a
    card of ``num_sms`` streaming multiprocessors (csrc/int8_matmul.cu
    ``make_plan``). Raises ValueError for what the kernel does not take."""
    if out_dtype not in _OUT_CODES or not fits((m, k), (n, k)) \
            or num_sms < 1:
        raise ValueError(f"int8_matmul_dequant: no plan for m={m}, n={n}, "
                         f"k={k}, {out_dtype}, {num_sms} SMs")
    tiles_m, tiles_n = -(-m // BLOCK_M), -(-n // BLOCK_N)
    if tiles_m * tiles_n >= 2 ** 31:
        raise ValueError(f"int8_matmul_dequant: {tiles_m} x {tiles_n} "
                         f"tiles overflow the tile index")
    itemsize = torch.finfo(out_dtype).bits // 8
    return Plan(BLOCK_M, BLOCK_N, BLOCK_K, STAGES, tiles_m, tiles_n,
                min(tiles_m * tiles_n, num_sms), n * itemsize % 16 == 0,
                THREADS, SMEM_BYTES)


def kernel_plan(m: int, n: int, k: int, out_dtype, device=None) -> Plan:
    """The schedule the built kernel takes for these arguments on the
    current CUDA device (``int8_matmul_plan``), to hold :func:`plan` to."""
    lib = _kernel_lib()
    fields = (ctypes.c_int * len(Plan._fields))()
    with torch.cuda.device(device):
        err = lib.int8_matmul_plan(_OUT_CODES[out_dtype], m, n, k, fields)
    if err != 0:
        raise ValueError(f"int8_matmul_plan: cudaError {err} "
                         f"({lib.int8_matmul_error_string(err).decode()})")
    p = Plan._make(fields)
    return p._replace(wide_store=bool(p.wide_store))


def int8_matmul_dequant_reference(qx, qw, sxw, out_dtype=torch.float32):
    """Plain version: the exact integer product (an int32 ``matmul`` on
    the CPU; on the card, where integer ``matmul`` does not exist, float64
    products, exact for K < 5e11, then int32), converted to float32, times
    ``sxw``, then ``out_dtype``."""
    if qx.device.type == "cpu":
        acc = torch.matmul(qx.int(), qw.int().t())
    else:
        acc = torch.matmul(qx.double(), qw.double().t()).to(torch.int32)
    return (acc.float() * sxw.float().reshape(())).to(out_dtype)


def _check(qx, qw, sxw, out_dtype):
    name = "int8_matmul_dequant"
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise ValueError(f"{name}: qx and qw must be int8")
    if sxw.dtype != torch.float32 or sxw.numel() != 1:
        raise ValueError(f"{name}: sxw must be one float32 element")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"{name}: out_dtype {out_dtype} not supported "
                         f"(float32, bfloat16)")
    if qw.device != qx.device or sxw.device != qx.device:
        raise ValueError(f"{name}: all tensors must be on {qx.device}")
    if not fits(qx.shape, qw.shape):
        raise ValueError(f"{name}: kernel does not take qx "
                         f"{tuple(qx.shape)}, qw {tuple(qw.shape)} (2-D, "
                         f"[M, K] and [N, K], K a positive multiple of 16)")
    if not (qx.is_contiguous() and qw.is_contiguous()) \
            or qx.data_ptr() % 16 or qw.data_ptr() % 16:
        raise ValueError(f"{name}: qx and qw must be contiguous and 16-byte "
                         f"aligned (the kernel copies 16-byte chunks)")


def int8_matmul_dequant(qx, qw, sxw, out_dtype=torch.float32):
    """``float32(qx @ qw.T) * sxw`` in ``out_dtype`` (module docstring):
    the Hopper kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if qx.device.type == "cpu":
        return int8_matmul_dequant_reference(qx, qw, sxw, out_dtype)
    if qx.device.type != "cuda":
        raise ValueError(f"int8_matmul_dequant: no kernel for device "
                         f"{qx.device}")
    _check(qx, qw, sxw, out_dtype)
    lib = _kernel_lib()
    m, k = qx.shape
    n = qw.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=qx.device)
    with torch.cuda.device(qx.device):
        stream = torch.cuda.current_stream(qx.device).cuda_stream
        err = lib.int8_matmul_dequant_launch(
            _OUT_CODES[out_dtype], qx.data_ptr(), qw.data_ptr(),
            sxw.data_ptr(), out.data_ptr(), m, n, k, stream)
    if err != 0:
        raise RuntimeError(
            f"int8 matmul kernel launch failed: cudaError {err} "
            f"({lib.int8_matmul_error_string(err).decode()})")
    int8_matmul_dequant.launches += 1
    if accounting.active():
        accounting.note(
            "int8_matmul_dequant", accounting.matmul_flops(m, n, k),
            accounting.tensor_bytes(qx, qw, sxw, out), (qx, qw, sxw),
            lambda *a: int8_matmul_dequant_reference(*a, out_dtype))
    return out


int8_matmul_dequant.launches = 0
