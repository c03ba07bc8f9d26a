"""The int8 kernel's schedule (``int8_matmul.plan``), a pure function of
the shapes, output dtype and SM count that the CPU can check: every
card-test shape and every product of the int8 GPT train path gets a
plan, its shared memory fits one CTA's opt-in, the persistent CTAs
cover every output tile exactly once, and the epilogue's 16-byte stores
are chosen only where the output's row pitch allows them. The C entry
computes the same plan (``tests/test_torch_kernels_cuda.py`` holds the
two equal on the card). No JAX: the GPT products come from walking the
port's model on the meta device.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import precision
from distkeras_tpu_torch.models.gpt import CausalLM
from distkeras_tpu_torch.ops.kernels import int8_matmul as ti
from distkeras_tpu_torch.ops.kernels._build import SMEM_OPTIN_BYTES

H100_SMS = 132
DTYPES = [torch.bfloat16, torch.float32]
#: (m, k, n) of the int8 train path's products at 8 x 2048 tokens, in a
#: block's order: qkv, attention out, fc1, fc2
GPT_PRODUCTS = [(16384, 768, 2304), (16384, 768, 768), (16384, 768, 3072),
                (16384, 3072, 768)]
#: (m, k, n) of every int8 card test
CARD_SHAPES = [(16384, 768, 2304), (512, 3072, 768), (100, 48, 72),
               (3, 16, 5), (130, 96, 1), (257, 80, 129), (16384, 768, 768),
               (16384, 768, 3072), (16384, 3072, 768), (300, 784, 200),
               (129, 3088, 520), (16384 + 77, 768, 2304), (384, 3072, 512),
               (64, 48, 32), (4096, 768, 2304), (2048, 3072, 768),
               (1000, 784, 200), (4096, 768, 3072)]


def _gpt_int8_products(b=8, t=2048, num_layers=2):
    """The ``(m, k, n, out_dtype)`` of every int8 product of one forward
    of the int8 train path's model (GPT-2-small widths, bf16,
    ``precision="int8"``) on ``b`` x ``t`` tokens, walked on the meta
    device (no memory, no arithmetic)."""
    seen = []

    def record(qx, qw, sxw, out_dtype=torch.float32):
        seen.append((qx.shape[0], qx.shape[1], qw.shape[0], out_dtype))
        return torch.empty(qx.shape[0], qw.shape[0], dtype=out_dtype,
                           device=qx.device)

    with torch.device("meta"), mock.patch.object(
            precision.int8_kernels, "int8_matmul_dequant", record):
        model = CausalLM(vocab_size=50304, max_len=2048,
                         num_layers=num_layers, num_heads=12, width=768,
                         mlp_dim=3072, dtype=torch.bfloat16,
                         attention="full", precision="int8")
        model(torch.zeros(b, t, dtype=torch.long))
    return seen


def _assert_valid(m, k, n, dtype, p, sms=H100_SMS):
    """The rules of csrc/int8_matmul.cu ``make_plan``."""
    item = torch.finfo(dtype).bits // 8
    assert (p.block_m, p.block_n, p.block_k, p.stages, p.threads) == (
        ti.BLOCK_M, ti.BLOCK_N, ti.BLOCK_K, ti.STAGES, ti.THREADS), p
    assert p.tiles_m == -(-m // p.block_m) and p.tiles_n == -(-n // p.block_n)
    assert p.grid == min(p.tiles_m * p.tiles_n, sms) >= 1, p
    assert p.smem == ti.SMEM_BYTES <= SMEM_OPTIN_BYTES, p
    assert p.wide_store == (n * item % 16 == 0), p
    # a stage is one 128-byte swizzle row of K for each operand row
    assert p.block_k == 128 and p.block_m % 64 == 0, p


def test_the_gpt_path_runs_the_four_products():
    got = _gpt_int8_products()
    assert got == [(m, k, n, torch.bfloat16) for m, k, n in GPT_PRODUCTS] * 2


@pytest.mark.parametrize("m,k,n", GPT_PRODUCTS)
def test_every_gpt_product_gets_a_plan(m, k, n):
    p = ti.plan(m, n, k, torch.bfloat16, H100_SMS)
    _assert_valid(m, k, n, torch.bfloat16, p)
    assert p.grid == H100_SMS and p.wide_store, p


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", CARD_SHAPES)
def test_every_card_test_shape_gets_a_valid_plan(m, k, n, dtype):
    _assert_valid(m, k, n, dtype, ti.plan(m, n, k, dtype, H100_SMS))


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("m,n", [(3, 5), (130, 1), (257, 129), (1000, 264),
                                 (16384 + 77, 2304), (16384, 768)])
def test_persistent_ctas_cover_every_tile_exactly_once(m, n, sms):
    """CTA b takes tiles b, b + grid, ...; tile i is rows (i // tiles_n)
    * 128.. and columns (i % tiles_n) * 256..: every output element lies
    in exactly one tile, no tile starts outside the output, and the CTAs'
    counts differ by at most one."""
    p = ti.plan(m, n, 16, torch.bfloat16, sms)
    count = np.zeros((p.tiles_m * p.block_m, p.tiles_n * p.block_n),
                     dtype=np.int32)
    per_cta = []
    for cta in range(p.grid):
        tiles = range(cta, p.tiles_m * p.tiles_n, p.grid)
        per_cta.append(len(tiles))
        for i in tiles:
            m0 = (i // p.tiles_n) * p.block_m
            n0 = (i % p.tiles_n) * p.block_n
            assert m0 < m and n0 < n
            count[m0:m0 + p.block_m, n0:n0 + p.block_n] += 1
    assert (count[:m, :n] == 1).all() and count.sum() == count.size
    assert max(per_cta) - min(per_cta) <= 1 and sum(per_cta) == (
        p.tiles_m * p.tiles_n)


@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_stores_only_where_the_row_pitch_allows(dtype):
    item = torch.finfo(dtype).bits // 8
    for n in range(1, 300):
        p = ti.plan(64, n, 32, dtype, H100_SMS)
        assert p.wide_store == (n * item % 16 == 0), (n, p)


def test_plan_takes_what_fits_takes_and_refuses_the_rest():
    for m, k, n in [(1, 16, 1), (5, 4096, 7), (65535 * 128, 16, 3)]:
        assert ti.fits((m, k), (n, k))
        ti.plan(m, n, k, torch.bfloat16, H100_SMS)
    for m, k, n in [(4, 40, 4), (4, 0, 4), (4, 8, 4),
                    (65535 * 128 + 1, 16, 3)]:
        assert not ti.fits((m, k), (n, k))
        with pytest.raises(ValueError, match="no plan"):
            ti.plan(m, n, k, torch.bfloat16, H100_SMS)
    with pytest.raises(ValueError, match="no plan"):
        ti.plan(4, 4, 16, torch.float16, H100_SMS)
    with pytest.raises(ValueError, match="no plan"):
        ti.plan(4, 4, 16, torch.bfloat16, 0)


def test_shared_memory_holds_the_ring_and_the_epilogue():
    """1024 bytes to align, the stages of qx [128][128] and qw [256][128]
    int8, two 16-row x 128-byte output buffers for each of the eight
    consumer warps, a full and an empty mbarrier a stage: within the 227
    KiB a CTA may opt into, so one CTA an SM."""
    stage = (ti.BLOCK_M + ti.BLOCK_N) * ti.BLOCK_K
    assert ti.SMEM_BYTES == 1024 + ti.STAGES * stage + 8 * 2 * 16 * 128 \
        + 16 * ti.STAGES
    assert ti.SMEM_BYTES <= SMEM_OPTIN_BYTES < 2 * ti.SMEM_BYTES
