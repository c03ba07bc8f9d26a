"""The port's paged attention against the JAX package's.

The plain PyTorch version (what a CPU tensor runs, and what the Hopper
kernel is held to on the card) must agree with the JAX Pallas kernel run
in interpret mode and with the JAX dense-gather path, on the same numpy
inputs: random permuted page tables whose unmapped entries point at the
scratch page, several cache cursors, decode (t=2) and prefill-like (t=8)
blocks. Bound: 1e-6 abs at float32 (the three differ only in summation
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops import attention as jattn
from distkeras_tpu.ops.pallas import flash_attention as jfa
from distkeras_tpu_torch.ops import attention as tattn
from distkeras_tpu_torch.ops.kernels import flash_attention as tfa

H, D, PS, PMAX = 2, 16, 16, 4
ATOL = 1e-6


def _inputs(b, t, cache_index, seed):
    rng = np.random.default_rng(seed)
    num_pages = b * PMAX  # + 1 scratch page below
    q = rng.standard_normal((b, t, H, D)).astype(np.float32)
    k = rng.standard_normal((num_pages + 1, PS, H, D)).astype(np.float32)
    v = rng.standard_normal((num_pages + 1, PS, H, D)).astype(np.float32)
    table = rng.permutation(num_pages)[:b * PMAX].reshape(b, PMAX)
    # entries past each row's reach point at the scratch page, as the
    # pool leaves them
    for row, ci in enumerate(cache_index):
        used = -(-(ci + t) // PS)
        table[row, used:] = num_pages
    return (q, k, v, table.astype(np.int32),
            np.asarray(cache_index, np.int32))


def _jax_dense(q, k, v, table, ci):
    b, t = q.shape[:2]
    max_len = PMAX * PS
    gather = lambda pages: jnp.asarray(pages)[table].reshape(b, max_len, H,
                                                             D)
    pos = ci[:, None] + np.arange(t)[None, :]
    mask = (np.arange(max_len)[None, None, None, :]
            <= pos[:, None, :, None])
    return np.asarray(jattn.dot_product_attention(
        jnp.asarray(q), gather(k), gather(v), mask=jnp.asarray(mask)))


@pytest.mark.parametrize("t", [2, 8])
@pytest.mark.parametrize("cache_index", [(0, 5), (17, 40), (3, 56)])
def test_reference_matches_jax_interpret_kernel_and_dense_path(
        t, cache_index):
    q, k, v, table, ci = _inputs(2, t, cache_index, seed=sum(cache_index))
    got = tfa.paged_flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), torch.from_numpy(ci)).numpy()
    want_kernel = np.asarray(jfa.paged_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(ci), interpret=True))
    want_dense = _jax_dense(q, k, v, table, ci)
    assert got.shape == (2, t, H, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_dense, rtol=0, atol=ATOL)


def test_cpu_dispatch_runs_plain_version_and_counts_no_launch():
    q, k, v, table, ci = _inputs(2, 2, (9, 30), seed=3)
    args = [torch.from_numpy(a) for a in (q, k, v, table, ci)]
    before = tfa.paged_flash_attention.launches
    got = tfa.paged_flash_attention(*args)
    assert tfa.paged_flash_attention.launches == before
    torch.testing.assert_close(
        got, tfa.paged_flash_attention_reference(*args), rtol=0, atol=0)


def test_masked_keys_carry_no_weight():
    """Garbage past each row's cursor (and in the scratch page) must not
    reach the output: the fixed-length mask gives it exactly zero
    weight."""
    q, k, v, table, ci = _inputs(2, 2, (4, 20), seed=5)
    args = [torch.from_numpy(a) for a in (q, k, v, table, ci)]
    base = tfa.paged_flash_attention_reference(*args)
    k2, v2 = args[1].clone(), args[2].clone()
    for row in range(2):
        for p in range(int(ci[row]) + 2, PMAX * PS):
            page, off = table[row, p // PS], p % PS
            k2[page, off] = 1e4
            v2[page, off] = -1e4
    got = tfa.paged_flash_attention_reference(args[0], k2, v2, *args[3:])
    torch.testing.assert_close(got, base, rtol=0, atol=0)


def test_dot_product_attention_matches_jax_and_shares_mask_value():
    assert tattn.MASK_VALUE == jattn.MASK_VALUE
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
               for _ in range(3))
    got = tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                      causal=True).numpy()
    want = np.asarray(jattn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), causal=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("q_shape,pages_shape,table_shape,fits", [
    ((8, 2, 12, 64), (1025, 16, 12, 64), (8, 64), True),   # gpt_small
    ((1, 128, 12, 64), (1025, 16, 12, 64), (1, 64), True),
    ((1, 2, 12, 64), (1025, 16, 12, 64), (1, 128), True),  # 2048 keys
    ((1, 2, 12, 64), (1025, 16, 12, 64), (1, 256), False),  # 4096 keys
    ((1, 2, 2, 16), (17, 16, 2, 16), (1, 8), False),  # head_dim 16
    ((1, 2, 12, 64), (1025, 16, 6, 64), (1, 64), False),  # heads differ
])
def test_paged_fits(q_shape, pages_shape, table_shape, fits):
    assert tfa.paged_fits(q_shape, pages_shape, table_shape) is fits
