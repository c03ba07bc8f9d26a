"""The port's paged attention against the JAX package's.

The plain PyTorch version (what a CPU tensor runs, and what the Hopper
kernel is held to on the card) must agree with the JAX Pallas kernel run
in interpret mode and with the JAX dense-gather path, on the same numpy
inputs: random permuted page tables whose unmapped entries point at the
scratch page, several cache cursors, decode (t=2) and prefill-like (t=8)
blocks, at head_dims 16 and 96 and at a 4096-key context (the JAX dense
path where the JAX kernel's own VMEM gate declines). Bound: 1e-6 abs at
float32 (they differ only in summation order).

The Hopper kernel splits the keys over CTAs (split-K) and combines the
splits' softmax statistics; a test-local emulation of that algebra is
held against the plain version here, before the card runs it: 2e-6 abs
at float32 (summation order), 2e-2 abs at bf16 (the card bound; P and the
output rounded to bf16 after sums taken in another order).
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


def _inputs(b, t, cache_index, seed, h=H, d=D, ps=PS, pmax=PMAX):
    rng = np.random.default_rng(seed)
    num_pages = b * pmax  # + 1 scratch page below
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((num_pages + 1, ps, h, d)).astype(np.float32)
    v = rng.standard_normal((num_pages + 1, ps, h, d)).astype(np.float32)
    table = rng.permutation(num_pages)[:b * pmax].reshape(b, pmax)
    # entries past each row's reach point at the scratch page, as the
    # pool leaves them
    for row, ci in enumerate(cache_index):
        used = -(-(ci + t) // ps)
        table[row, used:] = num_pages
    return (q, k, v, table.astype(np.int32),
            np.asarray(cache_index, np.int32))


def _jax_dense(q, k, v, table, ci):
    b, t, h, d = q.shape
    max_len = table.shape[1] * k.shape[1]
    gather = lambda pages: jnp.asarray(pages)[table].reshape(b, max_len, h,
                                                             d)
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
    ((1, 2, 12, 64), (1025, 16, 12, 64), (1, 256), True),  # 4096 keys
    ((1, 2, 2, 16), (17, 16, 2, 16), (1, 8), True),  # head_dim 16
    ((1, 2, 12, 64), (1025, 16, 6, 64), (1, 64), False),  # heads differ
    ((1, 2, 8, 96), (65, 16, 8, 96), (1, 64), True),  # head_dim 96
    ((1, 2, 12, 64), (2049, 16, 12, 64), (1, 2048), True),  # 32768 keys
    ((1, 2, 2, 264), (17, 16, 2, 264), (1, 8), False),  # head_dim > 256
    ((1, 2, 2, 136), (17, 16, 2, 136), (1, 8), True),  # head_dim 136
    ((8, 2, 4, 256), (129, 16, 4, 256), (8, 16), True),  # head_dim 256
])
def test_paged_fits(q_shape, pages_shape, table_shape, fits):
    assert tfa.paged_fits(q_shape, pages_shape, table_shape) is fits


@pytest.mark.parametrize("h,d,ps,pmax,t,cache_index", [
    (2, 16, 16, 4, 8, (2, 51)),        # head_dim 16 (gpt_tiny), prefill
    (2, 96, 16, 4, 2, (7, 60)),        # head_dim 96, decode
    (2, 16, 64, 64, 2, (4093, 1500)),  # 4096 keys, decode
])
def test_reference_matches_jax_at_new_head_dims_and_long_context(
        h, d, ps, pmax, t, cache_index):
    """The shapes the split-K kernel opened on the card: the plain version
    against the JAX kernel in interpret mode where the JAX kernel's VMEM
    gate takes the shape, else against the JAX dense path, and always
    against the dense path."""
    q, k, v, table, ci = _inputs(2, t, cache_index, seed=d + pmax, h=h, d=d,
                                 ps=ps, pmax=pmax)
    got = tfa.paged_flash_attention_reference(
        *map(torch.from_numpy, (q, k, v, table, ci))).numpy()
    assert got.shape == (2, t, h, d)
    np.testing.assert_allclose(got, _jax_dense(q, k, v, table, ci), rtol=0,
                               atol=ATOL)
    if jfa.paged_fits(q.shape, k.shape, table.shape):
        want = np.asarray(jfa.paged_flash_attention(
            *map(jnp.asarray, (q, k, v, table, ci)), interpret=True))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _split_k(q, k_pages, v_pages, table, ci, split, tile_q=16):
    """Test-local emulation of the Hopper kernel's split-K algebra
    (csrc/paged_attention.cu): per 16-query tile, the keys it sees cut in
    splits of ``split``; per split and query the max and the sum of
    exp(x - max) over its visible keys; the row's max and sum combined
    from those in split order; P = exp(x - m) / l rounded to the input
    dtype; one float32 partial P . V a split, summed in split order."""
    b, t, h, d = q.shape
    dtype = q.dtype
    max_len = table.shape[1] * k_pages.shape[1]
    k = k_pages[table.long()].reshape(b, max_len, h, d)
    v = v_pages[table.long()].reshape(b, max_len, h, d)
    x = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * d ** -0.5
    out = torch.zeros(b, t, h, d)
    for row in range(b):
        c = int(ci[row])
        for q0 in range(0, t, tile_q):
            nq = min(tile_q, t - q0)
            n_keys = min(max_len, c + q0 + nq)
            xt = x[row, :, q0:q0 + nq, :n_keys]                 # [h, nq, n]
            vis = (torch.arange(n_keys)[None, :]
                   <= c + q0 + torch.arange(nq)[:, None])       # [nq, n]
            xt = torch.where(vis, xt, tattn.MASK_VALUE)
            splits = range(0, n_keys, split)
            stats = []
            for k0 in splits:
                xs = torch.where(vis[:, k0:k0 + split], xt[..., k0:k0 + split],
                                 -torch.inf)
                m_s = xs.amax(-1)
                l_s = torch.where(torch.isfinite(xs), torch.exp(
                    xs - m_s[..., None]), 0.0).sum(-1)
                stats.append((m_s, l_s))
            m = stats[0][0]
            for m_s, _ in stats[1:]:
                m = torch.maximum(m, m_s)
            l = torch.zeros_like(m)
            for m_s, l_s in stats:
                l = l + l_s * torch.exp(m_s - m)
            acc = torch.zeros(nq, h, d)
            for k0 in splits:
                p = torch.exp(xt[..., k0:k0 + split] - m[..., None]) \
                    / l[..., None]
                p = p.to(dtype).float()                         # [h, nq, s]
                acc = acc + torch.einsum(
                    "hqk,khd->qhd", p,
                    v[row, k0:min(k0 + split, n_keys)].float())
            out[row, q0:q0 + nq] = acc
    return out.to(dtype)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-6),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("split", [16, 64])
@pytest.mark.parametrize("t,cache_index", [(2, (0, 93)), (20, (37, 100))])
def test_split_k_algebra_matches_plain_version(dtype, atol, split, t,
                                               cache_index):
    """The kernel's design checked on the CPU: the split statistics, the
    combine, P normalized before it is rounded and the partials' sum give
    the plain version's output (t = 20 spans two query tiles; a cursor
    of 0 leaves one live split)."""
    q, k, v, table, ci = _inputs(2, t, cache_index, seed=split + t, pmax=8)
    args = [torch.from_numpy(a) for a in (q, k, v, table, ci)]
    args[:3] = [a.to(dtype) for a in args[:3]]
    got = _split_k(*args, split=split)
    want = tfa.paged_flash_attention_reference(*args)
    assert got.dtype == want.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= atol, err


def test_split_size_follows_the_shapes():
    """The paged kernel's split size is a function of the shapes (context
    length, batch rows x heads), never of the cursors: short contexts at
    small batch take the finest split, long ones or large batches
    coarser ones, and every choice is one the kernel takes."""
    assert tfa.split_keys(1024, 12) == 64        # decode b=1, gpt_small
    assert tfa.split_keys(1024, 96) == 128       # decode b=8
    assert tfa.split_keys(4096, 96) == 256
    assert tfa.split_keys(32768, 12) == 256
    assert tfa.split_keys(128, 4) == 64          # gpt_tiny
    assert all(tfa.split_keys(n, r) in tfa.SPLIT_KEYS
               for n in (16, 1000, 1 << 20) for r in (1, 100, 10000))
