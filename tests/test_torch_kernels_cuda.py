"""The Hopper paged-attention kernel against its plain version, on a card.

Skipped without a CUDA device (the kernel has no CPU mode; the plain
version's agreement with the JAX package is tests/test_torch_paged_attention.py).
This file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Bounds: float32 (TF32 off) 1e-5 abs, bf16 2e-2 abs.
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.ops.kernels import flash_attention as tfa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t", [(1, 2), (8, 2), (1, 128)])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, atol, b,
                                              t):
    """The Hopper kernel against its plain version at gpt_small's
    attention shapes (h=12, d=64, page_size 16, 64 pages a row)."""
    h, d, ps, pmax = 12, 64, 16, 64
    rng = np.random.default_rng(b * 1000 + t)
    num_pages = b * pmax
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda_device, dtype)
    q, k, v = mk(b, t, h, d), mk(num_pages + 1, ps, h, d), \
        mk(num_pages + 1, ps, h, d)
    table = rng.permutation(num_pages + 1)[:b * pmax].reshape(b, pmax)
    ci = rng.integers(0, pmax * ps - t + 1, size=b)
    args = (q, k, v, torch.from_numpy(table.astype(np.int32)).to(cuda_device),
            torch.from_numpy(ci.astype(np.int32)).to(cuda_device))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = tfa.paged_flash_attention(*args)
        want = tfa.paged_flash_attention_reference(*args)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    err = (got.float() - want.float()).abs().max().item()
    assert err <= atol, err


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 2, 16, device=cuda_device)
    pages = torch.zeros(17, 16, 2, 16, device=cuda_device)
    table = torch.zeros(1, 8, dtype=torch.int32, device=cuda_device)
    ci = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    before = tfa.paged_flash_attention.launches
    with pytest.raises(ValueError, match="does not take"):
        tfa.paged_flash_attention(q, pages, pages, table, ci)  # head_dim 16
    with pytest.raises(ValueError, match="int32"):
        tfa.paged_flash_attention(q, pages, pages, table.long(), ci)
    assert tfa.paged_flash_attention.launches == before


@pytest.mark.cuda
def test_paged_equals_contiguous_with_identity_table(cuda_device):
    """With an identity page table the kernel reads the pool as one
    contiguous cache: the same call on a permuted pool with the matching
    permuted table gives bitwise the same output."""
    h, d, ps, pmax = 12, 64, 16, 8
    rng = np.random.default_rng(9)
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda_device)
    q, k, v = mk(1, 2, h, d), mk(pmax + 1, ps, h, d), mk(pmax + 1, ps, h, d)
    ci = torch.tensor([pmax * ps - 2], dtype=torch.int32, device=cuda_device)
    ident = torch.arange(pmax, dtype=torch.int32,
                         device=cuda_device)[None, :]
    perm = torch.from_numpy(rng.permutation(pmax)).to(cuda_device)
    kp, vp = k.clone(), v.clone()
    kp[perm], vp[perm] = k[:pmax], v[:pmax]
    table = perm.to(torch.int32)[None, :]
    a = tfa.paged_flash_attention(q, k, v, ident, ci)
    b = tfa.paged_flash_attention(q, kp, vp, table, ci)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
