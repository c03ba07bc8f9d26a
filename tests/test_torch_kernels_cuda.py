"""The Hopper kernels against their plain versions, on a card.

Skipped without a CUDA device (the kernels have no CPU mode; the plain
versions' agreement with the JAX package is
tests/test_torch_paged_attention.py, tests/test_torch_flash_attention.py,
tests/test_torch_int8.py and tests/test_torch_groupnorm.py).
This file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Bounds: paged attention float32 (TF32 off) 1e-5 abs, bf16 2e-2 abs and
2**-6 * max|ref| (a few bf16 ulps of the largest output: over tens of
thousands of keys the outputs shrink to a few hundredths), and bitwise
from one call to the next (the split partials summed in split order).
Training flash attention: float32 out and lse 1e-5 abs, grads
1e-4 * max|ref| + 1e-5 (summation order only); bf16 out 2e-2 abs (P
rounded to bf16 at other places than the exact softmax of the plain
version), lse 1e-5 abs (1e-5 of its magnitude for logits in the
hundreds), grads 2e-2 * max|ref| (the outputs' bf16 rounding: the bf16
backward's products are float32-accurate through the three-term split);
forward and backward bitwise from one launch to the next (no atomics).
Scaled
int8 product: bitwise (an exact int32 sum and one rounding on both
sides). GroupNorm: float32 y and stats
1e-5 abs, dx and the dgamma/dbeta partials 1e-5 * max(1, max|ref|)
(summation order); bf16 y 2e-2 abs, dx and partials 2e-2 * max|ref|; and
y, dx and the partials bitwise, the stats within one float32 ulp (float64
sums rounded once, the plain version's operation order).
"""

import math

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import precision as tprecision
from distkeras_tpu_torch.ops.kernels import flash_attention as tfa
from distkeras_tpu_torch.ops.kernels import groupnorm as tgn
from distkeras_tpu_torch.ops.kernels import int8_matmul as tk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda:0")


def _paged_args(dev, dtype, b, t, h, d, ps, pmax, seed):
    """q, pools, table and cursors: tables drawn from every page including
    the scratch page, cursors random with room for the block."""
    rng = np.random.default_rng(seed)
    num_pages = b * pmax
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    q, k, v = mk(b, t, h, d), mk(num_pages + 1, ps, h, d), \
        mk(num_pages + 1, ps, h, d)
    table = rng.permutation(num_pages + 1)[:b * pmax].reshape(b, pmax)
    ci = rng.integers(0, pmax * ps - t + 1, size=b)
    return (q, k, v, torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(ci.astype(np.int32)).to(dev))


def _assert_paged_close(args, atol):
    """The kernel within ``atol`` of its plain version, and in bf16 also
    within 2**-6 of the plain version's largest output."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = tfa.paged_flash_attention(*args)
        want = tfa.paged_flash_attention_reference(*args)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    bound = atol
    if got.dtype == torch.bfloat16:
        bound = min(atol, 2 ** -6 * want.float().abs().max().item())
    assert err <= bound, (err, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t", [(1, 2), (8, 2), (1, 128)])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, atol, b,
                                              t):
    """The Hopper kernel against its plain version at gpt_small's
    attention shapes (h=12, d=64, page_size 16, 64 pages a row)."""
    args = _paged_args(cuda_device, dtype, b, t, 12, 64, 16, 64,
                       b * 1000 + t)
    _assert_paged_close(args, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t,h,d,ps,pmax", [
    (4, 2, 2, 16, 16, 8),        # gpt_tiny's head_dim, decode
    (1, 40, 2, 16, 16, 8),       # ... and a three-tile prefill
    (4, 2, 8, 96, 16, 64),       # head_dim 96
    (2, 17, 8, 96, 16, 64),      # ... prefill, a ragged tile
    (8, 2, 12, 64, 16, 256),     # 4096 keys
    (1, 2, 12, 64, 16, 2048),    # 32768 keys
    (2, 3, 4, 20, 8, 16),        # 40-byte rows in bf16: narrow loads
    (8, 2, 4, 256, 16, 16),      # head_dim 256, decode
    (1, 40, 2, 256, 16, 8),      # ... a three-tile prefill
    (2, 2, 2, 200, 16, 8),       # head_dim 200 (zero-padded to 256)
])
def test_kernel_takes_any_head_dim_and_context(cuda_device, dtype, atol, b,
                                               t, h, d, ps, pmax):
    """Shapes the split-K kernel takes where the first version raised:
    head_dims other than 32, 64, 128 and 256 (zero-padded to the 64, 128
    or 256 instantiation) and contexts whose logits row outgrew shared
    memory."""
    args = _paged_args(cuda_device, dtype, b, t, h, d, ps, pmax,
                       b + t + d + pmax)
    _assert_paged_close(args, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("split", tfa.SPLIT_KEYS)
def test_kernel_at_every_split_size(cuda_device, dtype, atol, split):
    """Each split size the wrapper may choose, at 4096 keys over 12, 24
    and 48 (row, head) pairs, which make it choose 64, 128 and 256 keys
    (16 to 64 splits a row, so the partials' sum runs)."""
    b = split // 64
    assert tfa.split_keys(4096, b * 12) == split
    args = _paged_args(cuda_device, dtype, b, 2, 12, 64, 16, 256, split)
    _assert_paged_close(args, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_is_deterministic(cuda_device, dtype):
    """The partials are summed in split order by whichever CTA arrives
    last: two calls give the same bits."""
    args = _paged_args(cuda_device, dtype, 8, 2, 12, 64, 16, 256, 7)
    a = tfa.paged_flash_attention(*args)
    b = tfa.paged_flash_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_paged_kernel_on_two_streams_at_once(cuda_device):
    """Calls queued on two streams at once (each stream has its own
    arrival counters) give the bits of the same calls on one stream."""
    calls = [_paged_args(cuda_device, torch.bfloat16, 8, 2, 12, 64, 16, 256,
                         seed) for seed in range(4)]
    want = [tfa.paged_flash_attention(*args) for args in calls]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    got = [None] * len(calls)
    for _ in range(8):
        for i, args in enumerate(calls):
            with torch.cuda.stream(streams[i % 2]):
                got[i] = tfa.paged_flash_attention(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 2, 264, device=cuda_device)
    pages = torch.zeros(17, 16, 2, 264, device=cuda_device)
    table = torch.zeros(1, 8, dtype=torch.int32, device=cuda_device)
    ci = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    before = tfa.paged_flash_attention.launches
    with pytest.raises(ValueError, match="does not take"):
        tfa.paged_flash_attention(q, pages, pages, table, ci)  # head_dim 264
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


# -- training flash attention (forward, dq, dk/dv) ---------------------------

def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _flash_inputs(shape, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev, dtype) for _ in range(4)]


def _close(got, want, dtype, grad):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        bound = 1e-4 * scale + 1e-5 if grad else 1e-5
    else:
        bound = 2e-2 * scale if grad else 2e-2
    assert err <= bound, (err, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal", [
    ((1, 128, 12, 64), True), ((2, 256, 12, 64), False),
    ((2, 256, 3, 32), True), ((1, 384, 2, 128), True),
    ((1, 256, 2, 72), False), ((1, 128, 1, 8), True),
    ((1, 128, 2, 128), True), ((1, 128, 2, 128), False),
    ((2, 256, 3, 128), True), ((2, 256, 3, 128), False)])
def test_flash_kernels_match_plain_versions_on_card(cuda_device, dtype,
                                                    shape, causal):
    """Each of the three training kernels against its plain version on
    the same inputs (the backward ones fed the plain forward's lse and
    delta), at head_dims that take both instantiations (64, 128) and the
    zero-padded features (8, 32, 72). t = 128 and 256 at head_dim 128
    are one and two of the bf16 backward's CTA tiles (two warpgroups of
    64 rows: a causal dq CTA's last key tile and a dk/dv CTA's first
    query tile are each seen by one warpgroup only); at head_dim 64 a
    CTA tile is 64 rows, so t = 128, the least fits() takes, is two."""
    _no_tf32()
    q, k, v, dout = _flash_inputs(shape, dtype, cuda_device, sum(shape))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    _close(o, o_ref, dtype, grad=False)
    _close(lse, lse_ref, torch.float32, grad=False)
    delta = tfa.flash_attention_delta(o_ref, dout)
    dq = tfa.flash_attention_bwd_dq(q, k, v, dout, lse_ref, delta, causal)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, dout, lse_ref, delta,
                                         causal)
    dq_ref = tfa.flash_attention_bwd_dq_reference(q, k, v, dout, lse_ref,
                                                  delta, causal)
    dk_ref, dv_ref = tfa.flash_attention_bwd_dkv_reference(
        q, k, v, dout, lse_ref, delta, causal)
    torch.cuda.synchronize()
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == dtype
        _close(got, want, dtype, grad=True)


def _flash_backward(q, k, v, dout, causal):
    """The backward kernels and their plain versions on the same inputs
    (the plain forward's lse and delta): ((dq, dk, dv), (refs))."""
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal)
    delta = tfa.flash_attention_delta(o_ref, dout)
    args = (q, k, v, dout, lse_ref, delta, causal)
    got = (tfa.flash_attention_bwd_dq(*args),
           *tfa.flash_attention_bwd_dkv(*args))
    want = (tfa.flash_attention_bwd_dq_reference(*args),
            *tfa.flash_attention_bwd_dkv_reference(*args))
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_is_deterministic(cuda_device, dtype, d):
    """No atomics: two launches on the same inputs give the same bits."""
    q, k, v, dout = _flash_inputs((2, 384, 4, d), dtype, cuda_device, d)
    first, _ = _flash_backward(q, k, v, dout, True)
    second, _ = _flash_backward(q, k, v, dout, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_with_wide_logits(cuda_device, d, causal):
    """q and k scaled by 8, so that the probabilities span many decades
    and every term of the bf16 split of p and ds carries weight."""
    _no_tf32()
    q, k, v, dout = _flash_inputs((1, 256, 2, d), torch.bfloat16,
                                  cuda_device, 11 + d)
    q, k = q * 8, k * 8
    got, want = _flash_backward(q, k, v, dout, causal)
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        _close(g, w, torch.bfloat16, grad=True)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [128, 256, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_bf16_matches_plain_version(cuda_device, d, causal,
                                                  t):
    """The bf16 forward (wgmma) at both instantiations, causal and full,
    from one CTA tile to the training length: out within 2e-2 (p rounded
    to bf16 against the running, not the final, max; out rounded once),
    lse within 1e-5 (float32 sums in another order)."""
    _no_tf32()
    q, k, v, _ = _flash_inputs((2, t, 3, d), torch.bfloat16, cuda_device,
                               t + d)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(o, o_ref, torch.bfloat16, grad=False)
    _close(lse, lse_ref, torch.float32, grad=False)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_with_wide_logits(cuda_device, d, causal):
    """q and k scaled by 8, so that the running max moves between key
    tiles by many units and the rescale alpha = exp(m_prev - m_next)
    carries weight: out within 2e-2, lse within 1e-5 of its magnitude
    (float32 sums of logits in the hundreds)."""
    _no_tf32()
    q, k, v, _ = _flash_inputs((1, 256, 2, d), torch.bfloat16, cuda_device,
                               23 + d)
    q, k = q * 8, k * 8
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    _close(o, o_ref, torch.bfloat16, grad=False)
    err = (lse - lse_ref).abs().max().item()
    assert err <= 1e-5 * max(1.0, lse_ref.abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_is_deterministic(cuda_device, dtype, d):
    """No atomics: two launches on the same inputs give the same bits."""
    q, k, v, _ = _flash_inputs((2, 384, 4, d), dtype, cuda_device, d + 1)
    first = tfa.flash_attention_fwd(q, k, v, True)
    second = tfa.flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_autograd_goes_through_the_three_kernels(cuda_device):
    """``flash_attention`` under autograd on the card: one launch of each
    kernel, and grads within the float32 bound of the plain backward."""
    _no_tf32()
    q, k, v, dout = _flash_inputs((2, 128, 2, 64), torch.float32,
                                  cuda_device, 5)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    counts = [f.launches for f in (tfa.flash_attention_fwd,
                                   tfa.flash_attention_bwd_dq,
                                   tfa.flash_attention_bwd_dkv)]
    out = tfa.flash_attention(q, k, v, causal=True)
    out.backward(dout)
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(
        (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
         tfa.flash_attention_bwd_dkv), counts)] == [1, 1, 1]
    o_ref, lse_ref = tfa.flash_attention_reference(q.detach(), k.detach(),
                                                   v.detach(), True)
    want = tfa.flash_attention_bwd_reference(q.detach(), k.detach(),
                                             v.detach(), o_ref, lse_ref,
                                             dout, True)
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        _close(got, ref, torch.float32, grad=True)


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_do_not_take(cuda_device):
    before = tfa.flash_attention_fwd.launches
    q = torch.zeros(1, 192, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="does not take"):
        tfa.flash_attention_fwd(q, q, q)  # t % 128 != 0
    q = torch.zeros(1, 128, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float16"):
        tfa.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 128, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(q.transpose(1, 2).contiguous()
                                .transpose(1, 2), q, q)
    assert tfa.flash_attention_fwd.launches == before


# -- scaled int8 product ------------------------------------------------------

def _int8_inputs(m, k, n, dev, seed):
    rng = np.random.default_rng(seed)
    qx = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    sxw = torch.tensor(rng.uniform(1e-4, 1e-2), dtype=torch.float32)
    return qx.to(dev), qw.to(dev), sxw.to(dev)


#: GPT-2-small's four block products at 8 x 2048 rows (qkv, out, fc1, fc2)
INT8_GPT_SHAPES = [(16384, 768, 2304), (16384, 768, 768), (16384, 768, 3072),
                   (16384, 3072, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(16384, 768, 2304), (512, 3072, 768),
                                   (100, 48, 72), (3, 16, 5), (130, 96, 1),
                                   (257, 80, 129), *INT8_GPT_SHAPES[1:],
                                   (300, 784, 200), (129, 3088, 520),
                                   (16384 + 77, 768, 2304)])
def test_int8_kernel_bitwise_equals_plain_version(cuda_device, out_dtype,
                                                  m, k, n):
    """GPT-2-small's four products, a K=3072 shape, ragged M, N and K
    tails (K a multiple of 16, not of the 128-deep slice: 16, 48, 80,
    784, 3088), and a last row of tiles left ragged after several
    persistent waves (16384 + 77 rows)."""
    qx, qw, sxw = _int8_inputs(m, k, n, cuda_device, m + k + n)
    got = tk.int8_matmul_dequant(qx, qw, sxw, out_dtype)
    want = tk.int8_matmul_dequant_reference(qx, qw, sxw, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_kernel_with_saturated_codes(cuda_device, out_dtype):
    """Every code +-127 at K = 3072: int32 sums up to 127^2 * 3072 (~4.95e7,
    beyond float32's 2^24), all-positive rows and columns among them."""
    m, k, n = 384, 3072, 512
    rng = np.random.default_rng(11)
    qx = np.where(rng.random((m, k)) < 0.5, -127, 127).astype(np.int8)
    qw = np.where(rng.random((n, k)) < 0.5, -127, 127).astype(np.int8)
    qx[:7], qw[:5] = 127, 127
    qw[5:9] = -127
    qx, qw = (torch.from_numpy(a).to(cuda_device) for a in (qx, qw))
    sxw = torch.tensor(3.1e-5, dtype=torch.float32, device=cuda_device)
    got = tk.int8_matmul_dequant(qx, qw, sxw, out_dtype)
    want = tk.int8_matmul_dequant_reference(qx, qw, sxw, out_dtype)
    torch.cuda.synchronize()
    assert want.float().abs().max().item() == pytest.approx(
        127 * 127 * k * 3.1e-5, rel=1e-2)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_int8_kernel_is_deterministic(cuda_device):
    """Two calls on the same inputs give the same bits."""
    qx, qw, sxw = _int8_inputs(*INT8_GPT_SHAPES[0], cuda_device, 5)
    a = tk.int8_matmul_dequant(qx, qw, sxw, torch.bfloat16)
    b = tk.int8_matmul_dequant(qx, qw, sxw, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_int8_kernel_on_two_streams_at_once(cuda_device):
    """Calls queued on two streams at once (each call has its own tensor
    maps, passed by value) give the bits of the plain version."""
    calls = [_int8_inputs(m, k, n, cuda_device, seed) for seed, (m, k, n)
             in enumerate([(4096, 768, 2304), (2048, 3072, 768),
                           (1000, 784, 200), (4096, 768, 3072)])]
    want = [tk.int8_matmul_dequant_reference(*args, torch.bfloat16)
            for args in calls]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    got = [None] * len(calls)
    for _ in range(4):
        for i, args in enumerate(calls):
            with torch.cuda.stream(streams[i % 2]):
                got[i] = tk.int8_matmul_dequant(*args, torch.bfloat16)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_kernel_takes_the_plan_of_the_host(cuda_device, out_dtype):
    """The C entry's schedule (``int8_matmul_plan``) is ``plan`` of the
    card's SM count at every shape of these tests."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for m, k, n in [(100, 48, 72), (3, 16, 5), (130, 96, 1), (257, 80, 129),
                    (129, 3088, 520), (16384 + 77, 768, 2304),
                    *INT8_GPT_SHAPES]:
        assert tk.kernel_plan(m, n, k, out_dtype, cuda_device) == tk.plan(
            m, n, k, out_dtype, sms)


@pytest.mark.cuda
def test_int8_kernel_rejects_what_it_does_not_take(cuda_device):
    qx, qw, sxw = _int8_inputs(64, 48, 32, cuda_device, 0)
    before = tk.int8_matmul_dequant.launches
    with pytest.raises(ValueError, match="does not take"):
        tk.int8_matmul_dequant(qx[:, :40].contiguous(),
                               qw[:, :40].contiguous(), sxw)  # K % 16
    with pytest.raises(ValueError, match="int8"):
        tk.int8_matmul_dequant(qx.int(), qw, sxw)
    with pytest.raises(ValueError, match="contiguous"):
        tk.int8_matmul_dequant(qx.t().contiguous().t(), qw, sxw)
    with pytest.raises(ValueError, match="out_dtype"):
        tk.int8_matmul_dequant(qx, qw, sxw, torch.float16)
    assert tk.int8_matmul_dequant.launches == before


@pytest.mark.cuda
def test_scaled_int8_matmul_on_card_equals_cpu(cuda_device):
    """The Dense product under precision="int8" (quantize, kernel) on the
    card against the same function on the CPU, bitwise, and its STE
    gradients within the bf16 bound."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 64, 96)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((48, 96)).astype(
        np.float32)).bfloat16()
    before = tk.int8_matmul_dequant.launches
    got = tprecision.scaled_int8_matmul(x.to(cuda_device), w.to(cuda_device))
    torch.cuda.synchronize()
    assert tk.int8_matmul_dequant.launches == before + 1
    assert torch.equal(got.cpu(), tprecision.scaled_int8_matmul(x, w))


# -- GroupNorm ----------------------------------------------------------------

def _gn_inputs(shape, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    x, dy = mk(*shape).to(dev, dtype), mk(*shape).to(dev, dtype)
    gamma = (1.0 + 0.1 * mk(c)).to(dev)
    beta = (0.1 * mk(c)).to(dev)
    return x, gamma, beta, dy


def _gn_close(got, want, dtype, relative):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        bound = 1e-5 * max(1.0, scale) if relative else 1e-5
    else:
        bound = 2e-2 * scale if relative else 2e-2
    assert err <= bound, (err, bound)


def _gn_against_plain(shape, groups, dtype, dev, seed=None):
    """Both kernels against their plain versions on seeded inputs (seed
    ``sum(shape)`` by default): the bounds, then y, dx and the partials
    bitwise and the stats within one float32 ulp."""
    _no_tf32()
    x, gamma, beta, dy = _gn_inputs(shape, dtype, dev,
                                    sum(shape) if seed is None else seed)
    y, stats = tgn.group_norm_fwd(x, gamma, beta, groups)
    y_ref, stats_ref = tgn.group_norm_fwd_reference(x, gamma, beta, groups,
                                                    1e-6)
    dx, dgp, dbp = tgn.group_norm_bwd(x, gamma, stats_ref, dy, groups)
    dx_ref, dgp_ref, dbp_ref = tgn.group_norm_bwd_reference(
        x, gamma, stats_ref, dy, groups)
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == dtype and stats.dtype == torch.float32
    _gn_close(y, y_ref, dtype, relative=False)
    _gn_close(stats, stats_ref, torch.float32, relative=True)
    for got, want in ((dx, dx_ref), (dgp, dgp_ref), (dbp, dbp_ref)):
        _gn_close(got, want, dtype, relative=True)
    for got, want in ((y, y_ref), (dx, dx_ref), (dgp, dgp_ref),
                      (dbp, dbp_ref)):
        assert torch.equal(got, want)
    # every sum is float64 rounded once, but a value far below its
    # group's others can leave the float64 sum of mu inexact: one ulp
    ulp = torch.nextafter(stats_ref.abs(), torch.full_like(stats_ref,
                                                           math.inf))
    assert ((stats - stats_ref).abs() <= ulp - stats_ref.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [
    ((4, 3136, 256), 32), ((4, 49, 2048), 32), ((2, 12544, 64), 32),
    ((2, 784, 128), 32), ((2, 784, 512), 32), ((2, 196, 1024), 32),
    ((3, 10, 24), 8), ((2, 7, 48), 16), ((2, 100, 512), 4),
    ((1, 60000, 64), 32), ((2, 7, 8192), 2)])
def test_groupnorm_kernels_match_plain_versions_on_card(cuda_device, dtype,
                                                        shape, groups):
    """Forward and backward kernels against their plain versions, at
    ResNet-50 shapes (every C/G class: 8, 64, 2, 4, 16, 32; the cluster
    path), at odd ones (C/G = 3 with chunks across groups, C/G = 128) and
    on the streaming path (a slab the cluster cannot hold; one group of
    4096 channels, wider than 256 chunks, split across column blocks)."""
    _gn_against_plain(shape, groups, dtype, cuda_device)


@pytest.mark.cuda
def test_groupnorm_mean_rounds_as_the_plain_version_on_card(cuda_device):
    """The plain version's ``sum / n`` runs on the card as a multiply by
    the float64 reciprocal, which rounds some groups' mean to another
    float32 than a division: seed 0 at [64, 49, 64] float32 (n = 98) has
    such groups. The kernels multiply the same way: y, dx and the
    partials bitwise, mu equal."""
    shape, groups = (64, 49, 64), 32
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    s = torch.from_numpy(x).double().reshape(64, 49, groups, 2).sum((1, 3))
    assert ((s / 98).float() != (s * (1.0 / 98)).float()).any()
    _gn_against_plain(shape, groups, torch.float32, cuda_device, seed=0)
    x = torch.from_numpy(x).to(cuda_device)
    gamma = torch.ones(64, device=cuda_device)
    _, stats = tgn.group_norm_fwd(x, gamma, gamma, groups)
    _, want = tgn.group_norm_fwd_reference(x, gamma, gamma, groups, 1e-6)
    assert torch.equal(stats[:, 0], want[:, 0])


@pytest.mark.cuda
def test_groupnorm_kernels_take_what_the_old_gate_refused(cuda_device):
    """[1, 60000, 64] float32, once refused for a (sample, group) slab
    above 227 KiB, runs on the kernels (the streaming path), one count a
    call, and matches the plain versions bitwise."""
    plan = tgn.plan((1, 60000, 64), 32, torch.float32, backward=True)
    assert plan.path == "stream"
    before = (tgn.group_norm_fwd.launches, tgn.group_norm_bwd.launches)
    _gn_against_plain((1, 60000, 64), 32, torch.float32, cuda_device)
    assert (tgn.group_norm_fwd.launches - before[0],
            tgn.group_norm_bwd.launches - before[1]) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 12544, 64), (4, 3136, 256),
                                   (1, 60000, 64)])
def test_groupnorm_kernels_are_deterministic(cuda_device, dtype, shape):
    """Two calls give the same bits (partials summed in rank or tile
    order, no atomics), on the cluster path and the streaming one."""
    x, gamma, beta, dy = _gn_inputs(shape, dtype, cuda_device, 3)
    outs = []
    for _ in range(2):
        y, stats = tgn.group_norm_fwd(x, gamma, beta, 32)
        outs.append((y, stats, *tgn.group_norm_bwd(x, gamma, stats, dy, 32)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.cuda
def test_groupnorm_autograd_goes_through_both_kernels(cuda_device):
    x, gamma, beta, dy = _gn_inputs((2, 196, 64), torch.float32,
                                    cuda_device, 4)
    x, gamma, beta = (t.requires_grad_() for t in (x, gamma, beta))
    counts = (tgn.group_norm_fwd.launches, tgn.group_norm_bwd.launches)
    tgn.group_norm(x, gamma, beta, 32).backward(dy)
    torch.cuda.synchronize()
    assert (tgn.group_norm_fwd.launches - counts[0],
            tgn.group_norm_bwd.launches - counts[1]) == (1, 1)
    _, stats = tgn.group_norm_fwd_reference(x.detach(), gamma.detach(),
                                            beta.detach(), 32, 1e-6)
    dx, dgp, dbp = tgn.group_norm_bwd_reference(x.detach(), gamma.detach(),
                                                stats, dy, 32)
    for got, want in ((x.grad, dx), (gamma.grad, dgp.sum(0)),
                      (beta.grad, dbp.sum(0))):
        _gn_close(got, want, torch.float32, relative=True)


@pytest.mark.cuda
def test_groupnorm_kernels_reject_what_they_do_not_take(cuda_device):
    before = (tgn.group_norm_fwd.launches, tgn.group_norm_bwd.launches)
    g = torch.ones(64, device=cuda_device)
    x = torch.zeros(2, 10, 24, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float16"):
        tgn.group_norm_fwd(x, g[:24], g[:24], 8)
    x = torch.zeros(2, 24, 10, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tgn.group_norm_bwd(x, g[:24], torch.zeros(2, 2, 8,
                                                  device=cuda_device),
                           x, 8)
    assert (tgn.group_norm_fwd.launches,
            tgn.group_norm_bwd.launches) == before
