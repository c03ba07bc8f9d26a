"""The port's training flash attention against the JAX package's.

The plain versions (what a CPU tensor runs, and what the Hopper kernels
are held to on the card) must agree with the JAX Pallas kernels run in
interpret mode, on the same numpy inputs:

- forward (out and lse): 1e-5 abs at float32 (online against exact
  softmax, summation order only), 2e-2 abs at bf16 (P rounded to bf16 at
  other places);
- backward, through ``torch.autograd`` on the CPU (the port's own
  ``autograd.Function`` running the plain dq and dk/dv passes) against
  ``jax.grad`` through the interpret-mode kernels, of ``sum(sin(out))``:
  rtol 1e-4, atol 1e-5 (the bounds of tests/test_flash_attention.py);
- the shape predicate and the dispatch switch: the same shapes fit on
  both sides; the port raises where the JAX switch falls back silently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops import attention as jattn
from distkeras_tpu.ops.pallas import flash_attention as jfa
from distkeras_tpu_torch.ops import attention as tattn
from distkeras_tpu_torch.ops.kernels import flash_attention as tfa


def _qkv(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 2, 32), (1, 256, 2, 16)])
def test_plain_forward_matches_jax_interpret_kernel(shape, causal):
    """64 x 64 blocks: four key blocks a query block on the JAX side, so
    its online rescale runs; out and lse both compared."""
    q, k, v = _qkv(shape, seed=sum(shape))
    want_o, want_lse = jfa._fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, 64, 64, True)
    got_o, got_lse = tfa.flash_attention_reference(
        *map(torch.from_numpy, (q, k, v)), causal)
    assert got_o.dtype == torch.float32 and got_lse.dtype == torch.float32
    assert tuple(got_lse.shape) == (shape[0], shape[2], shape[1])
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=0, atol=1e-5)


def test_plain_forward_bf16_tracks_jax_interpret_kernel():
    q, k, v = _qkv((1, 128, 2, 32), seed=2)
    want = jfa.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                 for x in (q, k, v)),
                               causal=True, interpret=True)
    got, _ = tfa.flash_attention_reference(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_through_autograd_matches_jax_grad(causal):
    q, k, v = _qkv((2, 128, 2, 32), seed=3)

    def jloss(a, b, c):
        return jnp.sum(jnp.sin(jfa.flash_attention(a, b, c, causal=causal,
                                                   interpret=True)))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = tfa.flash_attention_fwd.launches
    torch.sin(tfa.flash_attention(tq, tk, tv, causal)).sum().backward()
    assert tfa.flash_attention_fwd.launches == before  # CPU: plain versions
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name}")


def test_backward_passes_match_jax_bwd_impl():
    """The plain dq and dk/dv passes (and delta) against the JAX
    package's own backward, fed the same residuals."""
    q, k, v, do = _qkv((1, 256, 2, 16), seed=4, n=4)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jfa._fwd_impl(jq, jk, jv, True, 64, 64, True)
    want = jfa._bwd_impl(jq, jk, jv, o, lse, jdo, True, 64, 64, True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    to, tlse = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))
    got = tfa.flash_attention_bwd_reference(tq, tk, tv, to, tlse, tdo, True)
    delta = tfa.flash_attention_delta(to, tdo)
    wrapped = (tfa.flash_attention_bwd_dq(tq, tk, tv, tdo, tlse, delta),
               *tfa.flash_attention_bwd_dkv(tq, tk, tv, tdo, tlse, delta))
    for g, w, r, name in zip(got, wrapped, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        assert torch.equal(g, w), name  # the CPU wrappers are the plain versions


@pytest.mark.parametrize("shape", [
    (2, 128, 2, 32), (1, 256, 4, 64), (1, 384, 1, 128), (1, 128, 1, 8),
    (1, 64, 2, 32), (1, 192, 2, 32), (1, 100, 2, 32), (1, 128, 2, 136),
    (1, 128, 2, 4), (1, 128, 2, 12), (128, 2, 32)])
def test_fits_agrees_with_jax(shape):
    assert tfa.fits(shape) == jfa.fits(shape)


def test_flash_dispatch_raises_where_jax_falls_back():
    """JAX's "flash" switch silently runs the XLA path for an unfit shape
    or a mask; the port raises ValueError for both."""
    assert tattn.ATTENTION_MODES == jattn.ATTENTION_MODES
    assert tattn.resolve_attention(None) == jattn.resolve_attention(None)
    with pytest.raises(ValueError):
        tattn.resolve_attention("ring")
    q = torch.zeros(1, 64, 2, 32)
    with pytest.raises(ValueError, match="fits"):
        tattn.apply_attention(q, q, q, causal=True, attention="flash")
    q = torch.zeros(1, 128, 2, 32)
    with pytest.raises(ValueError, match="mask"):
        tattn.apply_attention(q, q, q, mask=torch.ones(1, 128, dtype=bool),
                              attention="flash")
    with pytest.raises(ValueError, match="fits"):
        tfa.flash_attention(torch.zeros(1, 64, 2, 32),
                            torch.zeros(1, 64, 2, 32),
                            torch.zeros(1, 64, 2, 32))


def test_xla_dispatch_is_the_plain_path_and_flash_agrees_with_it():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 128, 2, 32), seed=6))
    xla = tattn.apply_attention(q, k, v, causal=True)
    assert torch.equal(xla, tattn.dot_product_attention(q, k, v,
                                                        causal=True))
    flash = tattn.apply_attention(q, k, v, causal=True, attention="flash")
    torch.testing.assert_close(flash, xla, rtol=0, atol=1e-5)


def _bf16_terms(x, n):
    """``x`` (float32) as ``n`` bf16 terms, each the bf16 rounding of what
    the terms before it leave (the kernels' split of p and ds)."""
    terms, rest = [], x
    for _ in range(n):
        term = rest.to(torch.bfloat16)
        terms.append(term)
        rest = rest - term.float()
    return terms


@pytest.mark.parametrize("product", ["dq", "dk", "dv"])
@pytest.mark.parametrize("shape,causal", [((2, 128, 2, 32), True),
                                          ((1, 256, 4, 64), False),
                                          ((2, 128, 2, 64), True)])
def test_three_term_bf16_split_reproduces_float32_products(product, shape,
                                                           causal):
    """The bf16 backward kernels multiply the float32 operand (ds or p)
    as three bf16 terms into one float32 sum. Emulated here: the split
    products give the plain versions' float32 results within
    2e-6 * max|ref|, and one bf16 term misses by more than 5e-4 * max|ref|
    (so the bound tells the two apart)."""
    for seed in range(3):
        q, k, v, do = (torch.from_numpy(x).bfloat16()
                       for x in _qkv(shape, seed=seed, n=4))
        out, lse = tfa.flash_attention_reference(q, k, v, causal)
        delta = tfa.flash_attention_delta(out, do)
        p, ds = tfa._probs_and_ds(q, k, v, do, lse, delta, causal)
        scale = shape[-1] ** -0.5
        x, other, eq, s = {
            "dq": (ds, k, "bhqk,bkhd->bqhd", scale),
            "dk": (ds, q, "bhqk,bqhd->bkhd", scale),
            "dv": (p, do, "bhqk,bqhd->bkhd", 1.0)}[product]
        ref = torch.einsum(eq, x, other.float()) * s

        def split_product(n):  # one float32 sum, scaled at the end
            acc = torch.zeros_like(ref)
            for term in _bf16_terms(x, n):
                acc += torch.einsum(eq, term.float(), other.float())
            return acc * s

        top = ref.abs().max().item()
        three = (split_product(3) - ref).abs().max().item()
        one = (split_product(1) - ref).abs().max().item()
        assert three <= 2e-6 * top, (seed, three / top)
        assert one > 5e-4 * top, (seed, one / top)
