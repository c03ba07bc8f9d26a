"""The port's GroupNorm op (plain versions of the Hopper kernels, through
its autograd.Function) and module against the JAX package's GroupNorm.

Bounds (inputs made from seeds with numpy; measured on the CPU):

- float32, forward y and stats and backward dx, dgamma, dbeta: 1e-5 abs
  against ``group_norm(..., interpret=True)`` (the Pallas kernels),
  ``_reference`` with JAX autodiff, and ``_jnp_bwd_from_stats``
  (measured: y 9.5e-7, stats 1.2e-7, dx 9.5e-7, dgamma 5.2e-6 on sums of
  magnitude 27, dbeta 3.8e-6; the port sums in float64, JAX in float32);
- bf16 forward: within one bf16 ulp of |y| of ``_reference`` (both round
  once from float32; measured equal), and 2e-2 abs of the interpret-mode
  kernel, whose normalize runs in bf16 (measured 1.6e-2);
- a large mean (x = 100 + 0.1 noise): the two-pass variance stays within
  1e-3 abs of ``_reference`` (measured 2.6e-4, the float32 spacing of
  100 over the 0.1 spread), where the Pallas kernel's E[x^2] - mu^2 is off
  by more than 0.1 (measured 0.46);
- the ``nn.Module`` against flax ``nn.GroupNorm`` (one-pass "fast"
  variance, another operation order): 1e-4 abs.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.pallas import groupnorm as jg
from distkeras_tpu_torch.ops.kernels import groupnorm as tg

SHAPES = [(2, 32, 16, 4), (2, 49, 64, 32), (3, 10, 24, 8)]


def _data(b, hw, c, seed, mean=0.0, std=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, hw, c)) * std + mean).astype(np.float32)
    gamma = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    dy = rng.standard_normal((b, hw, c)).astype(np.float32)
    return x, gamma, beta, dy


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol, what):
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert err.max() <= atol, (what, float(err.max()))


@pytest.mark.parametrize("b,hw,c,groups", SHAPES)
def test_forward_matches_jax_float32(b, hw, c, groups):
    x, gamma, beta, _ = _data(b, hw, c, seed=c)
    y, stats = tg.group_norm_fwd(_t(x), _t(gamma), _t(beta), groups, 1e-6)
    assert y.dtype == torch.float32 and stats.shape == (b, 2, groups)
    jy, jstats = jg._pallas_fwd(jnp.asarray(x), jnp.asarray(gamma),
                                jnp.asarray(beta), groups, 1e-6,
                                interpret=True)
    ry = jg._reference(jnp.asarray(x), jnp.asarray(gamma),
                       jnp.asarray(beta), groups, 1e-6)
    _close(y.numpy(), jy, 1e-5, "y vs kernel")
    _close(y.numpy(), ry, 1e-5, "y vs _reference")
    _close(stats.numpy(), jstats, 1e-5, "stats")


@pytest.mark.parametrize("b,hw,c,groups", SHAPES)
def test_backward_matches_jax_float32(b, hw, c, groups):
    """dx, dgamma, dbeta of the port's op (autograd through the plain
    versions) against the interpret-mode backward kernel, the XLA
    backward from stats, and autodiff of ``_reference``."""
    x, gamma, beta, dy = _data(b, hw, c, seed=c + 1)
    tx, tgam, tbet = (_t(a).requires_grad_() for a in (x, gamma, beta))
    tg.group_norm(tx, tgam, tbet, groups).backward(_t(dy))
    got = (tx.grad.numpy(), tgam.grad.numpy(), tbet.grad.numpy())
    jx, jgam, jbet, jdy = map(jnp.asarray, (x, gamma, beta, dy))
    _, stats = jg._pallas_fwd(jx, jgam, jbet, groups, 1e-6, interpret=True)
    _, vjp = jax.vjp(lambda a, g_, b_: jg._reference(a, g_, b_, groups,
                                                     1e-6), jx, jgam, jbet)
    for name, want in (
            ("kernel", jg._pallas_bwd(jx, jgam, stats, jdy, groups, 1e-6,
                                      interpret=True)),
            ("from_stats", jg._jnp_bwd_from_stats(jx, jgam, stats, jdy,
                                                  groups)),
            ("autodiff", vjp(jdy))):
        for part, g_, w in zip(("dx", "dgamma", "dbeta"), got, want):
            _close(g_, w, 1e-5, (name, part))


def test_backward_partials_are_per_sample():
    x, gamma, _, dy = _data(3, 10, 24, seed=9)
    _, stats = tg.group_norm_fwd(_t(x), _t(gamma), _t(gamma) * 0, 8)
    dx, dgp, dbp = tg.group_norm_bwd(_t(x), _t(gamma), stats, _t(dy), 8)
    assert dx.shape == x.shape and dgp.shape == dbp.shape == (3, 24)
    np.testing.assert_allclose(dbp.numpy(), dy.sum(axis=1), rtol=1e-5,
                               atol=1e-5)


def test_bf16_forward_within_one_ulp_of_reference():
    x, gamma, beta, _ = _data(2, 49, 64, seed=2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jg._reference(xb, jnp.asarray(gamma),
                                    jnp.asarray(beta), 32,
                                    1e-6).astype(jnp.float32))
    kernel, _ = jg._pallas_fwd(xb, jnp.asarray(gamma), jnp.asarray(beta),
                               32, 1e-6, interpret=True)
    got, _ = tg.group_norm_fwd(_t(np.asarray(xb.astype(jnp.float32)))
                               .bfloat16(), _t(gamma), _t(beta), 32)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)
    _close(got, np.asarray(kernel.astype(jnp.float32)), 2e-2, "vs kernel")


def test_two_pass_variance_holds_at_a_large_mean():
    x, gamma, beta, _ = _data(2, 64, 16, seed=1, mean=100.0, std=0.1)
    want = jg._reference(jnp.asarray(x), jnp.asarray(gamma),
                         jnp.asarray(beta), 4, 1e-6)
    got, _ = tg.group_norm_fwd(_t(x), _t(gamma), _t(beta), 4)
    _close(got.numpy(), want, 1e-3, "two-pass")
    fast, _ = jg._pallas_fwd(jnp.asarray(x), jnp.asarray(gamma),
                             jnp.asarray(beta), 4, 1e-6, interpret=True)
    assert np.abs(np.asarray(fast) - np.asarray(want)).max() > 0.1


@pytest.mark.parametrize("scale_init", ["ones", "zeros"])
def test_module_matches_flax_group_norm(scale_init):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    flax_gn = fnn.GroupNorm(num_groups=8, epsilon=1e-6, dtype=jnp.float32,
                            scale_init=(fnn.initializers.ones
                                        if scale_init == "ones"
                                        else fnn.initializers.zeros))
    variables = flax_gn.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    module = tg.GroupNorm(32, 8, eps=1e-6, scale_init=scale_init)
    np.testing.assert_array_equal(module.weight.detach().numpy(),
                                  params["scale"])
    with torch.no_grad():  # carry a non-trivial scale across
        module.weight.copy_(_t(1.0 + rng.standard_normal(32) * 0.1))
        module.bias.copy_(_t(rng.standard_normal(32) * 0.1))
    params = {"scale": module.weight.detach().numpy(),
              "bias": module.bias.detach().numpy()}
    want = flax_gn.apply({"params": params}, jnp.asarray(x))
    got = module(_t(x))
    assert got.shape == x.shape
    _close(got.detach().numpy(), want, 1e-4, "module")


def test_fits_and_dispatch():
    assert tg.fits((128, 12544, 64), 32, torch.bfloat16)
    assert tg.fits((128, 12544, 64), 32, torch.float32)
    assert tg.fits((128, 49, 2048), 32, torch.float32)
    assert not tg.fits((2, 10, 24), 5, torch.float32)      # G does not divide C
    assert tg.fits((1, 60000, 64), 32, torch.float32)  # streams (plan)
    assert not tg.fits((2, 10, 24), 8, torch.float16)
    x = torch.zeros(2, 10, 24, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tg.group_norm_fwd(x, torch.ones(24), torch.zeros(24), 8)
    with pytest.raises(ValueError, match="dividing C"):
        tg.group_norm(torch.zeros(2, 10, 24), torch.ones(24),
                      torch.zeros(24), 5)
