"""The port's ring attention against the JAX package's.

JAX's ``ring_attention_sharded`` runs on conftest's 8 CPU devices (a
``seq`` mesh); the port's on a mesh that repeats ``cpu`` 8 times, in one
process, with ``.to()`` hops. Both fold the same blocks in the same
order with float32 accumulators, so float32 outputs and q/k/v gradients
agree at the JAX tests' own bound, rtol = atol = 2e-5. Each JAX
reference is jitted once a case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from distkeras_tpu.ops.ring_attention import ring_attention_sharded as jring
from distkeras_tpu_torch.ops.attention import dot_product_attention
from distkeras_tpu_torch.ops.ring_attention import (ring_attention,
                                                    ring_attention_sharded)
from distkeras_tpu_torch.parallel.sequence import make_sp_mesh

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Run this module's torch ops on one intra-op thread, restoring the
    count after: the CPU ring's many small per-shard ops are erratic
    under a thread pool, and several test processes at once each with a
    pool oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshes(devices):
    return (JMesh(np.array(devices[:8]), ("seq",)),
            make_sp_mesh(1, 8, devices=["cpu"] * 8))


def _qkv(b=2, t=32, h=2, d=4, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def _mask(seed=3):
    return np.random.default_rng(seed).random((2, 32)) > 0.3


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_ring_outputs_and_grads_match_jax(meshes, causal, masked):
    jmesh, tmesh = meshes
    q, k, v = _qkv(seed=int(causal) + 2 * int(masked))
    mask = _mask() if masked else None

    @jax.jit
    def jax_ref(q, k, v):
        def loss(q, k, v):
            out = jring(q, k, v, jmesh, causal=causal,
                        kv_mask=None if mask is None else jnp.asarray(mask))
            return jnp.sum(out ** 2), out
        return jax.value_and_grad(loss, argnums=(0, 1, 2),
                                  has_aux=True)(q, k, v)

    (_, want), want_grads = jax_ref(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = ring_attention_sharded(
        tq, tk, tv, tmesh, causal=causal,
        kv_mask=None if mask is None else torch.from_numpy(mask))
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, w in zip((tq.grad, tk.grad, tv.grad), want_grads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_ring_matches_plain_attention(meshes):
    """The ring against the port's one-device plain attention."""
    _, tmesh = meshes
    q, k, v = (torch.from_numpy(x) for x in _qkv(seed=7))
    for causal in (False, True):
        np.testing.assert_allclose(
            ring_attention_sharded(q, k, v, tmesh, causal=causal).numpy(),
            dot_product_attention(q, k, v, causal=causal).numpy(), **TOL)


def test_ring_bf16_dtype_preserved(meshes):
    """bf16 in, bf16 out; the logits round to bf16 before the scale in
    both packages (a bf16 product), so the port stays within bf16's
    step of JAX's bf16 ring and within the JAX test's 0.05 of float32
    attention."""
    jmesh, tmesh = meshes
    q, k, v = _qkv(seed=4)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(jax.jit(lambda q, k, v: jring(q, k, v, jmesh))(*jb),
                      np.float32)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = ring_attention_sharded(*tb, tmesh)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    full = dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(), full.numpy(), rtol=0.05,
                               atol=0.05)


def test_fully_masked_rows_give_zero_not_nan(meshes):
    """A row no key reaches (its keys all padding) gives 0, and its
    gradients are finite zeros."""
    _, tmesh = meshes
    q, k, v = (torch.tensor(x, requires_grad=True) for x in _qkv(seed=5))
    mask = torch.ones(2, 32, dtype=torch.bool)
    mask[1] = False
    out = ring_attention_sharded(q, k, v, tmesh, causal=True, kv_mask=mask)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    out.sum().backward()
    for g in (q.grad, k.grad, v.grad):
        assert torch.isfinite(g).all()
        assert torch.equal(g[1], torch.zeros_like(g[1]))


def test_ring_validates_its_blocks(meshes):
    _, tmesh = meshes
    q = torch.zeros(1, 4, 1, 2)
    with pytest.raises(ValueError, match="one block a shard"):
        ring_attention([q, q], [q], [q, q])
    with pytest.raises(ValueError, match="do not split"):
        ring_attention_sharded(torch.zeros(1, 12, 1, 2),
                               torch.zeros(1, 12, 1, 2),
                               torch.zeros(1, 12, 1, 2), tmesh)
    with pytest.raises(ValueError, match="not 'model'"):
        ring_attention_sharded(q, q, q, tmesh, axis_name="model")
