"""The port's Switch-MoE classifier against the JAX package's, on bridged
weights: the expert each token is routed to, capacity drops, the sown
load-balance term, logits, the objective and its gradients, the flash
attention variant (the kernels' plain versions on the CPU) against
JAX's XLA path, the bridge's round trip, and the collector's rules.

Bound (float32, summation order the only difference): ``atol = 1e-5 *
max(1, max|ref|)`` on outputs, losses, aux terms and every gradient
leaf. A route that differs prints the router's gap between the two
experts, so a near tie shows as such.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import engine as jengine
from distkeras_tpu.models.moe import MoEClassifier as JMoEClassifier
from distkeras_tpu_torch import engine
from distkeras_tpu_torch.models import aux_losses, moe
from distkeras_tpu_torch.models.moe import MoEClassifier, SwitchMoE
from distkeras_tpu_torch.utils import bridge

KW = dict(num_classes=4, num_layers=2, num_heads=2, num_experts=4,
          mlp_dim=32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _features(b, t, w=16, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, w)).astype(
        np.float32)


def _pair(capacity_factor=2.0, t=8, attention=None):
    """(jax model, numpy params, port model, features, one-hot labels)."""
    x = _features(2, t)
    jm = JMoEClassifier(dtype=jnp.float32, capacity_factor=capacity_factor,
                        **KW)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k, a: jm.init(k, a))(jax.random.key(0), jnp.asarray(x))[
            "params"])
    tm = bridge.load_flax_params(MoEClassifier(
        dtype=torch.float32, capacity_factor=capacity_factor, width=16,
        attention=attention, **KW), params)
    y = np.eye(4, dtype=np.float32)[[1, 3]]
    return jm, params, tm, x, y


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def dropping_pair():
    """capacity_factor 0.5: 16 tokens over 4 experts, 2 slots each."""
    return _pair(capacity_factor=0.5)


def _jax_forward(jm, params, x):
    """Logits, sown terms (module path order) and each block's router
    logits, from one jitted apply."""
    def run(p, a):
        return jm.apply({"params": p}, a, train=True,
                        mutable=["losses", "intermediates"],
                        capture_intermediates=lambda m, _: m.name == "router")
    logits, state = jax.jit(run)(params, jnp.asarray(x))
    terms = [np.asarray(v) for v in jax.tree.leaves(state["losses"])]
    routers = [np.asarray(state["intermediates"][f"block{i}"]["moe"][
        "router"]["__call__"][0]) for i in range(KW["num_layers"])]
    return np.asarray(logits), terms, routers


def _port_forward(tm, x):
    routers, hooks = [], []
    for i in range(KW["num_layers"]):
        hooks.append(getattr(tm, f"block{i}").moe.router.register_forward_hook(
            lambda m, a, out: routers.append(out.detach().numpy())))
    with aux_losses.collect() as terms, torch.no_grad():
        logits = tm(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    return logits.numpy(), [float(v) for v in terms], routers


def _same_routes(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        pick_g, pick_w = g.argmax(-1), w.argmax(-1)
        bad = np.nonzero(pick_g != pick_w)[0]
        gap = [float(w[n, pick_w[n]] - w[n, pick_g[n]]) for n in bad]
        assert bad.size == 0, (f"block{i}: tokens {bad.tolist()} routed "
                               f"differently; JAX router gaps {gap}")


@pytest.mark.parametrize("which", ["pair", "dropping_pair"])
def test_routes_aux_terms_and_logits_match_jax(which, request):
    jm, params, tm, x, _ = request.getfixturevalue(which)
    want_logits, want_terms, want_routers = _jax_forward(jm, params, x)
    logits, terms, routers = _port_forward(tm, x)
    _same_routes(routers, want_routers)
    assert len(terms) == len(want_terms) == KW["num_layers"]
    for got, want in zip(terms, want_terms):
        assert got > 0
        _close(got, want)
    _close(logits, want_logits)


def test_capacity_drops_tokens(dropping_pair):
    """At capacity_factor 0.5 some tokens find their expert's queue full:
    zero dispatch, zero MoE output; the routes above still match JAX."""
    _, _, tm, x, _ = dropping_pair
    block = tm.block0
    with torch.no_grad():
        h = block.ln2(torch.from_numpy(x)).reshape(16, 16)
        gates = torch.softmax(block.moe.router(h), -1)
    per_expert = np.bincount(gates.argmax(-1).numpy(), minlength=4)
    capacity = max(1, int(0.5 * 16 / 4))
    assert capacity == 2 and (per_expert > capacity).any(), per_expert
    with torch.no_grad():
        out = block.moe(h.reshape(2, 8, 16))
    dropped = int((out.reshape(16, 16).abs().sum(-1) == 0).sum())
    assert dropped == int(np.maximum(per_expert - capacity, 0).sum())


@pytest.mark.parametrize("which", ["pair", "dropping_pair"])
def test_objective_and_grads_match_jax(which, request):
    """The objective is the loss plus both blocks' sown terms in both
    packages; every gradient leaf (router and experts included) agrees."""
    jm, params, tm, x, y = request.getfixturevalue(which)
    batch = {"features": x, "labels": y}
    fn = jengine.make_loss_fn(jm, "categorical_crossentropy")
    (want, _), want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: fn(p, b), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    want_grads = bridge.flax_to_state_dict(jax.tree.map(np.asarray,
                                                        want_grads))
    (got, _), grads = engine.make_grad_fn(tm, "categorical_crossentropy")(
        engine.to_device(batch, "cpu"))
    _close(float(got), float(want))
    assert set(grads) == set(want_grads)
    for name, g in want_grads.items():
        _close(grads[name].numpy(), g.numpy())
    assert grads["block0.moe.router.weight"].abs().max() > 0
    # the objective holds the sown terms: without them it is lower
    with torch.no_grad():
        bare = float(engine.losses_lib.get("categorical_crossentropy")(
            tm(torch.from_numpy(x)), torch.from_numpy(y)))
    _close(float(got) - bare, sum(_port_forward(tm, x)[1]))


def test_flash_variant_on_plain_kernels_matches_jax_xla():
    """``attention="flash"`` at t = 128 (head_dim 8: ``fits``): on CPU
    tensors the kernel wrappers run their plain versions, held to the
    JAX model's XLA attention."""
    jm, params, tm, x, y = _pair(t=128, attention="flash")
    want_logits, want_terms, _ = _jax_forward(jm, params, x)
    logits, terms, _ = _port_forward(tm, x)
    _close(logits, want_logits)
    for got, want in zip(terms, want_terms):
        _close(got, want)
    (loss, _), grads = engine.make_grad_fn(tm, "categorical_crossentropy")(
        engine.to_device({"features": x, "labels": y}, "cpu"))
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_bridge_round_trips_the_moe_tree_exactly(pair):
    _, params, tm, _, _ = pair
    back = bridge.state_dict_to_flax(tm.state_dict())
    flat = jax.tree_util.tree_flatten_with_path
    (got, got_def), (want, want_def) = flat(back), flat(params)
    assert got_def == want_def
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b), path
    assert tm.block0.moe.experts.fc1["weight"].shape == (4, 32, 16)
    assert params["block0"]["moe"]["experts"]["fc1"]["kernel"].shape == (
        4, 16, 32)
    shapes = bridge.state_dict_to_flax(tm.state_dict(), shapes_only=True)
    assert jax.tree.map(np.shape, shapes) == jax.tree.map(np.shape, params)


def test_expert_parallel_rules_name_item_16():
    """Item 16's expert-parallel rules (ported): JAX's ``EP_RULES``, and
    ``ep_partition_rules()`` prepends them, as specs, to the
    tensor-parallel defaults, in JAX's order."""
    from distkeras_tpu.models import moe as jmoe
    from distkeras_tpu_torch.parallel import tensor

    assert moe.EP_RULES == jmoe.EP_RULES
    rules = moe.ep_partition_rules()
    want = jmoe.ep_partition_rules()
    assert [pat for pat, _ in rules] == [pat for pat, _ in want]
    assert [tuple(spec) for _, spec in rules] == \
        [tuple(spec) for _, spec in want]
    assert all(isinstance(spec, tensor.PartitionSpec) for _, spec in rules)
    assert rules[len(moe.EP_RULES):] == tuple(tensor.DEFAULT_RULES)


def test_router_noise_draws_from_the_generator():
    layer = SwitchMoE(16, 4, 32, dtype=torch.float32, router_noise=1.0)
    x = torch.from_numpy(_features(2, 8))

    def run(seed, training=True):
        layer.train(training)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return layer(x, generator=gen)

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert torch.equal(run(3, training=False), run(4, training=False))


def test_sown_terms_stay_in_their_thread():
    """Two threads sow into their own collectors at once; no collector, no
    term (a plain forward)."""
    layer = SwitchMoE(16, 4, 32, dtype=torch.float32)
    x = torch.from_numpy(_features(2, 8))
    barrier = threading.Barrier(2)
    seen = {}

    def work(name, repeats):
        with aux_losses.collect() as terms:
            barrier.wait()
            for _ in range(repeats):
                layer(x)
                aux_losses.sow(torch.tensor(float(repeats)))
            seen[name] = terms

    threads = [threading.Thread(target=work, args=(n, r))
               for n, r in (("a", 1), ("b", 3))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(seen["a"]) == 2 and len(seen["b"]) == 6
    assert [float(t) for t in seen["b"][1::2]] == [3.0, 3.0, 3.0]
    layer(x)  # outside a collector: dropped, nothing raised
    with aux_losses.collect() as outer:
        with aux_losses.suppressed():
            layer(x)
        with aux_losses.collect() as inner:
            layer(x)
    assert outer == [] and len(inner) == 1
