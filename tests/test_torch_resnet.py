"""The port's ResNet family against the JAX package's, on bridged flax
weights: tiny ResNets on 32x32 NHWC inputs, batch 2, float32.

The JAX model's GroupNorm is flax's ``nn.GroupNorm`` (its default, the
Pallas kernel being off); the port's is its own op, whose plain version
runs on the CPU. Every 1-D leaf (norm scales and biases, gains, biases)
is perturbed before the comparison, so that the zero-initialized last
norm or gain of each block does not hide its branch from the gradients.

Bounds (measured on the CPU): logits 1e-4 relative to their largest
magnitude; one SGD step: loss 1e-5 relative, each gradient 1e-4 of its
norm, parameters 1e-5 abs after the step. The two GroupNorms differ in
their variance (flax: one pass; the port: two passes) and operation
order, and the convolutions in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu import engine as jeng
from distkeras_tpu.models import resnet as jresnet
from distkeras_tpu_torch import engine as teng
from distkeras_tpu_torch.models import resnet as tresnet
from distkeras_tpu_torch.ops import optimizers as topt
from distkeras_tpu_torch.ops.kernels import groupnorm as tgn
from distkeras_tpu_torch.utils import bridge

#: name -> (model kwargs, uint8 input): C/G = 2, 4, 8 and 16 occur in the
#: GroupNorm configurations (width 64: 64 and 128 channels a block, 256
#: and 512 after expansion, 32 groups)
CONFIGS = {
    "gn_bottleneck": (dict(block="bottleneck", norm="gn"), True),
    "nf_bottleneck": (dict(block="bottleneck", norm="nf"), True),
    "gn_basic": (dict(block="basic", norm="gn"), False),
    "nf_basic": (dict(block="basic", norm="nf"), False),
    "gn_space_to_depth": (dict(block="bottleneck", norm="gn",
                               space_to_depth=True), True),
}


def _build(block, **kw):
    jblock = {"bottleneck": jresnet.BottleneckBlock,
              "basic": jresnet.BasicBlock}[block]
    tblock = {"bottleneck": tresnet.BottleneckBlock,
              "basic": tresnet.BasicBlock}[block]
    common = dict(stage_sizes=(1, 1), num_classes=10, width=64)
    jmodel = jresnet.ResNet(block=jblock, dtype=jnp.float32, **common, **kw)
    tmodel = tresnet.ResNet(block=tblock, dtype=torch.float32, **common,
                            **kw)
    return jmodel, tmodel


def _images(uint8, seed=0):
    rng = np.random.default_rng(seed)
    if uint8:
        return rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    return rng.standard_normal((2, 32, 32, 3)).astype(np.float32)


def _perturbed(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape))
        .astype(np.float32) if a.ndim == 1 else np.asarray(a), params)


def _pair(name):
    kw, uint8 = CONFIGS[name]
    jmodel, tmodel = _build(**kw)
    x = _images(uint8)
    params = jmodel.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = _perturbed(jax.tree.map(np.asarray, params))
    bridge.load_flax_params(tmodel, params)
    return jmodel, tmodel, params, x


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_jax(name):
    jmodel, tmodel, params, x = _pair(name)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


@pytest.mark.parametrize("name", ["gn_bottleneck", "nf_bottleneck"])
def test_sgd_step_matches_jax(name):
    jmodel, tmodel, params, x = _pair(name)
    y = np.eye(10, dtype=np.float32)[[3, 7]]
    batch = {"features": x, "labels": y}
    jtx = optax.sgd(0.1)
    jp = jax.tree.map(jnp.asarray, params)
    (jloss, _), jgrads = jeng.make_grad_fn(
        jmodel, "categorical_crossentropy")(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jstate, _ = jeng.make_train_step(jmodel, "categorical_crossentropy",
                                     jtx)(
        jeng.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                        opt_state=jtx.init(jp)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    ttx = topt.get("sgd", 0.1)
    (tloss, _), tgrads = teng.make_grad_fn(
        tmodel, "categorical_crossentropy")(teng.to_device(batch, "cpu"))
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    got = bridge.state_dict_to_flax(tgrads)
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        want = np.asarray(want)
        assert np.linalg.norm(leaf - want) <= 1e-4 * max(
            np.linalg.norm(want), 1e-30), path
    state = teng.create_train_state(tmodel, ttx, device="cpu")
    teng.make_train_step(tmodel, "categorical_crossentropy", ttx)(state,
                                                                   batch)
    after = bridge.state_dict_to_flax(tmodel.state_dict())
    for path, want in jax.tree_util.tree_leaves_with_path(jstate.params):
        leaf = after
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf, np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("name", ["gn_bottleneck", "nf_basic"])
def test_bridge_round_trip_is_strict(name):
    _, tmodel, params, _ = _pair(name)
    back = bridge.state_dict_to_flax(tmodel.state_dict())
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_leaves_with_path(t)}
    assert sorted(flat(back)) == sorted(flat(params))
    for key, value in flat(params).items():
        np.testing.assert_array_equal(flat(back)[key], value, err_msg=key)
    sd = bridge.flax_to_state_dict(params)
    assert sd["conv_stem.weight"].shape[:2] == (64, 3)  # OIHW
    missing = dict(sd)
    missing.pop("head.bias")
    with pytest.raises(RuntimeError, match="Missing"):
        tmodel.load_state_dict(missing, strict=True)
    extra = dict(params)
    extra["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(RuntimeError, match="Unexpected"):
        bridge.load_flax_params(tmodel, extra)


def test_resnet50_runs_53_group_norms_and_nf_none():
    model = tresnet.resnet50(dtype=torch.float32)
    norms = [m for m in model.modules() if isinstance(m, tgn.GroupNorm)]
    assert len(norms) == 53  # stem + 16 blocks x 3 + 4 projections
    assert sorted({m.num_groups for m in norms}) == [32]
    nf = tresnet.resnet50_nf(dtype=torch.float32)
    assert not any(isinstance(m, tgn.GroupNorm) for m in nf.modules())
    shapes = jax.eval_shape(jresnet.resnet50().init, jax.random.key(0),
                            jnp.zeros((1, 224, 224, 3), jnp.uint8))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    with pytest.raises(NotImplementedError, match="Queue A"):
        tresnet.resnet50(remat="blocks")


def test_seeded_init_follows_the_zero_init_rules():
    model = tresnet.init_params(tresnet.ResNet((1, 1), width=64,
                                               num_classes=10),
                                torch.Generator().manual_seed(0))
    block = model.stage0_block0
    assert not block.norm3.weight.any() and block.norm1.weight.eq(1).all()
    nf = tresnet.init_params(tresnet.ResNet((1,), width=64, num_classes=10,
                                            norm="nf"),
                             torch.Generator().manual_seed(0))
    assert not nf.stage0_block0.conv3.gain.any()
    again = tresnet.init_params(tresnet.ResNet((1, 1), width=64,
                                               num_classes=10),
                                torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
