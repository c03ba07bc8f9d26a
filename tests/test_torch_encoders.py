"""The port's encoder families against the JAX package's, on bridged
weights: ``MultiHeadAttention``, ``bert_tiny`` and ``vit_tiny``, and the
weight bridge's round trip for every family.

One flax param tree (float32) per model is carried into the port with
the weight bridge; both packages then see the same numpy inputs. Bound
(float32, summation order the only difference): ``atol = 1e-5 *
max(1, max|ref|)`` on outputs, losses and every gradient leaf (the
leaf's own ``max|ref|``). The round trips are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import engine as jengine
from distkeras_tpu.models import bert_tiny as jbert_tiny
from distkeras_tpu.models import vit_tiny as jvit_tiny
from distkeras_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distkeras_tpu.models.resnet import resnet18 as jresnet18
from distkeras_tpu.ops.attention import MultiHeadAttention as JMHA
from distkeras_tpu_torch import engine
from distkeras_tpu_torch.models import bert_tiny, gpt_tiny, resnet18, vit_tiny
from distkeras_tpu_torch.models.bert import BertMLM
from distkeras_tpu_torch.ops.attention import MultiHeadAttention
from distkeras_tpu_torch.utils import bridge


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _init(jmodel, *args, **kw):
    """flax params of one jitted init (one compile, not one per op)."""
    return _np_tree(jax.jit(lambda key, *a: jmodel.init(key, *a, **kw))(
        jax.random.key(0), *args)["params"])


def _jax_loss_and_grads(jmodel, params, batch, loss):
    """JAX's objective (``engine.make_loss_fn``, sown losses included)
    and its gradients, bridged to the port's parameter names."""
    fn = jengine.make_loss_fn(jmodel, loss)
    (total, logits), grads = jax.jit(jax.value_and_grad(
        lambda p, b: fn(p, b), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(total), np.asarray(logits), bridge.flax_to_state_dict(
        _np_tree(grads))


def _port_loss_and_grads(tmodel, batch, loss):
    (total, logits), grads = engine.make_grad_fn(tmodel, loss)(
        engine.to_device(batch, "cpu"))
    return float(total), logits.numpy(), grads


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for name, g in want.items():
        _close(got[name].numpy(), g.numpy())


# -- MultiHeadAttention -------------------------------------------------------

@pytest.fixture(scope="module")
def mha_pair():
    x = np.random.default_rng(0).standard_normal((2, 12, 32)).astype(
        np.float32)
    jm = JMHA(num_heads=4, dtype=jnp.float32)
    params = _init(jm, jnp.asarray(x))
    return x, params


@pytest.mark.parametrize("case", ["plain", "causal", "mask", "all_masked"])
def test_mha_matches_jax(mha_pair, case):
    """Bidirectional, causal, a key-side padding mask, and a row whose
    keys are all masked (MASK_VALUE keeps its softmax finite: uniform
    weights, as in JAX)."""
    x, params = mha_pair
    causal = case == "causal"
    mask = None
    if case in ("mask", "all_masked"):
        mask = np.ones((2, 12), bool)
        mask[0, 9:] = False
        if case == "all_masked":
            mask[1] = False
    jm = JMHA(num_heads=4, dtype=jnp.float32, causal=causal)
    want = jm.apply({"params": params}, jnp.asarray(x),
                    mask=None if mask is None else jnp.asarray(mask))
    tm = MultiHeadAttention(32, 4, dtype=torch.float32, causal=causal)
    tm.load_state_dict(bridge.flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x),
                 None if mask is None else torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    _close(got.numpy(), want)


def test_mha_flash_refuses_a_mask_and_an_unfit_shape():
    tm = MultiHeadAttention(32, 4, dtype=torch.float32, attention="flash")
    with pytest.raises(ValueError, match="mask"):
        tm(torch.zeros(1, 128, 32), torch.ones(1, 128, dtype=torch.bool))
    with pytest.raises(ValueError, match="fits"):
        tm(torch.zeros(1, 12, 32))
    with pytest.raises(ValueError, match="attention"):
        MultiHeadAttention(32, 4, attention="sparse")
    with pytest.raises(ValueError, match="num_heads"):
        MultiHeadAttention(30, 4)


# -- BERT ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def bert_pair():
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 256, (2, 16)).astype(np.int32)
    ids[0, 12:] = 0  # padding, masked on the key side
    labels = np.where(rng.random((2, 16)) < 0.3, ids, -1).astype(np.int32)
    seg = rng.integers(0, 2, (2, 16)).astype(np.int32)
    jm = jbert_tiny()
    params = _init(jm, jnp.asarray(ids), segment_ids=jnp.asarray(seg))
    tm = bridge.load_flax_params(bert_tiny(), params)
    return jm, params, tm, ids, labels, seg


def test_bert_tiny_logits_match_jax(bert_pair):
    jm, params, tm, ids, _, seg = bert_pair
    for segments in (None, seg):
        want = jm.apply({"params": params}, jnp.asarray(ids),
                        segment_ids=None if segments is None
                        else jnp.asarray(segments))
        with torch.no_grad():
            got = tm(torch.from_numpy(ids), None if segments is None
                     else torch.from_numpy(segments))
        assert got.dtype == torch.float32 and got.shape == (2, 16, 256)
        _close(got.numpy(), want)


def test_bert_tiny_masked_lm_loss_and_grads_match_jax(bert_pair):
    jm, params, tm, ids, labels, _ = bert_pair
    batch = {"features": ids, "labels": labels}
    loss, logits, grads = _port_loss_and_grads(tm, batch, "masked_lm")
    want_loss, want_logits, want_grads = _jax_loss_and_grads(
        jm, params, batch, "masked_lm")
    _close(loss, want_loss)
    _close(logits, want_logits)
    # seg_embed is unused without segment ids: zero in both
    assert not grads["seg_embed.weight"].any()
    _assert_grads_close(grads, want_grads)


def test_bert_int16_ids_equal_int32_ids(bert_pair):
    _, _, tm, ids, labels, _ = bert_pair
    wide = _port_loss_and_grads(tm, {"features": ids, "labels": labels},
                                "masked_lm")
    narrow = _port_loss_and_grads(
        tm, {"features": ids.astype(np.int16),
             "labels": labels.astype(np.int16)}, "masked_lm")
    assert wide[0] == narrow[0]
    np.testing.assert_array_equal(wide[1], narrow[1])
    assert all(torch.equal(wide[2][k], narrow[2][k]) for k in wide[2])


def test_bert_flash_raises_and_segmentless_tree_loads():
    with pytest.raises(ValueError, match="padding mask"):
        bert_tiny(attention="flash")
    ids = np.ones((1, 8), np.int32)
    params = _init(jbert_tiny(), jnp.asarray(ids))
    assert "seg_embed" not in params
    with pytest.raises(RuntimeError, match="seg_embed"):
        bridge.load_flax_params(bert_tiny(), params)
    tm = bridge.load_flax_params(bert_tiny(num_segments=0), params)
    assert not hasattr(tm, "seg_embed")


# -- ViT ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def vit_pair():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[[3, 7]]
    jm = jvit_tiny()
    params = _init(jm, jnp.asarray(x))
    tm = bridge.load_flax_params(vit_tiny(), params)
    return jm, params, tm, x, y


def test_vit_tiny_logits_match_jax(vit_pair):
    jm, params, tm, x, _ = vit_pair
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 10)
    _close(got.numpy(), want)
    # uint8 images normalized on the device, as in JAX
    u8 = np.random.default_rng(3).integers(0, 256, (2, 16, 16, 3),
                                           dtype=np.uint8)
    with torch.no_grad():
        got = tm(torch.from_numpy(u8))
    _close(got.numpy(), jm.apply({"params": params}, jnp.asarray(u8)))


def test_vit_tiny_loss_and_grads_match_jax(vit_pair):
    jm, params, tm, x, y = vit_pair
    batch = {"features": x, "labels": y}
    loss, logits, grads = _port_loss_and_grads(
        tm, batch, "categorical_crossentropy")
    want_loss, want_logits, want_grads = _jax_loss_and_grads(
        jm, params, batch, "categorical_crossentropy")
    _close(loss, want_loss)
    _close(logits, want_logits)
    _assert_grads_close(grads, want_grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_head_input_cast_leaves_logits_bitwise(dtype):
    """The head's ``.float()`` (the precision pin the lint reads) is a
    no-op: the encoder ends in a float32 LayerNorm, so the logits are
    bitwise the head on the encoder's class token, as before the cast."""
    from distkeras_tpu_torch.models.transformer import init_params
    model = init_params(vit_tiny(dtype=dtype), torch.Generator().manual_seed(0))
    seen = []
    model.encoder.register_forward_hook(lambda m, i, out: seen.append(out))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        got = model(x)
        assert seen[0].dtype == torch.float32
        assert torch.equal(got, model.head(seen[0][:, 0]))


def test_vit_flash_raises_at_197_tokens():
    model = vit_tiny(attention="flash", patch_size=16, image_size=224)
    with pytest.raises(ValueError, match="fits"):
        model(torch.zeros(1, 224, 224, 3))


# -- the bridge ---------------------------------------------------------------

def _families():
    ids = jnp.ones((1, 8), jnp.int32)
    return {
        "gpt": (jgpt_tiny(), (ids,), {}, gpt_tiny),
        "resnet": (jresnet18(num_classes=4, width=8, dtype=jnp.float32),
                   (jnp.zeros((1, 32, 32, 3)),), {},
                   lambda: resnet18(num_classes=4, width=8,
                                    dtype=torch.float32)),
        "bert": (jbert_tiny(), (ids,), {"segment_ids": ids}, bert_tiny),
        "vit": (jvit_tiny(), (jnp.zeros((1, 16, 16, 3)),), {}, vit_tiny),
    }


@pytest.mark.parametrize("family", ["gpt", "resnet", "bert", "vit"])
def test_bridge_round_trips_every_family_exactly(family):
    """flax -> port -> flax gives the flax tree back bit for bit, and
    port -> flax -> port the state_dict; ``shapes_only`` gives the flax
    shapes. The flax tree has the init's structure and shapes
    (``eval_shape``) and seeded normal values."""
    jm, args, kw, make = _families()[family]
    shapes = jax.eval_shape(jm.init, jax.random.key(0), *args, **kw)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), shapes["params"])
    tm = bridge.load_flax_params(make(), params)
    back = bridge.state_dict_to_flax(tm.state_dict())
    flat = jax.tree_util.tree_flatten_with_path
    (got, got_def), (want, want_def) = flat(back), flat(params)
    assert got_def == want_def
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b), path
    shapes = bridge.state_dict_to_flax(tm.state_dict(), shapes_only=True)
    assert jax.tree.map(np.shape, shapes) == jax.tree.map(np.shape, params)
    again = bridge.flax_to_state_dict(back)
    assert all(torch.equal(again[k], v) for k, v in tm.state_dict().items())


def test_bert_base_has_the_jax_parameter_count():
    shapes = jax.eval_shape(jbert_tiny(num_layers=12, num_heads=12, width=768,
                                       mlp_dim=3072, vocab_size=30592,
                                       max_len=512).init,
                            jax.random.key(0), jnp.ones((1, 8), jnp.int32),
                            segment_ids=jnp.ones((1, 8), jnp.int32))
    model = BertMLM(dtype=torch.float32)
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
