"""The port's causal LM against the JAX package's, on bridged weights.

One flax ``gpt_tiny`` param tree (float32) is carried into the port with
the weight bridge; both packages then see the same numpy token ids.
Bounds (float32, summation order the only difference):

- full forward logits: 1e-5 abs;
- paged step (prefill + 6 decode steps with the ghost position): logits
  1e-5 abs; page pools within 1e-6 of the pool's largest magnitude after
  every step (K/V reach |3| here; flax's LayerNorm takes a one-pass
  variance that XLA:CPU sums sequentially, so cells differ by a few f32
  ulps: 1.0e-6 abs observed);
- the MLP block alone (tanh GELU): 1e-6 abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import gpt as jgpt
from distkeras_tpu.models.transformer import MlpBlock as JMlpBlock
from distkeras_tpu.serving import PagedKVCachePool as JPool
from distkeras_tpu.serving.generation import (
    make_paged_step_fn as jax_make_paged_step_fn)
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.models.transformer import MlpBlock
from distkeras_tpu_torch.serving.generation import (GHOST_TOKEN,
                                                    make_paged_step_fn)
from distkeras_tpu_torch.serving.kv_cache import PagedKVCachePool
from distkeras_tpu_torch.utils import bridge


@pytest.fixture(scope="module")
def pair():
    """(jax model, numpy params, port model) sharing one set of weights."""
    jmodel = jgpt.gpt_tiny()
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = tgpt.gpt_tiny()
    bridge.load_flax_params(tmodel, params)
    return jmodel, params, tmodel.eval()


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(
        np.int32)


def test_full_forward_matches_jax(pair):
    jmodel, params, tmodel = pair
    ids = _ids(2, 24, seed=1)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (2, 24, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_paged_step_prefill_then_decode_matches_jax(pair):
    """Prefill one 16-bucket prompt into a 2-slot pool (permuted pages),
    then 6 T=2 decode steps over both lanes, the second lane padded onto
    the scratch slot; logits and every page of every layer agree."""
    jmodel, params, tmodel = pair
    ps = 16
    jpool = JPool(jmodel, 2, page_size=ps)
    tpool = PagedKVCachePool(tmodel, 2, page_size=ps, device="cpu")
    assert jpool.reserve(jpool.allocate(), 40)
    assert tpool.reserve(tpool.allocate(), 40)
    np.testing.assert_array_equal(tpool.page_tables, jpool.page_tables)
    jstep = jax.jit(jax_make_paged_step_fn(jmodel))
    tstep = make_paged_step_fn(tmodel)
    jpages = jpool.pool
    tpages = tpool.pool

    def run(tables, tokens, lengths):
        nonlocal jpages
        jpages, jlogits = jstep(params, jpages, jnp.asarray(tables),
                                jnp.asarray(tokens), jnp.asarray(lengths))
        _, tlogits = tstep(tpages, torch.from_numpy(tables),
                           torch.from_numpy(tokens),
                           torch.from_numpy(lengths))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=0, atol=1e-5)
        for jl, tl in zip(jpages, tpages):
            for key in ("k", "v"):
                want = np.asarray(jl[key])
                np.testing.assert_allclose(
                    tl[key].numpy(), want, rtol=0,
                    atol=1e-6 * max(1.0, float(np.abs(want).max())))
        return np.asarray(jlogits)

    n = 11
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :n] = _ids(1, n, seed=2)
    logits = run(jpool.page_tables[:1], prompt, np.zeros(1, np.int32))
    tok, length = int(np.argmax(logits[0, n - 1])), n
    lanes = jpool.page_tables[[0, jpool.scratch_slot]]
    for _ in range(6):
        tokens = np.array([[tok, GHOST_TOKEN], [GHOST_TOKEN, GHOST_TOKEN]],
                          np.int32)
        logits = run(lanes, tokens, np.array([length, 0], np.int32))
        tok, length = int(np.argmax(logits[0, 0])), length + 1


def test_bridge_round_trip_is_exact(pair):
    _, params, tmodel = pair
    back = bridge.state_dict_to_flax(tmodel.state_dict())
    flat = lambda tree: {"/".join(str(getattr(k, "key", k)) for k in path):
                         leaf for path, leaf in
                         jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(params), flat(back)
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert got[name].shape == leaf.shape, name
        np.testing.assert_array_equal(got[name], leaf, err_msg=name)


def test_bridge_maps_dense_kernels_transposed(pair):
    _, params, tmodel = pair
    sd = bridge.flax_to_state_dict(params)
    np.testing.assert_array_equal(
        sd["layers.1.attn.qkv.weight"].numpy(),
        params["layer_1"]["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(sd["ln_final.weight"].numpy(),
                                  params["ln_final"]["scale"])
    assert set(sd) == set(tmodel.state_dict())


def test_mlp_block_uses_tanh_gelu_like_flax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    jblock = JMlpBlock(16, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jblock.init(jax.random.key(1),
                                                  jnp.asarray(x))["params"])
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    block = MlpBlock(8, 16, dtype=torch.float32)
    for name in ("fc1", "fc2"):
        getattr(block, name).weight.data = torch.from_numpy(
            params[name]["kernel"].T.copy())
        getattr(block, name).bias.data = torch.from_numpy(
            params[name]["bias"].copy())
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_layernorm_eps_and_dtype_placement_follow_flax():
    """flax LayerNorm eps is 1e-6 (torch's default 1e-5); every parameter
    is STORED in float32 (flax's master weights); in bf16 the embedding
    and block Dense layers COMPUTE in bf16 (their weights cast at each
    call) while the LayerNorms, the position table and the LM head
    compute in f32."""
    model = tgpt.gpt_tiny(dtype=torch.bfloat16)
    lns = [m for m in model.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(lns) == 2 * model.num_layers + 1
    assert all(m.eps == 1e-6 for m in lns)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.zeros(1, 3, model.width, dtype=torch.bfloat16)
    assert model.layers[0].attn.qkv(x).dtype == torch.bfloat16
    assert model.layers[0].mlp.fc2(
        torch.zeros(1, 3, model.mlp_dim, dtype=torch.bfloat16)).dtype \
        == torch.bfloat16
    assert model.tok_embed(torch.zeros(1, 3, dtype=torch.long)).dtype \
        == torch.bfloat16
    assert model.lm_head(x.float()).dtype == torch.float32
    assert model(torch.zeros(1, 3, dtype=torch.long)).dtype == torch.float32
    assert tgpt.gpt_tiny(precision="bf16").dtype == torch.bfloat16


def test_inference_copy_stores_compute_dtype_and_keeps_the_function(pair):
    """The serving engine's copy: Dense and embedding weights stored in
    bf16 (their casts become no-ops), the same logits bitwise, and the
    model it was made from untouched (float32)."""
    _, params, _ = pair
    model = bridge.load_flax_params(tgpt.gpt_tiny(dtype=torch.bfloat16),
                                    params).eval()
    served = tgpt.inference_copy(model)
    dtypes = {name: p.dtype for name, p in served.named_parameters()}
    assert dtypes["tok_embed.weight"] == torch.bfloat16
    assert dtypes["layers.1.mlp.fc1.bias"] == torch.bfloat16
    assert dtypes["ln_final.weight"] == dtypes["lm_head.weight"] \
        == dtypes["pos_embed"] == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    ids = torch.from_numpy(_ids(2, 16, seed=8))
    with torch.no_grad():
        assert torch.equal(served(ids), model(ids))
    f32 = tgpt.gpt_tiny()
    assert tgpt.inference_copy(f32) is f32


def test_bf16_full_forward_tracks_jax(pair):
    """At bf16 compute both packages round at the same places (Dense in
    bf16, LayerNorm/softmax/LM head in f32) but XLA and torch accumulate
    bf16 products differently, so the bound is bf16-sized: 0.1 abs on
    logits of order 1, and the same greedy choice at most positions."""
    jmodel, params, _ = pair
    jb = jgpt.gpt_tiny(dtype=jnp.bfloat16)
    tb = bridge.load_flax_params(tgpt.gpt_tiny(dtype=torch.bfloat16),
                                 params).eval()
    ids = _ids(2, 16, seed=6)
    want = np.asarray(jb.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = tb(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.1)
    agree = np.mean(got.argmax(-1) == want.argmax(-1))
    assert agree >= 0.9, agree


def test_model_options_not_ported_raise():
    # ported: attention="ring" builds; outside a set of sequence shards
    # (parallel/sequence.py) and in decode it raises
    ring = tgpt.gpt_tiny(attention="ring")
    with pytest.raises(ValueError, match="sequence shards"):
        ring(torch.ones(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="attention='full'"):
        ring(torch.zeros(1, 2, dtype=torch.long),
             cache=tgpt.init_cache(ring, 1),
             cache_index=torch.zeros(1, dtype=torch.int32))
    logits = ring([torch.ones(1, 4, dtype=torch.long)] * 2)
    assert [tuple(x.shape) for x in logits] == [(1, 4, ring.vocab_size)] * 2
    # ported: remat (models/remat.py) builds and steps
    remat = tgpt.gpt_tiny(remat="blocks")
    logits = remat(torch.ones(1, 4, dtype=torch.long))
    logits.sum().backward()
    assert all(p.grad is not None for p in remat.parameters())
    with pytest.raises(ValueError, match="attention"):
        tgpt.gpt_tiny(attention="sparse")
    flash = tgpt.gpt_tiny(attention="flash")  # ported: the training path
    with pytest.raises(ValueError, match="attention='full'"):
        flash(torch.zeros(1, 2, dtype=torch.long),
              cache=tgpt.init_paged_cache(flash, 8, 16),
              cache_index=torch.zeros(1, dtype=torch.int32),
              page_table=torch.zeros(1, 8, dtype=torch.int32))
    model = tgpt.gpt_tiny()
    with pytest.raises(ValueError, match="kv_dtype"):
        tgpt.init_paged_cache(model, 8, 16, kv_dtype="fp8")
    # ported: the int8 paged cache serves (its codes and scales written)
    pages = tgpt.init_paged_cache(model, 8, 16, kv_dtype="int8")
    assert pages[0]["k"].dtype == torch.int8
    logits, _ = model(torch.ones(1, 2, dtype=torch.long), cache=pages,
                      cache_index=torch.zeros(1, dtype=torch.int32),
                      page_table=torch.arange(8, dtype=torch.int32)[None])
    assert logits.shape == (1, 2, model.vocab_size)
    assert torch.isfinite(logits).all()
    assert pages[0]["k"][0].any() and pages[0]["k_scale"][0] > 0
    # ported: the rectangular cache (no page_table) serves
    logits, _ = model(torch.zeros(1, 2, dtype=torch.long),
                      cache=tgpt.init_cache(model, 1),
                      cache_index=torch.zeros(1, dtype=torch.int32))
    assert logits.shape == (1, 2, model.vocab_size)


def test_cache_sizes_match_jax():
    jmodel, tmodel = jgpt.gpt_small(), tgpt.gpt_small()
    assert tgpt.page_bytes(tmodel, 16) == jgpt.page_bytes(jmodel, 16)
    assert tgpt.cache_bytes_per_row(tmodel) == jgpt.cache_bytes_per_row(
        jmodel)
    assert tgpt.page_bytes(tmodel, 16, torch.float32) == jgpt.page_bytes(
        jmodel, 16, jnp.float32)


def test_init_params_is_seeded():
    a = tgpt.init_params(tgpt.gpt_tiny(), torch.Generator().manual_seed(3))
    b = tgpt.init_params(tgpt.gpt_tiny(), torch.Generator().manual_seed(3))
    c = tgpt.init_params(tgpt.gpt_tiny(), torch.Generator().manual_seed(4))
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
        if name.endswith("weight") and ".ln" not in name \
                and not name.startswith("ln"):
            assert not torch.equal(pa, pc), name


def test_init_paged_cache_defaults_to_the_models_device():
    """``device=None`` puts the pool where the model's parameters are (a
    model on the meta device gets a meta pool, not a CPU one); an explicit
    device still wins."""
    model = tgpt.gpt_tiny().to("meta")
    pool = tgpt.init_paged_cache(model, 4, 16)
    assert len(pool) == model.num_layers
    assert all(x.device.type == "meta" for layer in pool
               for x in layer.values())
    assert pool[0]["k"].shape == (5, 16, model.num_heads,
                                  model.width // model.num_heads)
    pool = tgpt.init_paged_cache(model, 4, 16, device="cpu")
    assert pool[0]["v"].device.type == "cpu"
