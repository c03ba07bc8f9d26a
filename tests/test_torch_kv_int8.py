"""The port's int8 KV pages against the JAX package's.

Both packages quantize the same seeded numpy pages, run one paged
attention step over the same int8 pool, and serve ``gpt_tiny`` in
float32 on the same bridged weights with ``kv_dtype="int8"``. The JAX
side runs its default path (``PAGED_INT8_KERNEL`` off: the exact
in-call block overlaid on the dequantized history, attended by XLA); the
port attends over the same view through the paged kernel's plain
version on the CPU. Bounds:

- ``quantize_kv_page`` codes and scales bitwise against the JAX function
  run op by op (one float32 division and round-half-even on both
  sides), ``dequantize_kv_page`` bitwise;
- one step against the JAX function jitted, as its engine runs it:
  attention output within 1e-5 abs (the float32 products' summation
  order); the new pool's scales within 1 float32 ulp and codes within 1
  (XLA may fold the scale's division by 254 into a multiply), pages the
  step does not touch bitwise unchanged;
- the engines' greedy tokens identical.

The JAX engine is built once for the module and shared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import gpt as jgpt
from distkeras_tpu.ops.pallas import flash_attention as jfa
from distkeras_tpu.serving import GenerationEngine as JaxEngine
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.serving import GenerationEngine, PagedKVCachePool
from distkeras_tpu_torch.utils import bridge

KW = dict(num_slots=2, slot_ladder=(1, 2), prefill_buckets=(16,),
          page_size=16, kv_dtype="int8")


@pytest.fixture(scope="module")
def weights():
    """Seeded port weights and the same weights as a flax param tree."""
    model = tgpt.init_params(tgpt.gpt_tiny(), torch.Generator().manual_seed(0))
    return jgpt.gpt_tiny(), bridge.state_dict_to_flax(model.state_dict())


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 256, n).tolist() for n in (5, 16, 11)]


def _serve(eng, prompts, new=12):
    with eng:
        futs = [eng.generate(p, max_new_tokens=new) for p in prompts]
        return [f.result(timeout=120).tokens for f in futs]


@pytest.fixture(scope="module")
def jax_run(weights):
    """The JAX int8 engine's tokens over the prompts, and its pool."""
    jmodel, params = weights
    eng = JaxEngine(jmodel, params, **KW)
    return _serve(eng, _prompts()), eng.pool


def _pages(rng, n=5, ps=16, h=2, d=16):
    return (rng.standard_normal((n, ps, h, d)) * 2).astype(np.float32)


@pytest.mark.parametrize("case", ["plain", "valid", "zero"])
def test_quantize_and_dequantize_kv_page_bitwise_as_jax(case):
    rng = np.random.default_rng(3)
    x = _pages(rng)
    valid = None
    if case == "valid":
        valid = np.arange(16)[None, :] < rng.integers(0, 17, 5)[:, None]
    if case == "zero":
        x[1] = 0.0
        x[3] = 0.0
    codes, scale = tgpt.quantize_kv_page(
        torch.from_numpy(x),
        None if valid is None else torch.from_numpy(valid))
    jcodes, jscale = jgpt.quantize_kv_page(
        jnp.asarray(x), None if valid is None else jnp.asarray(valid))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        tgpt.dequantize_kv_page(codes, scale).numpy(),
        np.asarray(jgpt.dequantize_kv_page(jcodes, jscale)))
    if case == "zero":
        assert scale[1] == 0 and not codes[1].any()
    if case == "valid":
        masked = ~np.broadcast_to(valid[..., None, None], x.shape)
        assert not codes.numpy()[masked].any()
    # one encode's error is at most scale / 2 a cell
    kept = x if valid is None else np.where(valid[..., None, None], x, 0)
    err = np.abs(tgpt.dequantize_kv_page(codes, scale).numpy() - kept)
    assert (err <= scale.numpy()[:, None, None, None] / 2 + 1e-7).all()


def _int8_pool(rng, num_pages, ps, h, d):
    """An int8 pool (one layer) quantized from seeded float pages."""
    codes, scale = tgpt.quantize_kv_page(torch.from_numpy(
        _pages(rng, num_pages + 1, ps, h, d)))
    vcodes, vscale = tgpt.quantize_kv_page(torch.from_numpy(
        _pages(rng, num_pages + 1, ps, h, d)))
    return {name: a.numpy() for name, a in
            (("k", codes), ("v", vcodes), ("k_scale", scale),
             ("v_scale", vscale))}


@pytest.mark.parametrize("t,cursors", [(2, (37, 0)), (16, (5, 47)),
                                       (2, (127, 64))],
                         ids=["decode", "prefill-mid-page", "ghost"])
def test_paged_int8_attention_matches_jax(t, cursors):
    """One step over an int8 pool: decode lanes (one at a fresh page),
    a 16-token block from mid-page cursors (three touched pages), and a
    decode lane at max_len - 1 whose ghost at max_len is dropped."""
    rng = np.random.default_rng(len(cursors) + t)
    b, h, d, ps, pmax = 2, 2, 16, 16, 8
    num_pages = b * pmax
    pool = _int8_pool(rng, num_pages, ps, h, d)
    table = rng.permutation(num_pages)[:b * pmax].reshape(b, pmax).astype(
        np.int32)
    ci = np.asarray(cursors, np.int32)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32)
               for _ in range(3))
    pos = ci[:, None] + np.arange(t)[None, :]
    jout, jpool = jax.jit(
        lambda *a: jgpt._paged_int8_attention(*a, jfa))(
        q, k, v, pool, table, pos, ci)
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tout = tgpt._paged_int8_attention(
        *map(torch.from_numpy, (q, k, v)), tpool, torch.from_numpy(table),
        torch.from_numpy(pos).long(), torch.from_numpy(ci))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    touched = set()
    for row in range(b):
        for p in range(pos[row, 0] // ps, min(pmax, (pos[row, -1]) // ps
                                              + 1)):
            touched.add(int(table[row, p]))
    live = np.arange(num_pages)  # the scratch page holds garbage
    for name in ("k", "v", "k_scale", "v_scale"):
        got, want = tpool[name].numpy(), np.asarray(jpool[name])
        if name.endswith("scale"):
            np.testing.assert_array_max_ulp(got[live], want[live], maxulp=1)
        else:
            assert np.abs(got[live].astype(np.int32)
                          - want[live].astype(np.int32)).max() <= 1
        untouched = [p for p in live if p not in touched]
        np.testing.assert_array_equal(got[untouched], pool[name][untouched])
    assert touched and any(
        not np.array_equal(tpool["k"].numpy()[p], pool["k"][p])
        for p in touched)


def test_int8_pool_geometry_matches_jax(weights, jax_run):
    """The port's pool against the JAX engine's (2 slots, page 16)."""
    model = bridge.load_flax_params(tgpt.gpt_tiny(), weights[1])
    telemetry.reset()
    pool = PagedKVCachePool(model, 2, page_size=16, kv_dtype="int8",
                            device="cpu")
    jpool = jax_run[1]
    assert pool.kv_dtype == jpool.kv_dtype == "int8"
    assert pool.page_bytes == jpool.page_bytes
    assert pool.cache_bytes == jpool.cache_bytes
    assert pool.kv_quant_bytes_saved == jpool.kv_quant_bytes_saved > 0
    assert telemetry.gauge("serving.decode.paged.kv_quant_bytes_saved") \
        .value == pool.kv_quant_bytes_saved
    for t, j in zip(pool.pool, jpool.pool):
        assert sorted(t) == sorted(j)
        for name in t:
            assert tuple(t[name].shape) == j[name].shape
            assert str(t[name].dtype).split(".")[-1] == str(j[name].dtype)
    small = tgpt.gpt_small()
    assert tgpt.page_bytes(small, 16, kv_dtype="int8") == jgpt.page_bytes(
        jgpt.gpt_small(), 16, kv_dtype="int8")


def test_int8_engine_greedy_tokens_identical_to_jax_engine(weights,
                                                           jax_run):
    model = bridge.load_flax_params(tgpt.gpt_tiny(), weights[1])
    got = _serve(GenerationEngine(model, device="cpu", **KW), _prompts())
    for g, w in zip(got, jax_run[0]):
        np.testing.assert_array_equal(g, w)
