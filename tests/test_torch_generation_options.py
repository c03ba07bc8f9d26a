"""The port's GenerationEngine options against the JAX package's: the
rectangular pool (``page_size=None``, the default), temperature sampling
and chunked prefill, and the one-runner-per-declared-shape rule.

Both packages serve ``gpt_tiny`` in float32 on the same bridged weights,
both engines on the CPU (the port's runners then call the step eagerly
on their static buffers; the graphs themselves are held on the card by
tests/test_torch_serving_cuda.py). Tolerance: token identity, and for
the step functions float32 logits and the written cache cells within
1e-5 of the JAX package's (the products' summation order; cells the
step must not touch keep their values exactly, to 1e-5 as well).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import gpt as jgpt
from distkeras_tpu.serving import GenerationEngine as JaxEngine
from distkeras_tpu.serving import generation as jgen
from distkeras_tpu.serving import kv_cache as jkv
from distkeras_tpu_torch import observability, telemetry
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.serving import (GenerationEngine, KVCachePool,
                                         make_decode_fn, make_prefill_fn)
from distkeras_tpu_torch.serving import generation as tgen
from distkeras_tpu_torch.utils import bridge

RECT_KW = dict(num_slots=2, slot_ladder=(1, 2), prefill_buckets=(16,))
PAGED_KW = dict(RECT_KW, page_size=16)
SAMPLED = dict(sampling=True, temperature=0.7, seed=321)


@pytest.fixture(autouse=True)
def fresh_registry():
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture(scope="module")
def weights():
    jmodel = jgpt.gpt_tiny()
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, jax.tree.map(np.asarray, params)


def _port_model(params):
    return bridge.load_flax_params(tgpt.gpt_tiny(), params)


def _prompts(lengths=(5, 16, 11), seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).tolist() for n in lengths]


def _serve(engine, prompts, new=12):
    """Submit every prompt, then collect: more prompts than slots, so
    admission interleaves with decode."""
    with engine as eng:
        futs = [eng.generate(p, max_new_tokens=new) for p in prompts]
        return [f.result(timeout=120).tokens for f in futs]


def _port(params, **kw):
    return GenerationEngine(_port_model(params), device="cpu", **kw)


def _jax(weights, **kw):
    jmodel, params = weights
    return JaxEngine(jmodel, params, **kw)


# -- the step functions of the rectangular pool -----------------------------

def _random_pool(model, rows, rng):
    """A rectangular pool filled with seeded values (so that a write that
    should be dropped would show)."""
    pool = tgpt.init_cache(model, rows)
    for layer in pool:
        for a in layer.values():
            a.copy_(torch.from_numpy(
                rng.standard_normal(a.shape).astype(np.float32)))
    return pool


def _to_jax(pool):
    return tuple({k: jnp.asarray(v.numpy()) for k, v in layer.items()}
                 for layer in pool)


def _assert_pools_close(tpool, jpool):
    for tl, jl in zip(tpool, jpool):
        for name in ("k", "v"):
            np.testing.assert_allclose(tl[name].numpy(),
                                       np.asarray(jl[name]), atol=1e-5,
                                       rtol=0)


def test_prefill_fn_matches_jax(weights):
    jmodel, params = weights
    model = _port_model(params)
    rng = np.random.default_rng(0)
    pool = _random_pool(model, 3, rng)
    jpool = _to_jax(pool)
    ids = rng.integers(1, 256, (1, 16)).astype(np.int32)
    got = make_prefill_fn(model)(pool, torch.from_numpy(ids),
                                 torch.tensor([1]),
                                 torch.tensor([11], dtype=torch.int32))
    jpool, want = jax.jit(jgen.make_prefill_fn(jmodel))(
        params, jpool, ids, np.int32(1), np.int32(11))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    _assert_pools_close(pool, jpool)


def test_decode_fn_matches_jax_and_drops_the_ghost(weights):
    """Lanes at max_len - 1 (whose ghost sits at max_len and must be
    dropped), mid-row and a scratch lane: logits and every cell of the
    pool as the JAX package's."""
    jmodel, params = weights
    model = _port_model(params)
    rng = np.random.default_rng(1)
    pool = _random_pool(model, 4, rng)
    jpool = _to_jax(pool)
    slot_ids = np.array([0, 2, 3, 3], np.int32)
    tokens = rng.integers(1, 256, 4).astype(np.int32)
    lengths = np.array([model.max_len - 1, 40, 0, 0], np.int32)
    last = [layer["k"][0, -1].clone() for layer in pool]
    got = make_decode_fn(model)(pool, *map(torch.from_numpy,
                                           (slot_ids, tokens, lengths)))
    jpool, want = jax.jit(jgen.make_decode_fn(jmodel))(
        params, jpool, slot_ids, tokens, lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    _assert_pools_close(pool, jpool)
    assert all(not torch.equal(layer["k"][0, -1], before)
               for layer, before in zip(pool, last))


def test_rect_forward_drops_positions_past_max_len(weights):
    """A block that runs past max_len through the model's rectangular
    branch: the cache the JAX package's ``mode="drop"`` leaves, and the
    same logits, for a row whose last cell is written in the call and a
    row wholly past the end."""
    jmodel, params = weights
    model = _port_model(params)
    rng = np.random.default_rng(2)
    pool = _random_pool(model, 2, rng)
    jpool = _to_jax(pool)
    ids = rng.integers(1, 256, (2, 4)).astype(np.int32)
    ci = np.array([model.max_len - 2, model.max_len + 1], np.int32)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(ids), cache=pool,
                       cache_index=torch.from_numpy(ci))
    want, jpool = jax.jit(
        lambda p, i, c, ci: jmodel.apply({"params": p}, i, cache=c,
                                         cache_index=ci))(
        params, ids, jpool, ci)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    _assert_pools_close(pool, jpool)


def test_init_cache_and_pool_match_jax_geometry(weights, monkeypatch):
    jmodel, params = weights
    model = _port_model(params)
    for t, j in zip(tgpt.init_cache(model, 3),
                    jgpt.init_cache(jmodel, 3)):
        for name in ("k", "v"):
            assert tuple(t[name].shape) == j[name].shape
            assert t[name].dtype == torch.float32 and not t[name].any()
    small, jsmall = tgpt.gpt_small(), jgpt.gpt_small()
    assert tgpt.init_cache(small, 1, device="meta")[0]["k"].dtype \
        == torch.bfloat16
    pool = KVCachePool(model, 3, device="cpu")
    jpool = jkv.KVCachePool(jmodel, 3)
    assert pool.cache_bytes == jpool.cache_bytes
    assert pool.scratch_slot == jpool.scratch_slot == 3
    assert tuple(pool.pool[0]["k"].shape) == jpool.pool[0]["k"].shape
    assert tgpt.cache_bytes_per_row(small) == jgpt.cache_bytes_per_row(
        jsmall)
    a, b = pool.allocate(), pool.allocate()
    assert (a, b) == (jpool.allocate(), jpool.allocate())
    pool.free(a)
    with pytest.raises(ValueError):
        pool.free(a)
    assert telemetry.gauge("serving.decode.cache_bytes").value \
        == pool.cache_bytes
    monkeypatch.setattr(observability, "hbm_stats",
                        lambda device: {"limit_bytes": pool.cache_bytes})
    with pytest.raises(ValueError, match="budget"):
        KVCachePool(model, 3, device="cpu", hbm_fraction=0.5)


# -- the engine --------------------------------------------------------------

def test_rect_engine_greedy_tokens_identical_to_jax_engine(weights):
    prompts = _prompts()
    want = _serve(_jax(weights, **RECT_KW), prompts)
    got = _serve(_port(weights[1], **RECT_KW), prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_default_engine_is_rectangular(weights):
    with _port(weights[1]) as eng:
        assert isinstance(eng.pool, KVCachePool)
        tokens = eng.generate([3, 4, 5], max_new_tokens=4).result(
            timeout=120).tokens
    assert tokens.shape == (4,)


def test_rect_and_paged_engines_identical(weights):
    prompts = _prompts((5, 16, 11, 2))
    rect = _serve(_port(weights[1], **RECT_KW), prompts, new=20)
    paged = _serve(_port(weights[1], **PAGED_KW), prompts, new=20)
    for r, p in zip(rect, paged):
        np.testing.assert_array_equal(r, p)


@pytest.mark.parametrize("kw", [RECT_KW, PAGED_KW],
                         ids=["rect", "paged"])
def test_sampled_streams_identical_to_jax_engine(weights, kw):
    prompts = _prompts()
    want = _serve(_jax(weights, **kw, **SAMPLED), prompts)
    got = _serve(_port(weights[1], **kw, **SAMPLED), prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [RECT_KW, PAGED_KW],
                         ids=["rect", "paged"])
def test_no_warmup_tokens_identical_to_jax_engine(weights, kw, monkeypatch):
    """``warmup=False``: every declared shape is still made in
    ``__init__`` but none runs before the first request, and the tokens
    are the JAX engine's under ``warmup=False``."""
    warmed = []
    monkeypatch.setattr(tgen._StepRunner, "warm", warmed.append)
    prompts = _prompts()
    want = _serve(_jax(weights, **kw, warmup=False), prompts)
    engine = _port(weights[1], **kw, warmup=False)
    assert warmed == []
    assert engine.compiled_executables == {"prefill": (16,),
                                           "decode": (1, 2)}
    got = _serve(engine, prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pick_token_equals_jax():
    """The port's ``_pick_token`` on 20 seeded rows of logits: JAX's
    choice greedily and under sampling, each request stream drawn
    alike."""
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((20, 256)).astype(np.float32) * 3
    for sampling in (False, True):
        engine = types.SimpleNamespace(_sampling=sampling, _temperature=0.7)
        treq = types.SimpleNamespace(rng=np.random.default_rng([321, 4]))
        jreq = types.SimpleNamespace(rng=np.random.default_rng([321, 4]))
        got = [tgen.GenerationEngine._pick_token(engine, treq, r)
               for r in rows]
        want = [jgen.GenerationEngine._pick_token(engine, jreq, r)
                for r in rows]
        assert got == want
        assert len(set(got)) > (10 if sampling else 1)


def test_same_seed_same_stream_other_seed_differs(weights):
    prompts = _prompts()
    a = _serve(_port(weights[1], **RECT_KW, **SAMPLED), prompts, new=16)
    b = _serve(_port(weights[1], **RECT_KW, **SAMPLED), prompts, new=16)
    c = _serve(_port(weights[1], **RECT_KW, **dict(SAMPLED, seed=322)),
               prompts, new=16)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, z) for x, z in zip(a, c))
    assert all(0 <= t < 256 for x in a + c for t in x)


CHUNK_KW = dict(num_slots=2, slot_ladder=(1, 2), prefill_buckets=(16, 64),
                page_size=16)


@pytest.mark.parametrize("chunk,steps", [(4, 3 + 10 + 1 + 5),
                                         (16, 1 + 3 + 1 + 2)])
def test_chunked_prefill_identical_to_jax_and_one_shot(weights, chunk,
                                                       steps):
    """Prompts of 9, 40, 3 and 17 tokens in chunks of 4 (a width of its
    own) and of 16 (the first bucket's width, whose runner it shares)."""
    prompts = _prompts((9, 40, 3, 17))
    want = _serve(_jax(weights, **CHUNK_KW, prefill_chunk=chunk), prompts)
    got = _serve(_port(weights[1], **CHUNK_KW, prefill_chunk=chunk),
                 prompts)
    assert telemetry.counter("serving.decode.chunk.steps").value == steps
    assert telemetry.counter("serving.decode.chunk.admitted").value == 4
    one_shot = _serve(_port(weights[1], **CHUNK_KW), prompts)
    for g, w, o in zip(got, want, one_shot):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)


def test_chunk_shares_a_bucket_of_its_width(weights):
    with _port(weights[1], **CHUNK_KW, prefill_chunk=16) as eng:
        assert eng.compiled_executables == {
            "prefill": (16, 64), "decode": (1, 2), "prefill_chunk": (16,)}
        assert eng._chunk_run is eng._prefill_runs[16]
        assert telemetry.counter("serving.decode.compiles").value == 4
    with _port(weights[1], **CHUNK_KW, prefill_chunk=4) as eng:
        assert eng._chunk_run not in eng._prefill_runs.values()
        assert telemetry.counter("serving.decode.compiles").value == 4 + 5


@pytest.mark.parametrize("kw,match", [
    (dict(RECT_KW, prefill_chunk=8), "requires page_size"),
    (dict(PAGED_KW, prefill_chunk=1), ">= 2"),
    (dict(PAGED_KW, prefill_chunk=129), "exceeds model max_len"),
    (dict(RECT_KW, kv_dtype="native"), "kv_dtype requires page_size"),
    (dict(RECT_KW, sampling=True, temperature=0.0), "temperature"),
    (dict(RECT_KW, prefill_buckets=(1, 16)), "must be >= 2"),
    (dict(RECT_KW, prefill_buckets=(256,)), "exceeds model max_len"),
    (dict(RECT_KW, slot_ladder=(1,)), "must top out")],
    ids=["chunk-unpaged", "chunk-1", "chunk-wide", "kv-unpaged",
         "temperature", "bucket-1", "bucket-wide", "ladder"])
def test_value_errors_as_jax(weights, kw, match):
    """Every ValueError of the JAX engine's constructor that the port's
    options reach, raised alike by both."""
    with pytest.raises(ValueError, match=match):
        _jax(weights, **kw)
    with pytest.raises(ValueError, match=match):
        _port(weights[1], **kw)


@pytest.mark.parametrize("kw,declared", [
    (RECT_KW, {"prefill": (16,), "decode": (1, 2)}),
    (PAGED_KW, {"prefill": (16,), "decode": (1, 2)}),
    (dict(CHUNK_KW, prefill_chunk=4),
     {"prefill": (16, 64), "decode": (1, 2), "prefill_chunk": (4,)})],
    ids=["rect", "paged", "chunked"])
def test_declared_shapes_never_grow(weights, kw, declared):
    """Mixed traffic (every bucket, every ladder width, retirements
    mid-flight) runs only the shapes made in ``__init__``."""
    prompts = _prompts((3, 16, 9, 12, 1))
    with _port(weights[1], **kw) as eng:
        assert eng.compiled_executables == declared
        compiles = telemetry.counter("serving.decode.compiles").value
        assert compiles == len(declared["prefill"]) + len(
            declared["decode"]) + len(declared.get("prefill_chunk", ()))
        runners = dict(eng._prefill_runs), dict(eng._decode_runs)
        futs = [eng.generate(p, max_new_tokens=n)
                for p, n in zip(prompts, (3, 9, 1, 6, 12))]
        assert all(f.result(timeout=120).reason == "length" for f in futs)
        assert eng.compiled_executables == declared
        assert (dict(eng._prefill_runs), dict(eng._decode_runs)) == runners
        assert telemetry.counter("serving.decode.compiles").value \
            == compiles


@pytest.mark.parametrize("kw", [RECT_KW, PAGED_KW,
                                dict(CHUNK_KW, prefill_chunk=4)],
                         ids=["rect", "paged", "chunked"])
def test_no_stale_static_input_leaks(weights, kw):
    """A short request served after a longer one in the same shapes
    gives the tokens a fresh engine gives it."""
    long, short = _prompts((15, 4), seed=11)
    fresh = _serve(_port(weights[1], **kw), [short], new=6)[0]
    with _port(weights[1], **kw) as eng:
        eng.generate(long, max_new_tokens=20).result(timeout=120)
        after = eng.generate(short, max_new_tokens=6).result(
            timeout=120).tokens
    np.testing.assert_array_equal(after, fresh)
