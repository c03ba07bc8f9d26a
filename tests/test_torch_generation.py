"""The port's paged GenerationEngine against the JAX package's.

Both engines serve ``gpt_tiny`` on the same bridged float32 weights with
``page_size=16``, one prefill bucket and a ``(1, 2)`` lane ladder; three
concurrent prompts (one more than the slots) must come back with
identical greedy tokens. The port's own engine then shows the serving
contracts: page exhaustion is backpressure (a queued request waits for
pages and still completes), ``QueueFull`` at capacity,
``DeadlineExceeded`` at admission, the warmed shape set, and
NotImplementedError for the kwargs not ported yet (the rectangular
pool, sampling and chunked prefill are held to the JAX engine in
tests/test_torch_generation_options.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import gpt as jgpt
from distkeras_tpu.serving import GenerationEngine as JaxEngine
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.serving import (DeadlineExceeded, EngineClosed,
                                         GenerationEngine, PagedKVCachePool,
                                         QueueFull)
from distkeras_tpu_torch.utils import bridge

ENGINE_KW = dict(num_slots=2, slot_ladder=(1, 2), prefill_buckets=(16,),
                 page_size=16)


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


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 256, n).tolist() for n in (5, 16, 11)]


def test_engine_greedy_tokens_identical_to_jax_engine(weights):
    jmodel, params = weights
    prompts = _prompts()
    with JaxEngine(jmodel, params, **ENGINE_KW) as jeng:
        want = [f.result(timeout=120) for f in
                [jeng.generate(p, max_new_tokens=12) for p in prompts]]
    with GenerationEngine(_port_model(params), device="cpu",
                          **ENGINE_KW) as eng:
        got = [f.result(timeout=120) for f in
               [eng.generate(p, max_new_tokens=12) for p in prompts]]
    for g, w in zip(got, want):
        assert g.reason == w.reason == "length"
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_page_exhaustion_is_backpressure(weights):
    """8 pages back two 3-page requests at a time: the third waits at the
    queue head until a retiring request returns its pages, then
    completes with the tokens it gets when served alone."""
    _, params = weights
    prompts = _prompts()
    events = []
    with GenerationEngine(_port_model(params), device="cpu", num_pages=8,
                          **ENGINE_KW) as eng:
        solo = eng.generate(prompts[2], max_new_tokens=30).result(
            timeout=120)
        futs = []
        with eng._cv:  # admit all three in one scheduler iteration
            for i, p in enumerate(prompts):
                f = eng.generate(p, max_new_tokens=30,
                                 stream=lambda tok, i=i: events.append(
                                     ("token", i)))
                f.add_done_callback(lambda _, i=i: events.append(("done",
                                                                  i)))
                futs.append(f)
        results = [f.result(timeout=120) for f in futs]
        assert eng.pool.free_pages == 8
    assert all(r.reason == "length" for r in results)
    np.testing.assert_array_equal(results[2].tokens, solo.tokens)
    first_token_of_third = events.index(("token", 2))
    assert any(e[0] == "done" for e in events[:first_token_of_third])


def test_queue_full_and_deadline(weights):
    _, params = weights
    with GenerationEngine(_port_model(params), device="cpu",
                          queue_capacity=2, **ENGINE_KW) as eng:
        with eng._cv:  # hold the scheduler off the queue
            futs = [eng.generate([1, 2, 3], max_new_tokens=2)
                    for _ in range(2)]
            with pytest.raises(QueueFull):
                eng.generate([1, 2, 3], max_new_tokens=2)
        for f in futs:
            assert f.result(timeout=120).reason == "length"
        late = eng.generate([1, 2, 3], max_new_tokens=4, timeout_ms=0)
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=120)
    with pytest.raises(EngineClosed):
        eng.generate([1, 2, 3])
    assert telemetry.counter("serving.decode.rejected").value == 1
    assert telemetry.counter("serving.decode.deadline_exceeded").value == 1


def test_warmed_shapes_and_pool_geometry(weights):
    _, params = weights
    with GenerationEngine(_port_model(params), device="cpu",
                          **ENGINE_KW) as eng:
        assert eng.compiled_executables == {"prefill": (16,),
                                            "decode": (1, 2)}
        assert eng.pool.pages_per_slot == 128 // 16
        assert eng.pool.pool[0]["k"].shape == (2 * 8 + 1, 16, 2, 16)


def test_streaming_and_eos(weights):
    _, params = weights
    seen = []
    with GenerationEngine(_port_model(params), device="cpu",
                          **ENGINE_KW) as eng:
        full = eng.generate([7, 8, 9], max_new_tokens=6).result(timeout=120)
        eos = int(full.tokens[2])
        res = eng.generate([7, 8, 9], max_new_tokens=6, eos_id=eos,
                           stream=seen.append).result(timeout=120)
    assert res.reason == "eos"
    stop = list(full.tokens).index(eos)
    np.testing.assert_array_equal(res.tokens, full.tokens[:stop + 1])
    assert seen == res.tokens.tolist()


@pytest.mark.parametrize("kw", [
    dict(prefix_cache_bytes=1 << 20), dict(spec_k=2),
    dict(kv_dtype="int8")], ids=["kw1", "kw2", "kw4"])
def test_options_not_ported_raise(weights, kw):
    _, params = weights
    args = dict(ENGINE_KW, device="cpu")
    args.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A"):
        GenerationEngine(_port_model(params), **args)


def test_pool_reservation_all_or_nothing():
    model = tgpt.gpt_tiny()
    pool = PagedKVCachePool(model, 4, page_size=16, num_pages=10,
                            device="cpu")
    a, b = pool.allocate(), pool.allocate()
    assert pool.reserve(a, 100)          # 7 pages
    assert not pool.reserve(b, 64)       # 4 > 3 left: nothing claimed
    assert pool.free_pages == 3
    assert (pool.page_table_row(b) == pool.scratch_page).all()
    pool.free(a)
    assert pool.free_pages == 10 and pool.reserve(b, 64)
    with pytest.raises(ValueError):
        pool.reserve(b, 129)             # wider than the page table
    with pytest.raises(ValueError):
        PagedKVCachePool(model, 2, page_size=16, num_pages=4, device="cpu")


def test_engine_moves_model_to_requested_device(weights):
    _, params = weights
    model = _port_model(params)
    with GenerationEngine(model, device="cpu", **ENGINE_KW) as eng:
        assert eng.device == torch.device("cpu")
        assert all(p.device.type == "cpu" for p in model.parameters())
        assert not model.training
