"""The port's prefix cache and host swap against the JAX package's.

- :class:`PrefixCache`: one scripted insert / lookup / evict sequence
  gives the same hits, misses, evictions, entries and bytes in both.
- The swap pair: gathering a slot's pages (swap out) and scattering them
  back (swap in) restores the pool bitwise, native and int8 pages.
- The engine with ``prefix_cache_bytes``: ``gpt_tiny`` in float32 on the
  same bridged weights, the same traffic in four rounds (a 37-token
  system prompt alone, a miss that is parked; the system prompt with
  three tails, hits at 37 whose tails prefill from mid-page; the same
  three again, full hits with no model call; one conversation resumed
  with what it generated, a full hit on the entry parked at its
  retirement). Its greedy tokens equal the port's engine with no cache
  and JAX's engine with a cache, its prefix and swap counters equal
  JAX's, its declared shapes are JAX's and do not grow, and a prefix
  exported from one engine and imported into another gives the same
  tokens. Tolerance: token identity, counters equal.

The JAX engine is built and driven once for the module.
"""

import numpy as np
import pytest
import torch

from distkeras_tpu import telemetry as jtelemetry
from distkeras_tpu.models import gpt as jgpt
from distkeras_tpu.serving import GenerationEngine as JaxEngine
from distkeras_tpu.serving import PrefixCache as JPrefixCache
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.serving import (GenerationEngine, PrefixCache,
                                         make_swap_in_fn, make_swap_out_fn)
from distkeras_tpu_torch.serving.kv_cache import tree_leaves
from distkeras_tpu_torch.utils import bridge

KW = dict(num_slots=2, slot_ladder=(1, 2), prefill_buckets=(16, 64),
          page_size=16)
BUDGET = 1 << 24
COUNTERS = ("serving.decode.prefix.hits", "serving.decode.prefix.misses",
            "serving.decode.prefix.full_hits",
            "serving.decode.prefix.inserts",
            "serving.decode.prefix.evictions",
            "serving.decode.paged.swapped_in",
            "serving.decode.paged.swapped_out", "serving.decode.prefills",
            "serving.decode.tokens")


@pytest.fixture(scope="module")
def weights():
    """Seeded port weights and the same weights as a flax param tree."""
    model = tgpt.init_params(tgpt.gpt_tiny(), torch.Generator().manual_seed(0))
    return jgpt.gpt_tiny(), bridge.state_dict_to_flax(model.state_dict())


def _port(params, **kw):
    model = bridge.load_flax_params(tgpt.gpt_tiny(), params)
    return GenerationEngine(model, device="cpu", **KW, **kw)


def _traffic():
    rng = np.random.default_rng(7)
    system = rng.integers(1, 256, 37).tolist()
    return system, [system + rng.integers(1, 256, n).tolist()
                    for n in (4, 9, 20)]


def _drive(make, registry):
    """The module docstring's four rounds on the engine ``make()``
    builds: the tokens of each round, the counters of ``registry`` (reset
    first), and the declared shapes and compiles before and after."""
    registry.reset()
    eng = make()
    system, tails = _traffic()

    def serve(prompts):
        futs = [eng.generate(p, max_new_tokens=12) for p in prompts]
        return [f.result(timeout=120).tokens.tolist() for f in futs]

    with eng:
        declared = eng.compiled_executables
        compiles = registry.counter("serving.decode.compiles").value
        rounds = [serve([system]), serve(tails), serve(tails)]
        rounds.append(serve([tails[0] + rounds[1][0][:-1]]))
        after = (eng.compiled_executables,
                 registry.counter("serving.decode.compiles").value)
    return {"tokens": rounds,
            "counters": {n: registry.counter(n).value for n in COUNTERS},
            "declared": declared, "after": after, "compiles": compiles}


@pytest.fixture(scope="module")
def jax_run(weights):
    jmodel, params = weights
    return _drive(lambda: JaxEngine(jmodel, params,
                                    prefix_cache_bytes=BUDGET, **KW),
                  jtelemetry)


@pytest.fixture(scope="module")
def port_run(weights):
    return _drive(lambda: _port(weights[1], prefix_cache_bytes=BUDGET),
                  telemetry)


def test_prefix_engine_tokens_identical_to_jax_and_to_no_cache(
        weights, jax_run, port_run):
    assert port_run["tokens"] == jax_run["tokens"]
    plain = _drive(lambda: _port(weights[1]), telemetry)
    assert port_run["tokens"] == plain["tokens"]
    # the resumed conversation's first token is the last one it emitted
    assert port_run["tokens"][3][0][0] == port_run["tokens"][1][0][-1]
    assert plain["counters"]["serving.decode.prefills"] == 8


def test_prefix_counters_equal_jax(jax_run, port_run):
    assert port_run["counters"] == jax_run["counters"]
    c = port_run["counters"]
    assert c["serving.decode.prefix.hits"] == 7
    assert c["serving.decode.prefix.full_hits"] == 4
    assert c["serving.decode.prefills"] == 4


def test_prefix_declared_shapes_equal_jax_and_never_grow(jax_run,
                                                         port_run):
    assert port_run["declared"] == jax_run["declared"] == {
        "prefill": (16, 64), "decode": (1, 2), "swap": ("in", "out")}
    assert port_run["compiles"] == jax_run["compiles"] == 6
    assert port_run["after"] == (port_run["declared"],
                                 port_run["compiles"])


def test_export_import_prefix_gives_the_same_tokens(weights):
    system, tails = _traffic()
    with _port(weights[1], prefix_cache_bytes=BUDGET) as a:
        want = a.generate(tails[1], max_new_tokens=12).result(
            timeout=120).tokens
        shipped = a.export_prefix(tails[1])
        assert a.export_prefix(system) is None
    data, logits = shipped
    leaves = tree_leaves(data)
    assert [x.shape[0] for x in leaves] == [3] * len(leaves)
    telemetry.reset()
    with _port(weights[1], prefix_cache_bytes=BUDGET) as b:
        bad = [x.to(torch.float64) for x in leaves]
        assert not b.import_prefix(tails[1], bad, logits)
        assert not b.import_prefix(tails[1], leaves[1:], logits)
        assert b.import_prefix(tails[1], leaves, logits)
        got = b.generate(tails[1], max_new_tokens=12).result(
            timeout=120).tokens
    np.testing.assert_array_equal(got, want)
    assert telemetry.counter("serving.decode.prefix.full_hits").value == 1
    assert telemetry.counter("serving.decode.prefix.imports").value == 1
    assert telemetry.counter("serving.decode.prefills").value == 0
    with _port(weights[1]) as c:  # no cache: nothing to export or import
        assert c.export_prefix(tails[1]) is None
        assert not c.import_prefix(tails[1], leaves, logits)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_swap_round_trip_is_bitwise(kv_dtype):
    rng = np.random.default_rng(4)
    model = tgpt.gpt_tiny()
    pool = tgpt.init_paged_cache(model, 12, 16, kv_dtype=kv_dtype,
                                 device="cpu")
    for leaf in tree_leaves(pool):
        leaf.copy_(torch.from_numpy(
            rng.standard_normal(leaf.shape) * 50).to(leaf.dtype))
    before = [leaf.clone() for leaf in tree_leaves(pool)]
    ids = torch.tensor([3, 7, 11, 12, 12, 12, 12, 12], dtype=torch.int32)
    out = make_swap_out_fn()(pool, ids)
    parked = [x[:3].clone() for x in out]
    for leaf in tree_leaves(pool):
        leaf[ids[:3].long()] = 0
    data = [torch.cat([p, torch.zeros((5,) + p.shape[1:], dtype=p.dtype)])
            for p in parked]
    make_swap_in_fn()(pool, ids, data)
    for got, want in zip(tree_leaves(pool), before):
        assert got.dtype == want.dtype
        assert torch.equal(got[:12], want[:12])


def _entry(rng, pages, torch_side):
    a = rng.standard_normal((pages, 16, 2, 16)).astype(np.float32)
    tree = ({"k": a, "v": a.copy()},)
    if torch_side:
        tree = tuple({k: torch.from_numpy(v) for k, v in layer.items()}
                     for layer in tree)
    return tree


def test_prefix_cache_scripted_sequence_as_jax():
    """Inserts that overflow the budget (LRU evictions), a refused
    oversize entry, a re-insert of one key, longest-prefix lookups,
    misses, and an explicit evict: the same outcome step by step."""
    telemetry.reset()
    page = 16 * 2 * 16 * 4 * 2  # k + v bytes of one page
    caches = {"port": PrefixCache(10 * page + 4 * 256),
              "jax": JPrefixCache(10 * page + 4 * 256)}
    logs = {}
    for side, cache in caches.items():
        rng = np.random.default_rng(0)
        log = []
        seqs = [list(range(1, n + 1)) for n in (10, 20, 40, 70)]
        for s, pages in zip(seqs, (1, 2, 3, 5)):
            cache.insert(s, _entry(rng, pages, side == "port"),
                         np.zeros(64, np.float32))
        cache.insert(list(range(500, 700)), _entry(rng, 12, side == "port"))
        cache.insert(seqs[1], _entry(rng, 2, side == "port"))
        for prompt in (seqs[3] + [9], seqs[1] + [99], [5, 6], seqs[2][:30],
                       seqs[2]):
            e = cache.lookup(prompt)
            log.append(None if e is None else e.length)
        e = cache.lookup(seqs[2] + [1])
        cache.evict(e)
        log.append(cache.lookup(seqs[2] + [1]).length)
        log.append((len(cache), cache.bytes, cache.hits, cache.misses,
                    cache.evictions, round(cache.hit_rate, 9),
                    cache.has(seqs[1]), cache.peek(seqs[0]) is None))
        logs[side] = log
    assert logs["port"] == logs["jax"]
    assert logs["port"][:5] == [70, 20, None, 20, 40]
    assert telemetry.counter("serving.decode.prefix.evictions").value \
        == caches["port"].evictions > 0
