"""The port's speculative decoding against the JAX package's.

Both packages serve ``gpt_tiny`` in float32 on the same bridged weights,
on both pools, with an :class:`NgramDraft` (``spec_k=3``) and with a
``gpt_tiny`` :class:`ModelDraft` (``spec_k=2``) that holds the target's
own weights (its proposals are mostly accepted: the full-accept walk
and the draft's cache-filling feed are driven). Prompts repeat a seeded
phrase, so that the n-gram draft's proposals are often accepted. What
is held:

- ``NgramDraft`` proposals equal JAX's on the same contexts;
- greedy speculative tokens equal the port's plain greedy tokens, and
  sampled speculative streams the port's plain sampled streams under
  the same seed, for each pool and draft (token identity);
- each pool, each draft, greedy and sampled, against the JAX engine's
  speculative tokens (three JAX engines: rect n-gram greedy, paged
  model greedy, paged n-gram sampled);
- the n-gram draft's proposed and accepted counts equal JAX's (the
  draft is host work, so they are exact);
- ``compiled_executables`` equals JAX's, and ``serving.decode.compiles``
  does not move under traffic.

Each JAX engine is built and driven once for the module.
"""

import numpy as np
import pytest
import torch

from distkeras_tpu import telemetry as jtelemetry
from distkeras_tpu.models import gpt as jgpt
from distkeras_tpu.serving import GenerationEngine as JaxEngine
from distkeras_tpu.serving import ModelDraft as JModelDraft
from distkeras_tpu.serving import NgramDraft as JNgramDraft
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.serving import (GenerationEngine, ModelDraft,
                                         NgramDraft)
from distkeras_tpu_torch.utils import bridge

RECT = dict(num_slots=2, slot_ladder=(1, 2), prefill_buckets=(32,))
PAGED = dict(RECT, page_size=16)
POOLS = {"rect": RECT, "paged": PAGED}
SAMPLED = dict(sampling=True, temperature=0.7, seed=321)
#: (pool, draft, sampled) configurations: each is held against the
#: port's engine with no draft; those in JAX_CASES also against the JAX
#: engine (each pool, each draft, greedy and sampled, in three JAX
#: engines rather than eight)
CASES = [(pool, draft, sampled) for sampled in (False, True)
         for draft in ("ngram", "model") for pool in ("rect", "paged")]
JAX_CASES = [("rect", "ngram", False), ("paged", "model", False),
             ("paged", "ngram", True)]
SPEC = ("serving.decode.spec.proposed", "serving.decode.spec.accepted")


@pytest.fixture(scope="module")
def weights():
    """Seeded port weights as a flax param tree, for the target and the
    model draft alike."""
    model = tgpt.init_params(tgpt.gpt_tiny(), torch.Generator().manual_seed(0))
    params = bridge.state_dict_to_flax(model.state_dict())
    return jgpt.gpt_tiny(), params, jgpt.gpt_tiny(), params


def _prompts():
    rng = np.random.default_rng(8)
    phrase = rng.integers(1, 256, 6).tolist()
    return [phrase * 3 + rng.integers(1, 256, 2).tolist(), phrase * 2,
            rng.integers(1, 256, 11).tolist()]


def _drive(make, registry, new=16):
    registry.reset()
    eng = make()
    with eng:
        declared = eng.compiled_executables
        compiles = registry.counter("serving.decode.compiles").value
        futs = [eng.generate(p, max_new_tokens=new) for p in _prompts()]
        tokens = [f.result(timeout=120).tokens.tolist() for f in futs]
        assert eng.compiled_executables == declared
        assert registry.counter("serving.decode.compiles").value \
            == compiles
    return {"tokens": tokens, "declared": declared, "compiles": compiles,
            "spec": {n: registry.counter(n).value for n in SPEC}}


def _jax_draft(weights, draft):
    if draft == "ngram":
        return JNgramDraft(), 3
    _, _, jdraft, dparams = weights
    return JModelDraft(jdraft, dparams), 2


def _port_draft(weights, draft):
    if draft == "ngram":
        return NgramDraft(), 3
    model = bridge.load_flax_params(tgpt.gpt_tiny(), weights[3])
    return ModelDraft(model), 2


def _port(weights, pool, draft=None, sampled=False):
    model = bridge.load_flax_params(tgpt.gpt_tiny(), weights[1])
    kw = dict(POOLS[pool], **(SAMPLED if sampled else {}))
    if draft is not None:
        kw["draft"], kw["spec_k"] = _port_draft(weights, draft)
    return GenerationEngine(model, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_runs(weights):
    runs = {}
    for pool, draft, sampled in JAX_CASES:
        def make(pool=pool, draft=draft, sampled=sampled):
            d, k = _jax_draft(weights, draft)
            return JaxEngine(weights[0], weights[1], draft=d, spec_k=k,
                             warmup=False, **POOLS[pool],
                             **(SAMPLED if sampled else {}))
        runs[pool, draft, sampled] = _drive(make, jtelemetry)
    return runs


@pytest.fixture(scope="module")
def plain_runs(weights):
    """The port's engines with no draft, greedy and sampled."""
    return {(pool, sampled): _drive(
        lambda: _port(weights, pool, sampled=sampled), telemetry)
        for pool in POOLS for sampled in (False, True)}


def test_ngram_proposals_equal_jax():
    rng = np.random.default_rng(2)
    phrase = rng.integers(1, 50, 5).tolist()
    ctxs = [phrase * 3, rng.integers(1, 50, 9).tolist(), [7], [4, 4, 4, 4],
            phrase + rng.integers(1, 50, 3).tolist() + phrase[:2]]
    for ngram in (1, 2, 3):
        got, want = NgramDraft(ngram), JNgramDraft(ngram)
        for slot, ctx in enumerate(ctxs):
            for d in (got, want):
                d.begin(slot, ctx[:-1], ctx[-1])
        slots = list(range(len(ctxs)))
        for k in (1, 4):
            np.testing.assert_array_equal(
                got.propose(slots, None, None, k),
                want.propose(slots, None, None, k))
        for d in (got, want):
            d.observe(0, [phrase[0], phrase[1]])
        np.testing.assert_array_equal(got.propose([0], None, None, 3),
                                      want.propose([0], None, None, 3))
    with pytest.raises(ValueError):
        NgramDraft(0)


@pytest.mark.parametrize("pool,draft,sampled", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_spec_tokens_equal_plain_and_jax(weights, jax_runs, plain_runs,
                                         pool, draft, sampled):
    run = _drive(lambda: _port(weights, pool, draft, sampled), telemetry)
    assert run["tokens"] == plain_runs[pool, sampled]["tokens"]
    want = jax_runs.get((pool, draft, sampled))
    if want is not None:
        assert run["tokens"] == want["tokens"]
        assert run["declared"] == want["declared"]
        assert run["compiles"] == want["compiles"]
        if draft == "ngram":
            assert run["spec"] == want["spec"]
    assert run["declared"]["verify"] == (1, 2)
    if draft == "model":
        assert run["declared"]["draft_prefill"] == (32,)
        assert run["declared"]["draft_decode"] == (1, 2)
    else:
        assert "draft_prefill" not in run["declared"]
    assert run["spec"]["serving.decode.spec.proposed"] > 0
    if not sampled:
        assert run["spec"]["serving.decode.spec.accepted"] > 0


def test_model_draft_must_cover_the_targets_context(weights):
    short = tgpt.gpt_tiny(num_layers=1, max_len=64)
    model = bridge.load_flax_params(tgpt.gpt_tiny(), weights[1])
    with pytest.raises(ValueError, match="draft max_len"):
        GenerationEngine(model, device="cpu", draft=ModelDraft(short),
                         spec_k=2, **RECT)
