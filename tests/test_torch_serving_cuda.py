"""The port's serving engines on a card: one CUDA graph per declared
shape (in each weight bank), replayed under traffic.

Skipped without a CUDA device (on the CPU the engine's runners call the
step eagerly; tests/test_torch_generation_options.py holds that path to
the JAX engine). This file imports no JAX, so it runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py

``gpt_tiny`` in float32 with TF32 off, seeded weights. Tolerance: the
engines' greedy tokens equal the argmax of the model's full forward
(plain attention, no kernel) re-run over each growing prefix, also with
the prefix cache and with speculative decoding on; the int8 KV engine's
tokens equal the same engine's with its attention through the plain
version; a paged call replayed from a graph equals the eager call
bitwise, and so does a page swap out and back in. Live weight swaps: a
bank swap keeps in-flight requests on their pinned version (tokens of
engines built on each version) and captures nothing; the one-shot
engine's ``shadow_forward`` equals its live output bitwise. The fleet:
two replicas on the card behind the port's router give, disaggregated,
one engine's local tokens; a replica killed with a stream in flight
re-queues it onto the other, and frees its graphs and pool.
"""

import copy

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.ops.kernels import flash_attention as tfa
from distkeras_tpu_torch.serving import (GenerationEngine, ModelDraft,
                                         NgramDraft)
from distkeras_tpu_torch.serving.kv_cache import tree_leaves

pytestmark = pytest.mark.cuda

KW = dict(num_slots=2, slot_ladder=(1, 2), prefill_buckets=(16, 64))
MODES = {"paged": dict(KW, page_size=16), "rect": KW,
         "chunked": dict(KW, page_size=16, prefill_chunk=8)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine's graphs and the paged "
                    "kernel have no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    telemetry.reset()
    yield torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = prev
    telemetry.reset()


def _model(dev, cls=tgpt.CausalLM, seed=0):
    model = cls(vocab_size=256, max_len=128, num_layers=2, num_heads=2,
                width=32, mlp_dim=64, dtype=torch.float32)
    return tgpt.init_params(model, torch.Generator().manual_seed(seed)).to(
        dev)


def _prompts(lengths=(9, 40, 3, 17), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).tolist() for n in lengths]


def _serve(eng, prompts, new=10):
    futs = [eng.generate(p, max_new_tokens=new) for p in prompts]
    return [f.result(timeout=300).tokens for f in futs]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_graph_engine_greedy_equals_full_forward(cuda_device, mode):
    model = _model(cuda_device)
    prompts = _prompts()
    with GenerationEngine(model, device=cuda_device, **MODES[mode]) as eng:
        results = _serve(eng, prompts)
    with torch.no_grad():
        for p, tokens in zip(prompts, results):
            seq = list(p)
            for tok in tokens.tolist():
                logits = model(torch.tensor([seq], device=cuda_device))
                assert tok == int(torch.argmax(logits[0, -1])), (mode, seq)
                seq.append(tok)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_shapes_and_pool_fixed_under_traffic(cuda_device, mode):
    model = _model(cuda_device)
    with GenerationEngine(model, device=cuda_device, **MODES[mode]) as eng:
        declared = eng.compiled_executables
        compiles = telemetry.counter("serving.decode.compiles").value
        assert compiles == sum(len(v) for v in declared.values()) - (
            1 if mode == "chunked" and 8 in declared["prefill"] else 0)
        ptrs = [a.data_ptr() for layer in eng.pool.pool
                for a in layer.values()]
        _serve(eng, _prompts((3, 16, 60, 9, 1), seed=4), new=7)
        assert eng.compiled_executables == declared
        assert telemetry.counter("serving.decode.compiles").value \
            == compiles
        assert [a.data_ptr() for layer in eng.pool.pool
                for a in layer.values()] == ptrs
        assert eng.graph_pool_bytes > 0


def test_paged_launches_counted_per_replay(cuda_device):
    model = _model(cuda_device)
    count = lambda name: telemetry.counter(  # noqa: E731
        f"serving.decode.{name}").value
    with GenerationEngine(model, device=cuda_device,
                          **MODES["paged"]) as eng:
        calls0 = count("prefills") + count("steps")
        tfa.paged_flash_attention.launches = 0
        _serve(eng, _prompts())
        launches = tfa.paged_flash_attention.launches
        calls = count("prefills") + count("steps") - calls0
    assert launches == model.num_layers * calls > 0


@pytest.mark.parametrize("mode", ["paged", "rect"])
def test_sampled_streams_deterministic_on_card(cuda_device, mode):
    model = _model(cuda_device)
    kw = dict(MODES[mode], sampling=True, temperature=0.7, seed=321)
    streams = []
    for seed in (321, 321, 322):
        with GenerationEngine(model, device=cuda_device,
                              **dict(kw, seed=seed)) as eng:
            streams.append(_serve(eng, _prompts(), new=16))
    for a, b in zip(streams[0], streams[1]):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, c)
               for a, c in zip(streams[0], streams[2]))
    assert all(0 <= t < 256 for s in streams for x in s for t in x)


def _paged_args(dev, b=8, t=2, h=2, d=16, ps=16, pmax=8, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev)
    table = rng.permutation(b * pmax + 1)[:b * pmax].reshape(b, pmax)
    ci = rng.integers(0, pmax * ps - t + 1, size=b)
    return (mk(b, t, h, d), mk(b * pmax + 1, ps, h, d),
            mk(b * pmax + 1, ps, h, d),
            torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(ci.astype(np.int32)).to(dev))


def test_paged_replay_equals_eager_and_counters_need_reserving(cuda_device):
    """A capture on a stream whose arrival counters were never allocated
    raises; after ``reserve_counters`` the replayed graph (the second
    launch a programmatic dependent launch) gives the eager call's bits
    and leaves the counters at zero."""
    args = _paged_args(cuda_device)
    stream = torch.cuda.Stream(cuda_device)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="reserve_counters"):
        with torch.cuda.graph(graph, stream=stream):
            tfa.paged_flash_attention(*args)
    stream = torch.cuda.Stream(cuda_device)
    buf = tfa.reserve_counters(cuda_device, stream.cuda_stream,
                               tfa.counters_needed(8, 2, 2))
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        want = tfa.paged_flash_attention(*args)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = tfa.paged_flash_attention(*args)
    for _ in range(3):
        out.zero_()
        torch.cuda.synchronize()
        with torch.cuda.stream(stream):
            graph.replay()
        stream.synchronize()
        assert torch.equal(out, want)
        assert not buf.any()


def test_capture_counts_calls_apart_from_launches(cuda_device):
    """A paged call recorded into a graph launches nothing: it adds to
    ``captured``, not to ``launches``."""
    args = _paged_args(cuda_device, seed=1)
    stream = torch.cuda.Stream(cuda_device)
    tfa.reserve_counters(cuda_device, stream.cuda_stream,
                         tfa.counters_needed(8, 2, 2))
    torch.cuda.synchronize()
    launches = tfa.paged_flash_attention.launches
    with torch.cuda.stream(stream):
        tfa.paged_flash_attention(*args)
    stream.synchronize()
    assert tfa.paged_flash_attention.launches == launches + 1
    captured = tfa.paged_flash_attention.captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(2):
            tfa.paged_flash_attention(*args)
    assert tfa.paged_flash_attention.captured == captured + 2
    assert tfa.paged_flash_attention.launches == launches + 1


class _ReadsToHost(tgpt.CausalLM):
    """A model whose cache step reads a value to the host: fine eagerly,
    refused by a CUDA graph capture."""

    def forward(self, input_ids, cache=None, **kw):
        if cache is not None and int(input_ids.max().item()) < 0:
            raise AssertionError("unreachable")
        return super().forward(input_ids, cache=cache, **kw)


@pytest.mark.parametrize("mode", ["paged", "rect"])
def test_capture_failure_raises_from_constructor(cuda_device, mode):
    model = _model(cuda_device, cls=_ReadsToHost)
    with pytest.raises(RuntimeError):
        GenerationEngine(model, device=cuda_device, **MODES[mode])


#: engines with the options of the prefix cache and speculative decoding
#: (a draft binds to one engine: each call makes a new one; the model
#: draft holds the target's weights, so that proposals are accepted)
OPTIONS = {
    "prefix": lambda dev: dict(MODES["paged"], prefix_cache_bytes=1 << 24),
    "spec-ngram": lambda dev: dict(MODES["paged"], draft=NgramDraft(),
                                   spec_k=3),
    "spec-model": lambda dev: dict(MODES["paged"], spec_k=2,
                                   draft=ModelDraft(_model(dev))),
    "spec-model-rect": lambda dev: dict(KW, spec_k=2,
                                        draft=ModelDraft(_model(dev))),
}


def _repeating_prompts():
    """The system prompt alone, then with tails (prefix hits), and
    prompts that repeat a phrase (n-gram accepts)."""
    rng = np.random.default_rng(5)
    system = rng.integers(1, 256, 21).tolist()
    phrase = rng.integers(1, 256, 5).tolist()
    return [system] + [system + rng.integers(1, 256, n).tolist()
                       for n in (3, 30)] + [phrase * 4, phrase * 2 + [9]]


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_engines_greedy_equal_full_forward(cuda_device, option):
    model = _model(cuda_device)
    prompts = _repeating_prompts()
    with GenerationEngine(model, device=cuda_device,
                          **OPTIONS[option](cuda_device)) as eng:
        declared = eng.compiled_executables
        compiles = telemetry.counter("serving.decode.compiles").value
        results = _serve(eng, prompts[:1]) + _serve(eng, prompts[1:])
        again = _serve(eng, prompts[1:3])  # full hits under the cache
        assert eng.compiled_executables == declared
        assert telemetry.counter("serving.decode.compiles").value \
            == compiles
    for a, b in zip(again, results[1:3]):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        for p, tokens in zip(prompts, results):
            seq = list(p)
            for tok in tokens.tolist():
                logits = model(torch.tensor([seq], device=cuda_device))
                assert tok == int(torch.argmax(logits[0, -1])), (option,
                                                                 seq)
                seq.append(tok)
    if option == "prefix":
        assert telemetry.counter("serving.decode.prefix.hits").value >= 4
        assert telemetry.counter(
            "serving.decode.prefix.full_hits").value >= 2
    else:
        assert telemetry.counter("serving.decode.spec.accepted").value > 0


def test_int8_engine_equals_its_plain_attention(cuda_device, monkeypatch):
    """The int8 KV engine on graphs against the same engine with the
    paged kernel swapped for its plain version: the same tokens."""
    model = _model(cuda_device)
    prompts = _prompts()
    kw = dict(MODES["paged"], kv_dtype="int8")
    with GenerationEngine(model, device=cuda_device, **kw) as eng:
        got = _serve(eng, prompts, new=16)
    plain = lambda *a: tfa.paged_flash_attention_reference(*a)  # noqa
    plain.launches = plain.captured = 0
    monkeypatch.setattr(tfa, "paged_flash_attention", plain)
    with GenerationEngine(model, device=cuda_device, **kw) as eng:
        want = _serve(eng, prompts, new=16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_swap_round_trip_bitwise_on_card(cuda_device, kv_dtype):
    """The engine's swap pair on its graphs: three pages gathered to the
    host (through the pinned buffers) and scattered back after the pool
    lost them restore the pool bitwise."""
    model = _model(cuda_device)
    with GenerationEngine(model, device=cuda_device, kv_dtype=kv_dtype,
                          prefix_cache_bytes=1 << 24,
                          **MODES["paged"]) as eng:
        rng = np.random.default_rng(2)
        with torch.cuda.stream(eng.stream):
            for leaf in tree_leaves(eng.pool.pool):
                leaf.copy_(torch.from_numpy(
                    rng.standard_normal(leaf.shape) * 50).to(leaf.dtype))
        eng.stream.synchronize()
        before = [x.clone() for x in tree_leaves(eng.pool.pool)]
        ids = np.full(eng.pool.pages_per_slot, eng.pool.scratch_page,
                      np.int32)
        ids[:3] = (2, 9, 5)
        eng._swap_runs["out"](page_ids=ids)
        parked = eng._swap_runs["out"].fetch_rows(3)
        assert all(x.device.type == "cpu" for x in parked)
        with torch.cuda.stream(eng.stream):
            for leaf in tree_leaves(eng.pool.pool):
                leaf[torch.tensor((2, 9, 5), device=cuda_device)] = 0
        eng._swap_runs["in"](page_ids=ids, **{
            f"leaf{i}": x for i, x in enumerate(parked)})
        eng.stream.synchronize()
        scratch = eng.pool.scratch_page
        for got, want in zip(tree_leaves(eng.pool.pool), before):
            assert torch.equal(got[:scratch], want[:scratch])


@pytest.mark.parametrize("option", ["int8", "spec-ngram"])
def test_new_graphs_launch_counts_match_the_trace(cuda_device, option):
    """Every model call of the int8 and verify graphs launches the paged
    kernel once a layer, counted per replay, and the profiler's trace
    holds two paged kernels for each counted call."""
    from torch.profiler import ProfilerActivity, profile

    model = _model(cuda_device)
    kw = (dict(MODES["paged"], kv_dtype="int8") if option == "int8"
          else OPTIONS[option](cuda_device))
    count = lambda name: telemetry.counter(  # noqa: E731
        f"serving.decode.{name}").value
    with GenerationEngine(model, device=cuda_device, **kw) as eng:
        runs = list(eng._decode_runs.values()) + list(
            eng._verify_runs.values())
        assert all(r.launches == {tfa.paged_flash_attention:
                                  model.num_layers} for r in runs)
        calls0 = count("prefills") + count("steps")
        tfa.paged_flash_attention.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _serve(eng, _repeating_prompts())
            torch.cuda.synchronize()
        launches = tfa.paged_flash_attention.launches
        calls = count("prefills") + count("steps") - calls0
    assert launches == model.num_layers * calls > 0
    if option == "spec-ngram":
        assert count("spec.iterations") > 0
    traced = sum(e.count for e in prof.key_averages()
                 if "paged_logits_kernel" in e.key
                 or "paged_values_kernel" in e.key)
    assert traced == 2 * launches


def _perturbed(state, seed, scale=0.5):
    gen = torch.Generator().manual_seed(seed)
    return {k: v + scale * v.float().std().nan_to_num(1.0)
            * torch.randn(v.shape, generator=gen).to(v.device)
            for k, v in state.items()}


def test_bank_swap_keeps_pinned_tokens_and_captures_nothing(cuda_device):
    """Two requests in flight on v0, a swap to v1 (an in-place copy into
    the idle bank's captured tensors), two more admitted after: the first
    two give the tokens of an engine built on v0, the others those of an
    engine built on v1; no graph is captured and no weight tensor moves."""
    import threading

    v0 = _model(cuda_device).state_dict()
    v1 = _perturbed(v0, 1)
    prompts = _prompts()
    kw = dict(MODES["paged"], slot_ladder=(1, 2, 4), num_slots=4)

    def built_on(state, ps):
        model = _model(cuda_device)
        model.load_state_dict(state)
        with GenerationEngine(model, device=cuda_device, **kw) as eng:
            return [t.tolist() for t in _serve(eng, ps, new=40)]

    want = built_on(v0, prompts[:2]) + built_on(v1, prompts[2:])
    assert want[:2] != built_on(v1, prompts[:2])
    model = _model(cuda_device)
    with GenerationEngine(model, device=cuda_device, **kw) as eng:
        compiles = telemetry.counter("serving.decode.compiles").value
        ptrs = [[t.data_ptr() for t in b.model.state_dict().values()]
                for b in eng._banks]
        started = [threading.Event() for _ in prompts]
        futs = []
        for i, p in enumerate(prompts):
            if i == 2:
                eng.swap_weights(v1, 1)
                assert sorted(eng._versions) == [0, 1]
            futs.append(eng.generate(p, max_new_tokens=40, stream=lambda t,
                                     e=started[i]: e.set()))
            assert started[i].wait(60)
        got = [f.result(timeout=300).tokens.tolist() for f in futs]
        assert telemetry.counter("serving.decode.compiles").value \
            == compiles
        assert [[t.data_ptr() for t in b.model.state_dict().values()]
                for b in eng._banks] == ptrs
        assert eng.model_version == 1 and sorted(eng._versions) == [1]
    assert got == want


def test_serving_engine_on_card_shadow_equals_live_bitwise(cuda_device):
    """The one-shot engine over ``attention="flash"`` at 128-token rows:
    one flash launch a layer a batch, counted per replay; the served rows
    equal the plain forward of the same weights (``attention="full"``,
    eager; float32, TF32 off, within 1e-4); shadow_forward equals live
    output bitwise (live weights and a candidate), a swap captures
    nothing, and swapping back restores the output bitwise."""
    from distkeras_tpu_torch.serving import ServingEngine

    model = tgpt.init_params(
        tgpt.CausalLM(vocab_size=256, max_len=128, num_layers=2,
                      num_heads=2, width=32, mlp_dim=64,
                      dtype=torch.float32, attention="flash"),
        torch.Generator().manual_seed(0)).to(cuda_device)
    rows = np.random.default_rng(5).integers(0, 256, (4, 128)).astype(
        np.int32)
    cand = _perturbed(model.state_dict(), 2)
    with ServingEngine(model, (128,), input_dtype=np.int32, buckets=(1, 4),
                       max_wait_ms=50.0, device=cuda_device) as eng:
        assert telemetry.counter("serving.compiles").value == 2
        tfa.flash_attention_fwd.launches = 0
        batches0 = telemetry.counter("serving.batches").value
        live = np.stack([f.result(60) for f in eng.submit_many(rows)])
        batches = telemetry.counter("serving.batches").value - batches0
        assert tfa.flash_attention_fwd.launches == 2 * batches > 0
        plain = copy.deepcopy(model).eval()
        for m in plain.modules():
            if isinstance(m, tgpt.CausalSelfAttention):
                m.attention = "full"
        with torch.no_grad():
            want = plain(torch.from_numpy(rows).to(cuda_device)).cpu()
        np.testing.assert_allclose(live, want.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(eng.shadow_forward(eng.params, rows),
                                      live)
        shadow = eng.shadow_forward(cand, rows)
        boot = eng.params
        eng.swap_weights(cand, 1)
        np.testing.assert_array_equal(
            np.stack([f.result(60) for f in eng.submit_many(rows)]), shadow)
        eng.swap_weights(boot, 2)
        np.testing.assert_array_equal(
            np.stack([f.result(60) for f in eng.submit_many(rows)]), live)
        assert telemetry.counter("serving.compiles").value == 2
        assert eng.compiled_buckets == (1, 4)


class _CardFleet:
    """``roles`` replicas on the card behind the port's router, each a
    generation-only ServingServer on 127.0.0.1:0 over a paged,
    prefix-caching engine."""

    def __init__(self, dev, roles, **router_kw):
        from distkeras_tpu_torch.serving import FleetRouter, ServingServer

        self.router = FleetRouter(**router_kw)
        self.replicas = []
        try:
            for role in roles:
                gen = GenerationEngine(
                    _model(dev), device=dev, prefix_cache_bytes=1 << 24,
                    **MODES["paged"])
                srv = ServingServer(None, host="127.0.0.1", generator=gen,
                                    router=self.router)
                self.replicas.append({"gen": gen, "srv": srv})
                srv.start()
                self.replicas[-1]["rid"] = self.router.add_replica(
                    f"127.0.0.1:{srv.port}", role=role)
        except BaseException:
            self.close()
            raise

    def close(self):
        self.router.close()
        for rep in self.replicas:
            rep["srv"].stop()
            rep["gen"].shutdown(drain=False, timeout=30)


def _local_tokens(dev, prompts, new):
    with GenerationEngine(_model(dev), device=dev, **MODES["paged"]) as eng:
        return [t.tolist() for t in _serve(eng, prompts, new=new)]


def test_fleet_disaggregated_tokens_equal_local_on_card(cuda_device):
    """A prefill and a decode replica on cuda:0, one request at a time:
    the router's tokens equal one engine's local prefill and decode, each
    request a full prefix hit on the decode replica."""
    prompts = _prompts((9, 40, 17, 33))
    want = _local_tokens(cuda_device, prompts, 12)
    fleet = _CardFleet(cuda_device, ("prefill", "decode"))
    try:
        tfa.paged_flash_attention.launches = 0
        got = [fleet.router.generate(p, max_new_tokens=12).tokens.tolist()
               for p in prompts]
        assert tfa.paged_flash_attention.launches > 0
        d = fleet.router.status_digest()
        pc = fleet.replicas[1]["gen"].health_status()["prefix_cache"]
    finally:
        fleet.close()
    assert got == want
    assert d["handoffs"] == len(prompts) and d["handoff_failures"] == 0
    assert pc["hits"] == len(prompts)


def test_fleet_kill_requeues_and_frees_the_victim_on_card(cuda_device):
    """Two replicas on cuda:0; one is killed while its stream is held
    after the first token: that request re-queues onto the other and
    gives the local tokens; the victim's graphs and pool are freed while
    the survivor goes on replaying."""
    import threading
    import time

    prompts = _prompts((9, 40, 17, 33))
    want = _local_tokens(cuda_device, prompts, 12)
    fleet = _CardFleet(cuda_device, ("both", "both"))
    try:
        victim = fleet.replicas[0]["gen"]
        streaming, resume = threading.Event(), threading.Event()
        generate = victim.generate

        def held(prompt, stream=None, **kw):
            def on_token(tok):
                if not streaming.is_set():
                    streaming.set()
                    assert resume.wait(60)
                stream(tok)
            return generate(prompt, stream=on_token, **kw)

        victim.generate = held
        box = []
        th = threading.Thread(target=lambda: box.append(
            fleet.router.generate(prompts[0], max_new_tokens=12)))
        th.start()  # least-loaded: replica 0 takes the first request
        assert streaming.wait(60)
        fleet.replicas[0]["srv"].stop()
        killer = threading.Thread(target=victim.shutdown,
                                  kwargs=dict(drain=False, timeout=30))
        killer.start()
        deadline = time.monotonic() + 60
        while not victim._closed:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        resume.set()
        killer.join(timeout=60)
        th.join(timeout=120)
        assert not th.is_alive() and not killer.is_alive()
        got = [box[0].tokens.tolist()] + [
            fleet.router.generate(p, max_new_tokens=12).tokens.tolist()
            for p in prompts[1:]]
        d = fleet.router.status_digest()
        assert victim.released and victim.pool.pool is None
        assert all(run._graph is None for run in victim._runners())
    finally:
        fleet.close()
    assert got == want
    assert d["evictions"] == 1 and d["requeued"] == 1
    assert list(d["replicas"]) == [str(fleet.replicas[1]["rid"])]
