"""The port's GenerationEngine on a card: one CUDA graph per declared
shape, replayed under traffic.

Skipped without a CUDA device (on the CPU the engine's runners call the
step eagerly; tests/test_torch_generation_options.py holds that path to
the JAX engine). This file imports no JAX, so it runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py

``gpt_tiny`` in float32 with TF32 off, seeded weights. Tolerance: the
engines' greedy tokens equal the argmax of the model's full forward
(plain attention, no kernel) re-run over each growing prefix; a paged
call replayed from a graph equals the eager call bitwise.
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.ops.kernels import flash_attention as tfa
from distkeras_tpu_torch.serving import GenerationEngine

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
