"""The port's live rollout against the JAX package's.

``gpt_tiny`` in float32 on the CPU, port weights bridged to flax with
``state_dict_to_flax`` for the JAX engines (built and driven once a
module):

- the controller refuses a stale publish; the publish chaos site drops,
  delays and tears publishes as JAX's does, and a torn publish never
  installs;
- the canary's agreement equals JAX's ``CanaryAgreementEvaluator`` on the
  same rows, and decides promotion by the threshold;
- rollback restores the incumbent's output bitwise and a second one is a
  no-op; ``on_breach`` rolls back and writes a postmortem bundle;
- an in-flight generation ends on its pinned version: under the same
  admission and swap order the port's GenerationEngine gives JAX's tokens
  (two banks; the second swap reuses the first bank); a swap that
  outlasts its timeout while a pinned version holds the idle bank is
  withdrawn, the controller puts the one-shot engine back, and a
  rollback follows;
- a postmortem's git SHA is read from the checkout's own .git only;
- the prefix cache is not keyed by version in JAX (a prefix parked on v0
  serves a request on v1); the port behaves the same, token for token,
  and a torn page restore (the ``"kv.swap_in"`` chaos site) evicts the
  entry and prefills from scratch, with JAX's tokens and cache counts.

Tolerance: token identity and bitwise outputs; the canary score equal.
"""

import functools
import threading
import time
import types

import numpy as np
import pytest
import torch

from distkeras_tpu.evaluators import CanaryAgreementEvaluator as JEvaluator
from distkeras_tpu.models import gpt as jgpt
from distkeras_tpu.serving import GenerationEngine as JaxEngine
from distkeras_tpu.utils import fault as jfault
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.evaluators import CanaryAgreementEvaluator
from distkeras_tpu_torch.health import recorder
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.serving import (CanaryConfig, GenerationEngine,
                                         RolloutController, ServingEngine,
                                         WeightPublisher)
from distkeras_tpu_torch.utils import bridge, fault

T = 16
GEN_KW = dict(num_slots=2, slot_ladder=(1, 2), prefill_buckets=(16, 64),
              page_size=16)
PROMPT = np.arange(1, 6, dtype=np.int32)
PREFIX_PROMPT = np.arange(3, 40, dtype=np.int32) % 256


@pytest.fixture(autouse=True)
def fresh_planes():
    telemetry.reset()
    recorder.install(recorder.FlightRecorder())
    fault.clear_chaos()
    yield
    fault.clear_chaos()
    recorder.install(recorder.FlightRecorder())


def _perturbed(state, seed, scale=0.1):
    gen = torch.Generator().manual_seed(seed)
    return {k: v + scale * torch.randn(v.shape, generator=gen)
            for k, v in state.items()}


@pytest.fixture(scope="module")
def versions():
    """v0 (seeded) and v1 (v0 plus seeded noise) as state_dicts."""
    v0 = tgpt.init_params(tgpt.gpt_tiny(),
                          torch.Generator().manual_seed(0)).state_dict()
    return v0, _perturbed(v0, 1)


def _model(state):
    model = tgpt.gpt_tiny()
    model.load_state_dict(state)
    return model


def _engine(state, **kw):
    kw = dict(dict(input_dtype=np.int32, buckets=(1, 4), max_wait_ms=20.0),
              **kw)
    return ServingEngine(_model(state), (T,), device="cpu", **kw)


def _rows(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, T)).astype(
        np.int32)


def _out(eng, rows):
    return np.stack([f.result(timeout=60) for f in eng.submit_many(rows)])


def test_stale_publish_refused(versions):
    v0, v1 = versions
    with _engine(v0) as eng:
        ctl = RolloutController(engine=eng)
        assert ctl.stage(1, v1)
        assert not ctl.stage(1, v0)  # same version: stale
        assert not ctl.stage(0, v0)  # older: stale
        assert ctl.current_version == 1 and eng.model_version == 1
    assert telemetry.counter("rollout.stale_publishes").value == 2


def test_publish_chaos_drop_delay_torn(versions):
    v0, v1 = versions
    with _engine(v0) as eng:
        ctl = RolloutController(engine=eng, canary=CanaryConfig(
            fraction=1.0, min_rows=4))
        pub = WeightPublisher()
        pub.subscribe(lambda v, p, c: ctl.stage(v, p))
        rows = _rows(4, seed=1)
        ref = _out(eng, rows)

        fault.inject_chaos("rollout.publish", "drop")
        assert pub.publish(v1) is None and pub.version == 0

        fault.inject_chaos("rollout.publish", "torn")
        assert pub.publish(v1) == 1  # delivered, but torn
        assert ctl.candidate_version is None and ctl.current_version == 0
        np.testing.assert_array_equal(_out(eng, rows), ref)

        fault.inject_chaos("rollout.publish", "delay", delay_s=0.05)
        t0 = time.perf_counter()
        assert pub.publish(v1) == 2
        assert time.perf_counter() - t0 >= 0.05
        assert ctl.candidate_version == 2  # staged, awaiting the canary
        assert eng.compiled_buckets == (1, 4)
    assert telemetry.counter("rollout.publish_dropped").value == 1
    assert telemetry.counter("rollout.torn_swaps_blocked",
                             engine="controller").value == 1
    # the parameter-server leg: publish(params=None) pulls the live
    # center of a port service and stamps each publish on it
    from distkeras_tpu_torch.parallel.remote_ps import (
        ParameterServerService, RemoteParameterServer)
    from distkeras_tpu_torch.parameter_servers import DeltaParameterServer

    center = {n: torch.as_tensor(x).clone() for n, x in v1.items()}
    svc = ParameterServerService(DeltaParameterServer(center), center,
                                 host="127.0.0.1")
    svc.start()
    client = RemoteParameterServer(f"127.0.0.1:{svc.port}", center,
                                   op_timeout=10.0)
    try:
        client.commit({n: torch.ones_like(x) for n, x in center.items()})
        pub = WeightPublisher(ps=client, device="cpu")
        got = []
        pub.subscribe(lambda v, p, c: got.append((v, p, c)))
        for want in (1, 2):
            assert pub.publish() == want
            assert client.model_version == svc.ps.model_version == want
        (v, params, clock), = got[:1]
        assert (v, clock) == (1, 1)
        for n, x in center.items():
            assert params[n].device.type == "cpu"
            assert torch.equal(params[n], x + 1)
    finally:
        client.close()
        svc.stop()


def test_canary_agreement_equals_jax_evaluator(versions):
    v0, v1 = versions
    cand = np.array([[0.9, 0.1], [0.2, 0.8], [0.7, 0.3], [0.4, 0.6]])
    inc = np.array([[0.8, 0.2], [0.3, 0.7], [0.1, 0.9], [0.45, 0.55]])
    cols = {"candidate": cand, "incumbent": inc}
    assert CanaryAgreementEvaluator().evaluate(cols) == \
        JEvaluator().evaluate(cols) == 0.75
    rows = _rows(8, seed=2)
    with _engine(v0) as eng:
        for threshold, promoted in ((1e9, False), (0.0, True)):
            ctl = RolloutController(engine=eng, canary=CanaryConfig(
                fraction=1.0, min_rows=8, threshold=threshold))
            assert ctl.stage(1, v1)
            cols = {"candidate": eng.shadow_forward(v1, rows),
                    "incumbent": eng.shadow_forward(eng.params, rows)}
            score = ctl.evaluate_canary(rows)
            assert score == JEvaluator().evaluate(cols)
            assert score == CanaryAgreementEvaluator().evaluate(cols)
            assert (ctl.current_version == 1) == promoted
            assert ctl.candidate_version is None
    assert telemetry.counter("rollout.rejections").value == 1


def _wait_pending(gen, th):
    """Poll until the swap that thread ``th`` started is pending in
    ``gen`` (or ``th`` ended). A held step released before that would
    end, let the scheduler decode one more token and block on the next
    permit, and the swap would wait behind it."""
    deadline = time.monotonic() + 60
    while gen._pending_swap is None and th.is_alive():
        assert time.monotonic() < deadline, "the swap never became pending"
        time.sleep(0.001)


def test_timed_out_swap_is_withdrawn_and_rollback_follows(versions):
    """A generator swap that outlasts its timeout while v0 pins the idle
    bank is withdrawn: the generator stays on v1 with nothing pending,
    the controller swaps the one-shot engine back to v1 and keeps its
    version, and a rollback then installs v0 on both engines (not
    refused as already pending). The pinned request's stream callback
    takes one permit a token after its first; nothing is timed but the
    short swap timeout, which the held scheduler cannot meet."""
    v0, v1 = versions
    v2 = _perturbed(v0, 2)
    permits = threading.Semaphore(0)
    started = threading.Event()

    def pinned_stream(tok):
        if started.is_set():
            assert permits.acquire(timeout=60)
        started.set()

    def in_thread(fn, *args):
        box = []
        th = threading.Thread(target=lambda: box.append(fn(*args)))
        th.start()
        return th, box

    rows = _rows(4, seed=4)
    with GenerationEngine(_model(v0), device="cpu", **GEN_KW) as ref:
        want = ref.generate(PROMPT, max_new_tokens=12).result(
            60).tokens.tolist()
    with _engine(v0) as one, GenerationEngine(_model(v0), device="cpu",
                                              **GEN_KW) as gen:
        out_v0 = _out(one, rows)
        ctl = RolloutController(engine=one, generator=gen)
        pinned = gen.generate(PROMPT, max_new_tokens=12, stream=pinned_stream)
        assert started.wait(60)
        th, box = in_thread(ctl.stage, 1, v1)
        _wait_pending(gen, th)
        permits.release()  # the step in flight ends; v1 applies
        th.join(timeout=60)
        assert box == [True] and sorted(gen._versions) == [0, 1]
        out_v1 = _out(one, rows)
        gen.swap_weights = functools.partial(gen.swap_weights, timeout=0.2)
        with pytest.raises(TimeoutError, match="withdrawn"):
            ctl.stage(2, v2)
        del gen.swap_weights
        assert gen._pending_swap is None and gen.model_version == 1
        assert (ctl.current_version, one.model_version) == (1, 1)
        np.testing.assert_array_equal(_out(one, rows), out_v1)
        th, box = in_thread(ctl.rollback)
        for _ in range(64):
            permits.release()
        th.join(timeout=60)
        assert box == [True]
        assert (ctl.current_version, one.model_version,
                gen.model_version) == (0, 0, 0)
        np.testing.assert_array_equal(_out(one, rows), out_v0)
        assert pinned.result(60).tokens.tolist() == want
        assert gen.generate(PROMPT, max_new_tokens=12).result(
            60).tokens.tolist() == want
    assert one.compiled_buckets == (1, 4)


def test_git_sha_reads_only_the_named_checkout(tmp_path):
    """A postmortem's SHA comes from the checkout's own .git; a checkout
    without one (an unpacked archive) gives None, whatever repository
    lies above it."""
    outer = tmp_path / "outer"
    (outer / ".git" / "refs" / "heads").mkdir(parents=True)
    (outer / ".git" / "HEAD").write_text("ref: refs/heads/main\n")
    (outer / ".git" / "refs" / "heads" / "main").write_text("abc123\n")
    (outer / "inner").mkdir()
    assert recorder._git_sha(str(outer)) == "abc123"
    assert recorder._git_sha(str(outer / "inner")) is None


def test_rollback_bit_identical_and_idempotent(versions, tmp_path):
    v0, v1 = versions
    with _engine(v0) as eng:
        ctl = RolloutController(engine=eng)
        rows = _rows(4, seed=3)
        ref = _out(eng, rows)
        assert ctl.stage(1, v1)
        assert not np.array_equal(_out(eng, rows), ref)
        assert ctl.rollback()
        assert ctl.current_version == 0 and eng.model_version == 0
        np.testing.assert_array_equal(_out(eng, rows), ref)
        assert not ctl.rollback()  # idempotent
        assert ctl.stage(2, v1)
        recorder.configure(dump_dir=str(tmp_path))
        ctl.on_breach(types.SimpleNamespace(slo="canary_agreement",
                                            message="agreement 0.2 < 0.9"))
        assert eng.model_version == 0
        np.testing.assert_array_equal(_out(eng, rows), ref)
        assert eng.compiled_buckets == (1, 4)
    assert telemetry.counter("rollout.rollbacks").value == 2
    bundles = recorder.find_bundles(str(tmp_path))
    assert len(bundles) == 1 and "rollout_rollback" in bundles[0]


def _pinned_script(eng, p_a, p_b):
    """The JAX rollout test's order: a reference request on v0, one
    request admitted on v0 and swapped under (v1), one after, a swap back
    to v0's weights (v2). Returns the tokens and live versions."""
    ref_a = eng.generate(PROMPT, max_new_tokens=12).result(60).tokens
    started = threading.Event()
    fut = eng.generate(PROMPT, max_new_tokens=12,
                       stream=lambda t: started.set())
    assert started.wait(30)
    eng.swap_weights(p_b, 1)
    pinned = fut.result(60).tokens
    tok_b = eng.generate(PROMPT, max_new_tokens=12).result(60).tokens
    deadline = time.time() + 10
    while sorted(eng._versions) != [1] and time.time() < deadline:
        time.sleep(0.01)
    live = sorted(eng._versions)
    eng.swap_weights(p_a, 2)
    tok_a2 = eng.generate(PROMPT, max_new_tokens=12).result(60).tokens
    return [t.tolist() for t in (ref_a, pinned, tok_b, tok_a2)], live


def _prefix_script(eng, p_b, chaos):
    """A prompt parked on v0, then served again on v1 (a full hit on the
    v0 entry). Then the ``"kv.swap_in"`` chaos site: another prompt
    parked, served again with one torn restore armed (``chaos``: the
    package's fault module), and once more."""
    first = eng.generate(PREFIX_PROMPT, max_new_tokens=8).result(60).tokens
    eng.swap_weights(p_b, 1)
    again = eng.generate(PREFIX_PROMPT, max_new_tokens=8).result(60).tokens
    tokens = [first.tolist(), again.tolist()]
    other = PREFIX_PROMPT[::-1].copy()
    for armed in (False, True, False):
        if armed:
            chaos.inject_chaos("kv.swap_in", "reset")
        tokens.append(eng.generate(other, max_new_tokens=8).result(
            60).tokens.tolist())
    chaos.clear_chaos()
    stats = eng.health_status()["prefix_cache"]
    return tokens, {k: stats[k] for k in ("entries", "hits", "misses",
                                           "evictions")}


@pytest.fixture(scope="module")
def jax_runs(versions):
    v0, v1 = (bridge.state_dict_to_flax(v) for v in versions)
    out = {}
    eng = JaxEngine(jgpt.gpt_tiny(), v0, **GEN_KW)
    try:
        out["pinned"] = _pinned_script(eng, v0, v1)
    finally:
        eng.shutdown()
    eng = JaxEngine(jgpt.gpt_tiny(), v0, prefix_cache_bytes=1 << 24,
                    **GEN_KW)
    try:
        out["prefix"] = _prefix_script(eng, v1, jfault)
    finally:
        eng.shutdown()
    return out


def test_inflight_generation_ends_on_pinned_version_as_jax(versions,
                                                          jax_runs):
    v0, v1 = versions
    with GenerationEngine(_model(v0), device="cpu", **GEN_KW) as eng:
        declared = eng.compiled_executables
        compiles = telemetry.counter("serving.decode.compiles").value
        tokens, live = _pinned_script(eng, v0, v1)
        assert eng.compiled_executables == declared
        assert telemetry.counter("serving.decode.compiles").value \
            == compiles
        st = eng.health_status()
    ref_a, pinned, tok_b, tok_a2 = tokens
    assert pinned == ref_a and tok_a2 == ref_a and tok_b != ref_a
    assert (tokens, live) == jax_runs["pinned"]
    assert live == [1]
    assert st["model_version"] == 2 and st["live_versions"] == [2]
    assert telemetry.counter("rollout.versions_retired").value == 2


def test_prefix_cache_across_versions_and_swap_in_chaos_match_jax(
        versions, jax_runs):
    """Reference finding (ROADMAP.md Queue C): the cache keys prefixes by
    tokens only, so the request on v1 is a full hit on the entry parked on
    v0 and its first token is v0's. A torn restore (the ``"kv.swap_in"``
    chaos site) evicts the entry and prefills from scratch: the same
    tokens, one swap-in failure, as in JAX."""
    v0, v1 = versions
    with GenerationEngine(_model(v0), device="cpu",
                          prefix_cache_bytes=1 << 24, **GEN_KW) as eng:
        tokens, stats = _prefix_script(eng, v1, fault)
    assert (tokens, stats) == jax_runs["prefix"]
    with GenerationEngine(_model(v1), device="cpu", **GEN_KW) as eng:
        cold = eng.generate(PREFIX_PROMPT, max_new_tokens=8).result(60)
    assert tokens[1][0] == tokens[0][0]  # the parked v0 logits
    assert tokens[1] != cold.tokens.tolist()
    assert tokens[2] == tokens[3] == tokens[4]
    assert telemetry.counter(
        "serving.decode.paged.swap_in_failures").value == 1


def test_third_version_waits_for_the_pinned_one(versions):
    """The two-bank divergence (ROADMAP.md Queue C): with v0 pinned by an
    in-flight request and v1 current, a swap to v2 stays pending (a
    second swap meanwhile is refused as already pending, as in JAX) and
    applies once v0's request retired; each request's tokens are those
    of its version. The pinned request's stream callback takes one
    permit a token after its first, so the test decides when the
    scheduler moves; nothing is timed."""
    v0, v1 = versions
    v2 = _perturbed(v0, 2)
    permits = threading.Semaphore(0)
    started, later_started = threading.Event(), threading.Event()

    def pinned_stream(tok):
        if started.is_set():
            assert permits.acquire(timeout=60)
        started.set()

    def reference(state, new):
        with GenerationEngine(_model(state), device="cpu", **GEN_KW) as ref:
            return ref.generate(PROMPT, max_new_tokens=new).result(
                60).tokens.tolist()

    with GenerationEngine(_model(v0), device="cpu", **GEN_KW) as eng:
        pinned = eng.generate(PROMPT, max_new_tokens=12, stream=pinned_stream)
        assert started.wait(60)
        swaps = [threading.Thread(target=eng.swap_weights, args=(v1, 1))]
        swaps[0].start()
        _wait_pending(eng, swaps[0])
        permits.release()  # the step in flight ends; v1 applies
        swaps[0].join(timeout=60)
        assert not swaps[0].is_alive() and sorted(eng._versions) == [0, 1]
        later = eng.generate(PROMPT, max_new_tokens=4,
                             stream=lambda t: later_started.set())
        permits.release()  # the next step ends; ``later`` is admitted
        assert later_started.wait(60)
        errors = []

        def swap_v2():
            try:
                eng.swap_weights(v2, 2)
            except Exception as e:  # surfaced below
                errors.append(e)

        swaps.append(threading.Thread(target=swap_v2))
        swaps[1].start()
        for _ in range(6000):
            if eng._pending_swap is not None:
                break
            time.sleep(0.01)
        assert eng._pending_swap is not None and not pinned.done()
        assert sorted(eng._versions) == [0, 1] and eng.model_version == 1
        with pytest.raises(RuntimeError, match="already pending"):
            eng.swap_weights(v1, 3)
        for _ in range(64):
            permits.release()
        swaps[1].join(timeout=60)
        assert not swaps[1].is_alive() and not errors
        assert pinned.done() and eng.model_version == 2
        tokens = [pinned.result(60).tokens.tolist(),
                  later.result(60).tokens.tolist()]
    assert tokens == [reference(v0, 12), reference(v1, 4)]
