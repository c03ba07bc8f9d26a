"""The port's serving fleet against the JAX package's.

Port replicas at ``gpt_tiny`` in float32 on the CPU: each a
``ServingServer`` bound to ``127.0.0.1:0`` over a paged, prefix-caching
``GenerationEngine`` (2 slots, buckets (8, 32), 16-token pages), behind a
``FleetRouter``: the port's, or the JAX package's (the ``jax`` legs),
since both speak one wire. Weights go across with
``bridge.state_dict_to_flax``; tokens are held exactly to JAX's
``GenerationEngine`` on the bridged weights, and each leg's
``status_digest()`` counts to the values JAX's own fleet tests assert
(``tests/test_serving_fleet.py``). Every wait has a timeout, the kill is
timed by an event, and nothing asserts wall time.

- disaggregated prefill -> decode: token-identical, the decode replica
  a full prefix hit; a torn handoff (the ``fleet.kv_handoff`` chaos site)
  degrades to cold prefill with the same tokens; the server's ``status``
  op carries the router's digest;
- a replica killed while one of its streams is in flight: zero failed,
  zero lost, the victim evicted and its graphs and pool released;
- affinity routing beats the seeded random control with JAX's hit
  counts (the JAX router over the same kind of replicas gives the same);
- a fleet whose every replica sheds refuses with ``FleetOverloaded``;
- a fleet-wide weight push lands everywhere with zero skew, and the
  tokens after it are JAX's on the pushed weights;
- under a non-draining shutdown, a port server and a JAX server send the
  same frames for a stream in flight: its tokens so far, then one typed
  ``closed`` error, never a final frame.
"""

import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distkeras_tpu import serving as jserving
from distkeras_tpu import telemetry as jtelemetry
from distkeras_tpu.models import gpt as jgpt
from distkeras_tpu.utils import fault as jfault
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.parallel.remote_ps import (recv_message,
                                                    send_message)
from distkeras_tpu_torch.serving import (FleetOverloaded, FleetRouter,
                                         GenerationEngine, ServingClient,
                                         ServingServer)
from distkeras_tpu_torch.utils import bridge, fault

T = 16
GEN_KW = dict(num_slots=2, prefill_buckets=(8, 32), page_size=16)
PREFIX_BYTES = 4 << 20
#: the router implementations each scenario runs under
ROUTERS = {"port": (FleetRouter, telemetry, fault),
           "jax": (jserving.FleetRouter, jtelemetry, jfault)}


@pytest.fixture(autouse=True)
def fresh_planes():
    for mod in (telemetry, jtelemetry):
        mod.reset()
    for mod in (fault, jfault):
        mod.clear_chaos()
    yield
    for mod in (fault, jfault):
        mod.clear_chaos()


@pytest.fixture(scope="module")
def v0():
    return tgpt.init_params(tgpt.gpt_tiny(),
                            torch.Generator().manual_seed(0)).state_dict()


def _model(state):
    model = tgpt.gpt_tiny()
    model.load_state_dict(state)
    return model


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 256, size=n,
                                                dtype=np.int64).tolist()


@pytest.fixture(scope="module")
def jax_ref(v0):
    """JAX's engine on the bridged weights: ``ref(prompt, n)`` -> its
    greedy tokens. ``ref.swap(state, version)`` installs other weights."""
    gen = jserving.GenerationEngine(jgpt.gpt_tiny(),
                                    bridge.state_dict_to_flax(v0), **GEN_KW)

    def ref(prompt, n):
        return gen.generate(prompt, max_new_tokens=n).result(
            60).tokens.tolist()

    ref.swap = lambda state, version: gen.swap_weights(
        bridge.state_dict_to_flax(state), version)
    yield ref
    gen.shutdown()


class _Fleet:
    """Port replicas (a generation-only ServingServer over a paged,
    prefix-caching GenerationEngine each) behind ``router``."""

    def __init__(self, state, roles, router):
        self.router = router
        self.replicas = []
        try:
            for role in roles:
                gen = GenerationEngine(_model(state), device="cpu",
                                       prefix_cache_bytes=PREFIX_BYTES,
                                       **GEN_KW)
                srv = ServingServer(None, host="127.0.0.1", generator=gen,
                                    router=router)
                rep = {"gen": gen, "srv": srv}
                self.replicas.append(rep)
                srv.start()
                rep["rid"] = router.add_replica(f"127.0.0.1:{srv.port}",
                                                role=role)
        except BaseException:
            self.close()
            raise

    def close(self):
        self.router.close()
        for rep in self.replicas:
            rep["srv"].stop()
            rep["gen"].shutdown(drain=False, timeout=10.0)


def _digest(d):
    """A router digest without what depends on time or ports."""
    out = {k: v for k, v in d.items() if k not in ("replicas", "membership")}
    out["replicas"] = {rid: (r["role"], r["model_version"], r["inflight"])
                       for rid, r in d["replicas"].items()}
    out["evicted"] = d["membership"]["evicted"]
    return out


@pytest.mark.parametrize("impl", ROUTERS)
def test_disaggregated_handoff_clean_then_torn(v0, jax_ref, impl):
    router_cls, tel, chaos = ROUTERS[impl]
    fleet = _Fleet(v0, ("prefill", "decode"), router_cls())
    try:
        # clean: prefill on replica 0, pages shipped, decode on 1
        prompt = _prompt(12, seed=7)
        res = fleet.router.generate(prompt, max_new_tokens=8)
        assert res.tokens.tolist() == jax_ref(prompt, 8)
        d = fleet.router.status_digest()
        assert d["handoffs"] == 1 and d["handoff_failures"] == 0
        pc = fleet.replicas[1]["gen"].health_status()["prefix_cache"]
        assert pc["hits"] == 1  # a full hit: no prefill forward on 1
        assert telemetry.counter("serving.decode.prefix.imports").value == 1
        assert telemetry.counter("serving.decode.prefix.exports").value == 1
        # torn: the shipment is lost; cold prefill, the same tokens
        chaos.inject_chaos("fleet.kv_handoff", "torn")
        prompt2 = _prompt(10, seed=8)
        res2 = fleet.router.generate(prompt2, max_new_tokens=8)
        assert res2.tokens.tolist() == jax_ref(prompt2, 8)
        d = fleet.router.status_digest()
        assert d["handoffs"] == 1 and d["handoff_failures"] == 1
        assert telemetry.counter("serving.decode.prefix.imports").value == 1
        assert tel.counter("fleet.handoffs").value == 1
        assert tel.counter("fleet.handoff_failures").value == 1
        assert _digest(d) == {
            "roles": {"prefill": 1, "decode": 1, "both": 0},
            "routing": "affinity", "version_skew": 0, "sheds": 0,
            "requeued": 0, "evictions": 0, "handoffs": 1,
            "handoff_failures": 1, "requests": 2,
            "affinity": {"entries": 2, "capacity": 4096, "hits": 0,
                         "misses": 2, "hit_rate": 0.0},
            "replicas": {"0": ("prefill", 0, 0), "1": ("decode", 0, 0)},
            "evicted": []}
        # the server's status op carries the router's digest
        cli = ServingClient(f"127.0.0.1:{fleet.replicas[1]['srv'].port}",
                            timeout=60)
        try:
            st = cli.status()
        finally:
            cli.close()
        assert st["fleet"]["handoffs"] == 1
        assert set(st["fleet"]["replicas"]) == {"0", "1"}
    finally:
        fleet.close()


def test_replica_kill_in_flight_zero_failed_zero_lost(v0, jax_ref):
    """The victim (the replica holding the most cache entries after a
    warm pass) is killed while one of its streams is held after its
    first token: that request and every later one re-queue and complete
    with JAX's tokens; the victim is evicted and its engine freed its
    graphs and pool."""
    fleet = _Fleet(v0, ("both", "both", "both"), FleetRouter())
    prompts = [_prompt(8, seed=s) for s in range(6)]
    want = {tuple(p): jax_ref(p, 6) for p in prompts}
    try:
        for p in prompts:
            assert fleet.router.generate(
                p, max_new_tokens=6).tokens.tolist() == want[tuple(p)]
        victim = max(range(3), key=lambda i: (fleet.replicas[i]["gen"]
                     .health_status()["prefix_cache"]["entries"], -i))
        gen = fleet.replicas[victim]["gen"]
        assert gen.health_status()["prefix_cache"]["entries"] > 0
        streaming, resume = threading.Event(), threading.Event()
        generate = gen.generate

        def held(prompt, stream=None, **kw):
            def on_token(tok):
                if not streaming.is_set():
                    streaming.set()  # the first token on the victim
                    assert resume.wait(60)
                stream(tok)
            return generate(prompt, stream=on_token, **kw)

        gen.generate = held
        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = [pool.submit(fleet.router.generate, p, max_new_tokens=6)
                    for p in prompts for _ in range(2)]
            assert streaming.wait(60), "no stream reached the victim"
            fleet.replicas[victim]["srv"].stop()
            killer = threading.Thread(target=gen.shutdown,
                                      kwargs=dict(drain=False, timeout=30))
            killer.start()
            deadline = time.monotonic() + 60
            while not gen._closed:
                assert time.monotonic() < deadline
                time.sleep(0.001)
            resume.set()  # the held step ends into a closed engine
            killer.join(timeout=60)
            assert not killer.is_alive()
            results = [f.result(timeout=120) for f in futs]
        sent = [p for p in prompts for _ in range(2)]
        assert [r.tokens.tolist() for r in results] == \
            [want[tuple(p)] for p in sent]
        # a pass after the kill: prompts affine to the victim re-queue
        for p in prompts:
            assert fleet.router.generate(
                p, max_new_tokens=6).tokens.tolist() == want[tuple(p)]
        d = fleet.router.status_digest()
        assert d["evictions"] == 1 and d["requeued"] >= 1
        assert str(fleet.replicas[victim]["rid"]) not in d["replicas"]
        assert d["requests"] == 24 and d["sheds"] == 0
        assert gen.released and gen.pool.pool is None
        assert all(run._graph is None and not run._static
                   for run in gen._runners())
        assert all(bank.model is None for bank in gen._banks)
    finally:
        fleet.close()


def _hit_rate(fleet):
    hits = misses = 0
    for rep in fleet.replicas:
        pc = rep["gen"].health_status()["prefix_cache"]
        hits, misses = hits + pc["hits"], misses + pc["misses"]
    return hits, misses


@pytest.mark.parametrize("routing", ("affinity", "random"))
def test_affinity_beats_random_control(v0, routing):
    """JAX's legs (seed 0, two rounds of 6 prompts, 4 new tokens):
    affinity turns round two into 6 hits of 12 (rate 0.5) with 6 map
    entries; the random control scatters them. The JAX router over the
    same kind of replicas gives each leg's hit counts."""
    prompts = [_prompt(8, seed=20 + s) for s in range(6)]
    runs = {}
    for impl, (router_cls, _, _) in ROUTERS.items():
        fleet = _Fleet(v0, ("both", "both"),
                       router_cls(routing=routing, seed=0))
        try:
            for _round in range(2):
                for p in prompts:
                    fleet.router.generate(p, max_new_tokens=4)
            runs[impl] = (_hit_rate(fleet),
                          _digest(fleet.router.status_digest()))
        finally:
            fleet.close()
    assert runs["port"] == runs["jax"]
    (hits, misses), d = runs["port"]
    if routing == "affinity":
        assert (hits, misses) == (6, 6)
        assert d["affinity"]["hits"] == 6 and d["affinity"]["entries"] == 6
    else:
        assert d["affinity"]["hits"] == 0
        assert hits / (hits + misses) < 0.5


def test_whole_fleet_shedding_is_a_typed_refusal(v0):
    # threshold -1 with a zero-width budget: any depth burns the budget
    # on the first evaluation, so every replica sheds
    fleet = _Fleet(v0, ("both",), FleetRouter(
        shed_queue_depth=-1.0, shed_window_s=0.0, shed_budget_frac=0.0))
    try:
        with pytest.raises(FleetOverloaded, match="shedding"):
            fleet.router.generate(_prompt(8), max_new_tokens=4)
        assert fleet.router.status_digest()["sheds"] == 1
        assert telemetry.counter("fleet.sheds").value == 1
    finally:
        fleet.close()


def test_fleet_weight_push_every_replica_zero_skew(v0, jax_ref):
    bumped = {k: v + 0.5 for k, v in v0.items()}
    fleet = _Fleet(v0, ("both", "both"), FleetRouter())
    prompt = _prompt(9, seed=30)
    try:
        out = fleet.router.push_weights(bumped, version=7,
                                        target="generation")
        assert sorted(out) == [0, 1] and all(r["ok"] for r in out.values())
        d = fleet.router.status_digest()
        assert d["version_skew"] == 0 and d["evictions"] == 0
        assert all(r["model_version"] == 7 for r in d["replicas"].values())
        got = fleet.router.generate(prompt, max_new_tokens=6)
    finally:
        fleet.close()
    jax_ref.swap(bumped, 7)
    try:
        assert got.tokens.tolist() == jax_ref(prompt, 6)
    finally:
        jax_ref.swap(v0, 8)


def _killed_stream_frames(gen, port):
    """Raw frames a generate gets from the server on ``port`` when its
    engine ``gen`` shuts down without draining while the scheduler is
    held after the first token (whose frame is read before the kill)."""
    first, resume = threading.Event(), threading.Event()
    generate = gen.generate

    def held(prompt, stream=None, **kw):
        def on_token(tok):
            stream(tok)
            if not first.is_set():
                first.set()
                assert resume.wait(60)
        return generate(prompt, stream=on_token, **kw)

    gen.generate = held
    prompt = np.asarray(_prompt(9, seed=40), np.int32)
    frames = []
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        send_message(s, {"op": "generate", "length": int(prompt.size),
                         "max_new_tokens": 6}, [prompt.tobytes()])
        header, blobs = recv_message(s)
        frames.append((header, [bytes(b) for b in blobs]))
        assert first.wait(60)
        killer = threading.Thread(target=gen.shutdown,
                                  kwargs=dict(drain=False, timeout=30))
        killer.start()
        deadline = time.monotonic() + 60
        while not gen._closed:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        resume.set()
        while True:
            header, blobs = recv_message(s)
            frames.append((header, [bytes(b) for b in blobs]))
            if not header.get("stream"):
                break
        killer.join(timeout=60)
    return frames


def test_killed_stream_frames_match_jax_server(v0):
    """What the router's re-queue rests on: a replica shut down without
    draining ends each stream in flight with the typed ``closed`` error
    (the kind JAX's server sends) and no final frame."""
    runs = {}
    port_gen = GenerationEngine(_model(v0), device="cpu", **GEN_KW)
    jax_gen = jserving.GenerationEngine(
        jgpt.gpt_tiny(), bridge.state_dict_to_flax(v0), **GEN_KW)
    servers = {"port": ServingServer(None, host="127.0.0.1",
                                     generator=port_gen),
               "jax": jserving.ServingServer(None, host="127.0.0.1",
                                             generator=jax_gen)}
    gens = {"port": port_gen, "jax": jax_gen}
    try:
        for name, srv in servers.items():
            srv.start()
            runs[name] = _killed_stream_frames(gens[name], srv.port)
    finally:
        for name, srv in servers.items():
            srv.stop()
            gens[name].shutdown(drain=False, timeout=10)
    assert runs["port"] == runs["jax"]
    *streamed, (last, blobs) = runs["port"]
    assert streamed and all(h["stream"] for h, _ in streamed)
    assert last["kind"] == "closed" and "done" not in last and not blobs


def test_generation_only_replica(v0, jax_ref):
    """A replica needs no one-shot engine: ``ServingServer(None, ...)``
    serves ``generate``, ``status``, ``version`` and generation weight
    pushes, and refuses ``infer`` and a push aimed at the one-shot
    engine as ``bad_request``."""
    gen = GenerationEngine(_model(v0), device="cpu", **GEN_KW)
    srv = ServingServer(None, host="127.0.0.1", generator=gen)
    srv.start()
    cli = ServingClient(f"127.0.0.1:{srv.port}", timeout=60)
    try:
        prompt = _prompt(9, seed=50)
        got = cli.generate(prompt, max_new_tokens=6).tokens.tolist()
        assert got == jax_ref(prompt, 6)
        with pytest.raises(RuntimeError, match=r"\(bad_request\).*one-shot"):
            cli.infer(np.zeros((1, T), np.int32))
        with pytest.raises(RuntimeError, match=r"\(bad_request\).*one-shot"):
            cli.put_weights(v0, 1, target="both")
        assert cli.put_weights(v0, 1, target="generation")["ok"]
        version = cli.version()
        assert sorted(version) == ["blob_lens", "decode_live_versions",
                                   "decode_model_version"]
        assert version["decode_model_version"] == 1
        status = cli.status()
        assert status["decode"]["model_version"] == 1
        assert "compiled_buckets" not in status
    finally:
        cli.close()
        srv.stop(shutdown_engine=True)
        gen.shutdown()
