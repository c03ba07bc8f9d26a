"""The port's serving front end over loopback, and a JAX client against
it.

``gpt_tiny`` in float32 on the CPU: a ServingServer bound to
``127.0.0.1:0`` with a token, fronting a ServingEngine (16-token int32
rows, buckets (1, 4)) and a paged GenerationEngine with a prefix cache.
Every wait has a timeout and nothing is timed.

- ``infer`` over the wire equals ``shadow_forward`` at the same bucket,
  bitwise; ``generate``'s stream frames equal its final blob;
  ``stats``/``status``/``version``/``ping`` answer;
- a bad token gets one ``auth`` reply and the connection is dropped; an
  unknown op and bad requests get typed errors (``bad_request``,
  ``queue_full``, ``deadline``, ``closed``);
- ``weights_put`` installs directly, and through a mounted controller
  (promoted at once, or staged under a canary);
- ``kv_export`` on one port server and ``kv_handoff`` into another give
  the same tokens as the first, from a full prefix hit;
- a JAX ``ServingClient`` gets from the port's server the tokens it gets
  from JAX's server on the same weights, before and after its
  ``put_weights`` of the same flax tree.
"""

import contextlib
import socket

import numpy as np
import pytest
import torch

from distkeras_tpu import serving as jserving
from distkeras_tpu.models import gpt as jgpt
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.parallel.remote_ps import (recv_message,
                                                    send_message)
from distkeras_tpu_torch.serving import (CanaryConfig, GenerationEngine,
                                         RolloutController, ServingClient,
                                         ServingEngine, ServingServer)
from distkeras_tpu_torch.utils import bridge

T = 16
TOKEN = "loopback-secret"
ENG_KW = dict(input_dtype=np.int32, buckets=(1, 4), max_wait_ms=20.0)
GEN_KW = dict(num_slots=2, slot_ladder=(1, 2), prefill_buckets=(16, 64),
              page_size=16, prefix_cache_bytes=1 << 24)
PROMPT = [5, 17, 3, 99, 42, 7, 250, 1, 64]


def _perturbed(state, seed, scale=0.1):
    gen = torch.Generator().manual_seed(seed)
    return {k: v + scale * torch.randn(v.shape, generator=gen)
            for k, v in state.items()}


@pytest.fixture(scope="module")
def versions():
    v0 = tgpt.init_params(tgpt.gpt_tiny(),
                          torch.Generator().manual_seed(0)).state_dict()
    return v0, _perturbed(v0, 1)


def _model(state):
    model = tgpt.gpt_tiny()
    model.load_state_dict(state)
    return model


@contextlib.contextmanager
def _stack(state, rollout=None, eng_kw=None, **srv_kw):
    """Port engines on ``state`` behind a started server; yields (server,
    client, engine, generator, controller)."""
    eng = ServingEngine(_model(state), (T,), device="cpu",
                        **dict(ENG_KW, **(eng_kw or {})))
    gen = GenerationEngine(_model(state), device="cpu", **GEN_KW)
    ctl = None
    if rollout is not None:
        ctl = RolloutController(engine=eng, generator=gen, **rollout)
    srv = ServingServer(eng, host="127.0.0.1", token=TOKEN, generator=gen,
                        rollout=ctl, **srv_kw)
    srv.start()
    cli = ServingClient(f"127.0.0.1:{srv.port}", token=TOKEN, timeout=60)
    try:
        yield srv, cli, eng, gen, ctl
    finally:
        cli.close()
        srv.stop()
        eng.shutdown()
        gen.shutdown()


def _rows(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, T)).astype(
        np.int32)


def test_ops_over_loopback(versions):
    with _stack(versions[0]) as (srv, cli, eng, gen, _):
        rows = _rows(4)
        out = cli.infer(rows)
        assert out.shape == (4, T, 256) and out.dtype == np.float32
        np.testing.assert_array_equal(out,
                                      eng.shadow_forward(eng.params, rows))
        streamed = []
        res = cli.generate(PROMPT, max_new_tokens=6, on_token=streamed.append)
        assert res.reason == "length" and streamed == res.tokens.tolist()
        local = gen.generate(PROMPT, max_new_tokens=6).result(60).tokens
        assert res.tokens.tolist() == local.tolist()
        assert cli.ping()
        stats = cli.stats()
        assert stats["counters"]["serving.completed"] >= 4
        status = cli.status()
        assert status["service"] == "serving" and status["port"] == srv.port
        assert status["decode"]["live_versions"] == [0]
        assert status["compiled_buckets"] == [1, 4]
        version = cli.version()
        assert version.pop("blob_lens") == []  # the raw reply, as in JAX
        assert version == {"model_version": 0, "last_swap_time": None,
                           "decode_model_version": 0,
                           "decode_live_versions": [0]}


def test_bad_token_drops_the_connection(versions):
    with _stack(versions[0]) as (srv, cli, *_):
        bad = ServingClient(f"127.0.0.1:{srv.port}", token="wrong",
                            timeout=60, retry=None)
        try:
            with pytest.raises(RuntimeError, match="auth"):
                bad.ping()
            with pytest.raises((ConnectionError, OSError)):
                bad.ping()
        finally:
            bad.close()
        assert cli.ping()  # other connections are unaffected


def test_unknown_op_and_typed_errors(versions):
    with _stack(versions[0], eng_kw=dict(queue_capacity=2)) as (
            srv, cli, eng, *_):
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=60) as raw:
            send_message(raw, {"op": "nope", "token": TOKEN})
            reply, _ = recv_message(raw)
        assert reply["kind"] == "bad_request" and "nope" in reply["error"]
        with pytest.raises(RuntimeError, match=r"\(bad_request\)"):
            cli.infer(np.zeros((1, T + 1), np.int32))
        with pytest.raises(RuntimeError, match=r"\(bad_request\)"):
            cli.generate(list(range(1, 70)), max_new_tokens=2)
        with pytest.raises(RuntimeError, match=r"\(bad_request\)"):
            cli.put_weights(versions[0], 1, target="everything")
        with pytest.raises(RuntimeError, match=r"\(queue_full\)"):
            cli.infer(_rows(3))
        with pytest.raises(RuntimeError, match=r"\(deadline\)"):
            cli.infer(_rows(1), timeout_ms=-1.0)
        eng.shutdown()
        with pytest.raises(RuntimeError, match=r"\(closed\)"):
            cli.infer(_rows(1))


@pytest.mark.parametrize("rollout", [None, {}, {"canary": CanaryConfig(
    fraction=1.0, min_rows=4, threshold=0.0)}], ids=["direct", "controller",
                                                     "canary"])
def test_weights_put_direct_and_through_the_controller(versions, rollout):
    v0, v1 = versions
    with _stack(v0, rollout=rollout) as (srv, cli, eng, gen, ctl):
        rows = _rows(4, seed=1)
        before = cli.infer(rows)
        want = eng.shadow_forward(v1, rows)
        compiles = (telemetry.counter("serving.compiles").value,
                    telemetry.counter("serving.decode.compiles").value)
        reply = cli.put_weights(v1, 1, target="both")
        assert reply["ok"] and reply["version"] == 1
        if rollout and "canary" in rollout:
            assert reply["staged"] and eng.model_version == 0
            assert ctl.evaluate_canary(rows) is not None
        else:
            assert not reply["staged"]
        assert cli.version()["model_version"] == 1
        assert gen.model_version == 1
        after = cli.infer(rows)
        assert not np.array_equal(after, before)
        np.testing.assert_array_equal(after, want)
        assert (telemetry.counter("serving.compiles").value,
                telemetry.counter("serving.decode.compiles").value) \
            == compiles
        if ctl is not None:
            assert ctl.rollback()
            np.testing.assert_array_equal(cli.infer(rows), before)


def test_kv_export_handoff_between_two_port_servers(versions):
    with _stack(versions[0]) as (_, a, *_), \
            _stack(versions[0]) as (_, b, _, gen_b, _):
        want = a.generate(PROMPT, max_new_tokens=6).tokens.tolist()
        header, blobs = a.kv_export(PROMPT)
        assert header["found"] and header["has_logits"]
        assert not b.kv_export(PROMPT)[0]["found"]
        assert b.kv_handoff(PROMPT, header, blobs)
        got = b.generate(PROMPT, max_new_tokens=6).tokens.tolist()
        assert got == want
        status = gen_b.health_status()["prefix_cache"]
        assert status["hits"] == 1
        # a torn entry (one page short) is refused, never half-installed
        short = dict(header, leaves=[[[s[0] - 1] + s[1:], d]
                                     for s, d in header["leaves"]])
        cut = [blob[:len(blob) * (s[0] - 1) // s[0]] for blob, (s, _)
               in zip(blobs, header["leaves"])] + blobs[len(
                   header["leaves"]):]
        assert not b.kv_handoff(PROMPT[:-1] + [3], short, cut)


@pytest.fixture(scope="module")
def jax_stack(versions):
    """JAX's engines and server on the bridged v0 weights."""
    params = bridge.state_dict_to_flax(versions[0])
    eng = jserving.ServingEngine(jgpt.gpt_tiny(), params, input_shape=(T,),
                                 **ENG_KW)
    gen = jserving.GenerationEngine(jgpt.gpt_tiny(), params, **GEN_KW)
    srv = jserving.ServingServer(eng, host="127.0.0.1", token=TOKEN,
                                 generator=gen)
    srv.start()
    yield srv
    srv.stop()
    eng.shutdown()
    gen.shutdown()


def test_jax_client_against_port_server_matches_jax_server(versions,
                                                           jax_stack):
    flax_v1 = bridge.state_dict_to_flax(versions[1])
    runs = {}
    with _stack(versions[0]) as (port_srv, *_):
        for name, port in (("port", port_srv.port),
                           ("jax", jax_stack.port)):
            cli = jserving.ServingClient(f"127.0.0.1:{port}", token=TOKEN,
                                         timeout=60)
            try:
                before = cli.generate(PROMPT, max_new_tokens=8).tokens
                reply = cli.put_weights(flax_v1, 1, target="generation")
                after = cli.generate(PROMPT[1:], max_new_tokens=8).tokens
                runs[name] = (before.tolist(), after.tolist(),
                              reply["ok"], cli.version()[
                                  "decode_model_version"])
            finally:
                cli.close()
    assert runs["port"] == runs["jax"]
    assert runs["port"][2] and runs["port"][3] == 1
    # the put installed v1: a port engine built on v1 gives those tokens
    with GenerationEngine(_model(versions[1]), device="cpu",
                          **GEN_KW) as ref:
        want = ref.generate(PROMPT[1:], max_new_tokens=8).result(60).tokens
    assert runs["port"][1] == want.tolist()
