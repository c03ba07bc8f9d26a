"""The port's wire helpers against the JAX package's.

- framing: the bytes ``send_message`` puts on a socket equal JAX's for
  the same header and blobs, and each side's ``recv_message`` reads the
  other's frames;
- ``check_token``: the same verdicts;
- ``_TreeCodec``: a flax-layout tree (gpt_tiny, from port weights through
  ``state_dict_to_flax``) encodes to blobs byte-equal to JAX's, and each
  side decodes the other's;
- ``RetryPolicy``: the same delays for one seed, the same refusals;
- ``fault``: the same ``inject``/``apply`` and ``inject_chaos``/``chaos``
  sequences;
- ``get_codec``: the four names resolve as JAX's do (name, lossiness,
  raw's round trip), an unknown name raises ValueError in both;
- the health plane: the ``status`` digest and a flight-recorder bundle
  carry JAX's keys with no SLO engine and no time-series store.

Tolerance: byte and value equality throughout.
"""

import socket

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import telemetry as jtelemetry
from distkeras_tpu.comms.retry import RetryPolicy as JRetryPolicy
from distkeras_tpu.health import recorder as jrecorder
from distkeras_tpu.health.endpoints import handle_health_op as jhealth_op
from distkeras_tpu.parallel import remote_ps as jwire
from distkeras_tpu.utils import fault as jfault
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.comms import codec
from distkeras_tpu_torch.comms.retry import RetryPolicy
from distkeras_tpu_torch.health import recorder
from distkeras_tpu_torch.health.endpoints import handle_health_op
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.parallel import remote_ps as wire
from distkeras_tpu_torch.utils import bridge, fault


def _sent_bytes(send, header, blobs) -> bytes:
    a, b = socket.socketpair()
    with a, b:
        send(a, header, blobs)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while chunk := b.recv(1 << 16):
            out += chunk
    return out


@pytest.mark.parametrize("header,blobs", [
    ({"op": "ping"}, []),
    ({"op": "infer", "shape": [2, 3], "dtype": "float32", "timeout_ms": 5.0},
     [np.arange(6, dtype=np.float32).tobytes()]),
    ({"op": "kv_handoff", "leaves": [[[1, 2], "int8"]], "nested": {"a": [1]}},
     [b"\x01\x02", codec.leaf_buffer(np.arange(9, dtype=np.int32)),
      b""])],
    ids=["header-only", "infer", "blobs"])
def test_framing_bytes_equal_jax_and_each_reads_the_other(header, blobs):
    mine = _sent_bytes(wire.send_message, header, blobs)
    assert mine == _sent_bytes(jwire.send_message, header, blobs)
    for send, recv in ((wire.send_message, jwire.recv_message),
                       (jwire.send_message, wire.recv_message)):
        a, b = socket.socketpair()
        with a, b:
            send(a, header, blobs)
            got, got_blobs = recv(b)
        assert got == dict(header, blob_lens=[len(x) for x in blobs])
        assert got_blobs == [bytes(x) for x in blobs]


def test_recv_raises_when_the_peer_closes_mid_message():
    a, b = socket.socketpair()
    with a, b:
        a.sendall(b"\x10\x00\x00\x00{\"op\"")
        a.shutdown(socket.SHUT_WR)
        with pytest.raises(ConnectionError):
            wire.recv_message(b)


@pytest.mark.parametrize("expected,header", [
    (None, {}), ("s3cret", {"token": "s3cret"}), ("s3cret", {}),
    ("s3cret", {"token": "wrong"}), ("s3cret", {"token": 7})])
def test_check_token_agrees_with_jax(expected, header):
    assert wire.check_token(expected, header) == jwire.check_token(
        expected, header)


@pytest.fixture(scope="module")
def flax_tree():
    model = tgpt.init_params(tgpt.gpt_tiny(),
                             torch.Generator().manual_seed(0))
    return bridge.state_dict_to_flax(model.state_dict())


def test_tree_codec_blobs_byte_equal_to_jax(flax_tree):
    mine = wire._TreeCodec(flax_tree).encode(flax_tree, kind="pull")
    theirs = jwire._TreeCodec(flax_tree).encode(flax_tree, kind="pull")
    assert [bytes(b) for b in mine] == [bytes(b) for b in theirs]
    assert len(mine) == len(jax.tree.leaves(flax_tree))
    # each side decodes the other's blobs into the same tree
    back = wire._TreeCodec(flax_tree).decode([bytes(b) for b in theirs])
    jback = jwire._TreeCodec(flax_tree).decode([bytes(b) for b in mine])
    for x, y, z in zip(jax.tree.leaves(back), jax.tree.leaves(jback),
                       jax.tree.leaves(flax_tree)):
        np.testing.assert_array_equal(x, z)
        np.testing.assert_array_equal(y, z)
    # a shapes-only template (no data copied) makes the same codec
    template = bridge.state_dict_to_flax(
        bridge.flax_to_state_dict(flax_tree), shapes_only=True)
    assert wire._TreeCodec(template).specs == \
        wire._TreeCodec(flax_tree).specs


def test_tree_codec_refuses_a_torn_message(flax_tree):
    blobs = [bytes(b) for b in
             wire._TreeCodec(flax_tree).encode(flax_tree, kind="pull")]
    tc = wire._TreeCodec(flax_tree)
    with pytest.raises(ValueError, match="blobs"):
        tc.decode(blobs[:-1])
    with pytest.raises(ValueError, match="does not match leaf shape"):
        tc.decode(blobs[:-1] + [blobs[-1][:4]])


def test_retry_policy_delays_equal_jax():
    mine, theirs = RetryPolicy(seed=7), JRetryPolicy(seed=7)
    assert [mine.delay(a) for a in range(1, 9)] == \
        [theirs.delay(a) for a in range(1, 9)]
    for kw in (dict(max_retries=-1), dict(base_s=0.0),
               dict(base_s=1.0, max_s=0.5), dict(jitter=1.0)):
        with pytest.raises(ValueError):
            RetryPolicy(**kw)
        with pytest.raises(ValueError):
            JRetryPolicy(**kw)


def _fault_script(mod):
    mod.clear_injections()
    mod.clear_chaos()
    mod.inject("site.a", value=-1.0, after=2, count=2)
    values = [mod.apply("site.a", float(i)) for i in range(6)]
    mod.inject_chaos("site.b", "reset", after=1, count=2)
    mod.inject_chaos("site.c", "delay", delay_s=0.25, shard=0)
    acts = []
    for i in range(5):
        for site, shard in (("site.b", None), ("site.c", i % 2)):
            act = mod.chaos(site, shard=shard)
            acts.append(None if act is None else (act.action, act.delay_s))
    with pytest.raises(ValueError):
        mod.inject_chaos("site.d", "explode")
    mod.clear_injections()
    mod.clear_chaos()
    return values, acts


def test_fault_sequences_equal_jax():
    mine = _fault_script(fault)
    assert mine == _fault_script(jfault)
    assert mine[0] == [0.0, 1.0, -1.0, -1.0, 4.0, 5.0]
    assert fault.CHAOS_ACTIONS == jfault.CHAOS_ACTIONS


def test_raw_codec_and_unported_codecs():
    """Every codec name resolves as the JAX package's does (the lossy
    ones are ported now; their bytes are held to JAX's in
    tests/test_torch_codecs.py)."""
    from distkeras_tpu import comms as jcomms

    raw = codec.get_codec("raw")
    assert codec.get_codec(raw) is raw
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(
        raw.decode(bytes(raw.encode(a)), (3, 4), np.float32), a)
    assert codec.available_codecs() == jcomms.available_codecs()
    for name in ("raw", "int8", "f16", "bf16"):
        mine, theirs = codec.get_codec(name), jcomms.get_codec(name)
        assert (type(mine).__name__, mine.name, mine.lossy) == \
            (type(theirs).__name__, theirs.name, theirs.lossy)
        assert codec.get_codec(mine) is mine
    for mod in (codec, jcomms):
        with pytest.raises(ValueError, match="Unknown codec"):
            mod.get_codec("zstd")


def test_health_status_and_bundle_carry_jax_keys(tmp_path):
    for mod in (telemetry, jtelemetry):
        mod.reset()
        mod.counter("serving.submitted").inc(3)
    extra = {"service": "serving", "queue_depth": 0}
    mine = handle_health_op("status", {}, extra_status=extra)
    theirs = jhealth_op("status", {}, extra_status=extra)
    assert set(mine) == set(theirs)
    assert mine["alerts"] == theirs["alerts"] == []
    assert mine["counters"] == theirs["counters"]
    assert handle_health_op("series", {}) == jhealth_op("series", {})
    assert handle_health_op("nope", {}) == jhealth_op("nope", {})
    bundle = recorder.FlightRecorder().bundle("explicit")
    jbundle = jrecorder.FlightRecorder().bundle("explicit")
    assert set(bundle) == set(jbundle)
    assert bundle["timeseries"] == jbundle["timeseries"] == []
    rec = recorder.FlightRecorder()
    rec.dump_dir = str(tmp_path)
    rec.record("rollout", action="swap", version=1)
    path = rec.auto_dump("rollout_rollback")
    assert path is not None and path.startswith(str(tmp_path))
    assert rec.auto_dump("rollout_rollback") is None  # once per reason
