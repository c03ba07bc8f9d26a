"""The port's wire codecs against the JAX package's.

- every codec's blob equals JAX's byte for byte, and its decode equals
  JAX's decode bitwise, for float32 leaves with NaN, infinities,
  subnormals, the largest finite value and round-to-even ties, for a
  constant leaf (the int8 scale 0), float16/float64 leaves and integer
  leaves (which pass through raw), in both directions (commit, pull);
- bf16 round to nearest even, NaN signed and quiet, as ``ml_dtypes``
  casts, without ``ml_dtypes``;
- ``negotiate``, ``available_codecs``, the int8 blob length check;
- ``ErrorFeedback``: one scripted sequence of deltas gives the same
  blobs and the same residuals as JAX's (bitwise), and the invariant
  (decoded sum within one step's quantization error of the true sum);
- ``EncodedParameterServer`` over a port DynSGD server against JAX's
  over a JAX one: the same scripted commit sequence gives the same
  clocks and centers (rtol 1e-6: the fold runs in each framework).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distkeras_tpu import comms as jcomms
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu_torch import comms
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch.comms import codec as tcodec

NAMES = ("raw", "f16", "bf16", "int8")


def _specials() -> np.ndarray:
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(64) * 100).astype(np.float32)
    bits = np.array([0x7F800001, 0xFFC00001, 0x7FBFFFFF, 0x3F808000,
                     0x3F818000, 0x00000001, 0x807FFFFF, 0x7F7FFFFF],
                    np.uint32)
    a[:8] = bits.view(np.float32)
    a[8:14] = [np.inf, -np.inf, -0.0, 0.0, 65504.0, 1e-8]
    return a.reshape(8, 8)


def _leaves() -> dict:
    rng = np.random.default_rng(1)
    return {
        "f32": (rng.standard_normal((5, 7)) * 3).astype(np.float32),
        "f32_const": np.full((4,), 2.5, np.float32),
        "f32_empty": np.zeros((0, 3), np.float32),
        "f16": rng.standard_normal(9).astype(np.float16),
        "f64": rng.standard_normal(9),
        "i32": np.arange(-6, 6, dtype=np.int32).reshape(3, 4),
        "bool": np.array([True, False, True]),
    }


def _cases():
    for name in NAMES:
        for kind in ("commit", "pull"):
            for leaf in _leaves():
                yield name, kind, leaf
            # the int8 commit grid needs finite values; its pulls are f16
            if not (name == "int8" and kind == "commit"):
                yield name, kind, "specials"


@pytest.mark.parametrize("name,kind,leaf", list(_cases()))
def test_blob_bytes_and_decode_equal_jax(name, kind, leaf):
    arr = _specials() if leaf == "specials" else _leaves()[leaf]
    mine, theirs = comms.get_codec(name), jcomms.get_codec(name)
    with np.errstate(all="ignore"):
        blob = bytes(mine.encode(arr, kind))
        assert blob == bytes(theirs.encode(arr, kind))
        got = mine.decode(blob, arr.shape, arr.dtype, kind)
        want = theirs.decode(blob, arr.shape, arr.dtype, kind)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_bf16_bits_are_ml_dtypes_rounding():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    a = np.concatenate([bits.view(np.float32), _specials().ravel()])
    with np.errstate(all="ignore"):
        want = np.asarray(a, ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(tcodec.f32_to_bf16_bits(a), want)
    back = tcodec.bf16_bits_to_f32(want)
    np.testing.assert_array_equal(
        back.view(np.uint32),
        np.asarray(want.view(ml_dtypes.bfloat16), np.float32).view(
            np.uint32))


def test_registry_negotiation_and_length_check_like_jax():
    assert comms.available_codecs() == jcomms.available_codecs()
    for req, sup in (("int8", ["int8", "f16"]), ("int8", ["f16"]),
                     ("bf16", []), ("raw", ["int8"]), ("zstd", ["zstd"])):
        assert comms.negotiate(req, sup) == jcomms.negotiate(req, sup)
    q = comms.get_codec("int8")
    for mod in (comms, jcomms):
        with pytest.raises(ValueError, match="does not match"):
            mod.get_codec("int8").decode(b"\x00" * 9, (4,), np.float32)
    assert q.lossy and comms.get_codec("f16").lossy
    assert not comms.get_codec("raw").lossy


def _delta_script(steps=6):
    rng = np.random.default_rng(3)
    specs = [((6, 5), np.dtype(np.float32)), ((7,), np.dtype(np.float32)),
             ((3,), np.dtype(np.int32))]
    script = []
    for _ in range(steps):
        script.append([
            (rng.standard_normal((6, 5)) * 0.1).astype(np.float32),
            rng.standard_normal(7).astype(np.float32),
            rng.integers(-3, 3, 3).astype(np.int32)])
    return specs, script


@pytest.mark.parametrize("name", ["int8", "bf16", "f16"])
def test_error_feedback_equals_jax_and_keeps_the_invariant(name):
    """Bitwise: the same blobs and residuals as JAX's ErrorFeedback on one
    scripted sequence. Invariant: sum of decoded float deltas within one
    step's quantization error (the last residual) of the true sum."""
    specs, script = _delta_script()
    mine = comms.ErrorFeedback(comms.get_codec(name))
    theirs = jcomms.ErrorFeedback(jcomms.get_codec(name))
    codec = comms.get_codec(name)
    decoded_sum = [np.zeros(s, np.float32) for s, _ in specs[:2]]
    for step in script:
        blobs = mine.encode_leaves(step, specs)
        jblobs = theirs.encode_leaves(step, specs)
        assert [bytes(b) for b in blobs] == [bytes(b) for b in jblobs]
        for i, (s, d) in enumerate(specs[:2]):
            decoded_sum[i] += codec.decode(bytes(blobs[i]), s, d)
        for r, jr in zip(mine._residual, theirs._residual):
            if r is None:
                assert jr is None
            else:
                assert r.tobytes() == jr.tobytes()
    for i in range(2):
        true = sum(step[i] for step in script)
        np.testing.assert_allclose(decoded_sum[i] + mine._residual[i], true,
                                   rtol=0, atol=1e-5)
    mine.reset()
    assert mine._residual is None


@pytest.mark.parametrize("name", ["int8", "bf16"])
def test_encoded_parameter_server_equals_jax(name):
    """DynSGD servers behind each package's EncodedParameterServer, one
    scripted commit sequence with mixed staleness: the same fold clocks,
    and centers within rtol 1e-6 / atol 1e-7 after every commit (the
    decoded deltas are bitwise equal; the fold runs in each framework).
    Pulls round the center as the wire would (bf16 or f16) and equal
    JAX's pulls bitwise."""
    rng = np.random.default_rng(4)
    start = {"w": rng.standard_normal((6, 5)).astype(np.float32),
             "b": rng.standard_normal(5).astype(np.float32)}
    mine = comms.EncodedParameterServer(
        tps.DynSGDParameterServer(
            {k: torch.from_numpy(v.copy()) for k, v in start.items()}),
        name)
    theirs = jcomms.EncodedParameterServer(
        jps.DynSGDParameterServer(jax.tree.map(jnp.asarray, start)), name)
    for last_update in (0, 0, 1, 3, 2, 5):
        delta = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                 for k, v in start.items()}
        tdelta = {k: torch.from_numpy(v) for k, v in delta.items()}
        assert mine.commit(tdelta, last_update=last_update) == \
            theirs.commit(delta, last_update=last_update)
        c, clock = mine.ps.pull()
        jc, jclock = theirs.ps.pull()
        assert clock == jclock
        for k in start:
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6, atol=1e-7)
    pulled, clock = mine.pull()
    jpulled, jclock = theirs.pull()
    assert clock == jclock == 6
    for k in start:
        want = np.asarray(jpulled[k])
        assert pulled[k].dtype == want.dtype
        np.testing.assert_allclose(pulled[k], want, rtol=2 ** -7)
    # a raw wrapper is the server itself
    raw = comms.EncodedParameterServer(tps.DeltaParameterServer(
        {"w": torch.zeros(3)}), "raw")
    raw.commit({"w": torch.ones(3)})
    assert torch.equal(raw.pull()[0]["w"], torch.ones(3))
    assert raw.num_updates == 1
