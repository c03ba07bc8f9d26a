"""The port's one-shot ServingEngine against the JAX package's.

``gpt_tiny`` in float32 on the same weights (port weights bridged to
flax with ``state_dict_to_flax``), 16-token rows of int32 ids, buckets
(1, 4), on the CPU:

- ``infer``: every row's logits equal JAX's engine within 1e-5 (also
  with ``attention="flash"`` on 128-token rows, the kernel's plain
  version here);
- errors are typed as JAX types them (``QueueFull``, ``EngineClosed``,
  ``DeadlineExceeded``, ``ValueError``);
- a swap changes the outputs and adds no compile, and swapping back is
  bitwise; every batch stays on one version under swap churn and
  concurrent shadow forwards of a candidate (the one bank loaded and
  restored);
  ``shadow_forward`` equals live output bitwise at the same bucket; a
  torn tree is refused with the incumbent serving bitwise;
- a ``mesh=`` bucket its worker count does not divide raises JAX's
  ValueError.

The JAX engine is built once for the module.
"""

import threading

import numpy as np
import pytest
import torch

from distkeras_tpu.models import gpt as jgpt
from distkeras_tpu.serving import ServingEngine as JaxEngine
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.serving import (DeadlineExceeded, EngineClosed,
                                         QueueFull, ServingEngine)
from distkeras_tpu_torch.serving.rollout import _torn_copy
from distkeras_tpu_torch.utils import bridge

T = 16
KW = dict(input_dtype=np.int32, buckets=(1, 4), max_wait_ms=20.0)


@pytest.fixture(scope="module")
def weights():
    model = tgpt.init_params(tgpt.gpt_tiny(),
                             torch.Generator().manual_seed(0))
    return model.state_dict(), bridge.state_dict_to_flax(model.state_dict())


def _model(state, **kw):
    model = tgpt.gpt_tiny(**kw)
    model.load_state_dict(state)
    return model


def _engine(state, t=T, **kw):
    return ServingEngine(_model(state), (t,), device="cpu",
                         **dict(KW, **kw))


def _rows(n, t=T, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, t)).astype(
        np.int32)


def _perturbed(state, seed=1, scale=0.05):
    gen = torch.Generator().manual_seed(seed)
    return {k: v + scale * torch.randn(v.shape, generator=gen)
            for k, v in state.items()}


def _out(eng, rows):
    return np.stack([f.result(timeout=60) for f in eng.submit_many(rows)])


@pytest.fixture(scope="module")
def jax_out(weights):
    """JAX's engine on the bridged weights: 7 rows (a batch of 4 and one
    of 3, padded) at T and 2 rows at 128 tokens."""
    outs = {}
    for t in (T, 128):
        eng = JaxEngine(jgpt.gpt_tiny(), weights[1], input_shape=(t,),
                        **KW)
        try:
            outs[t] = np.stack([f.result(60) for f in
                                eng.submit_many(_rows(7 if t == T else 2,
                                                      t))])
        finally:
            eng.shutdown()
    return outs


@pytest.mark.parametrize("attention,t", [("full", T), ("flash", 128)],
                         ids=["full", "flash-128"])
def test_infer_equals_jax_engine(weights, jax_out, attention, t):
    model = _model(weights[0], attention=attention)
    with ServingEngine(model, (t,), device="cpu", **KW) as eng:
        assert eng.compiled_buckets == (1, 4)
        got = _out(eng, _rows(len(jax_out[t]), t))
    assert got.shape == jax_out[t].shape
    np.testing.assert_allclose(got, jax_out[t], rtol=0, atol=1e-5)


def test_errors_typed_as_jax(weights):
    eng = _engine(weights[0], queue_capacity=4)
    try:
        with pytest.raises(ValueError, match="shape"):
            eng.submit(np.zeros(T + 1, np.int32))
        with pytest.raises(QueueFull):
            eng.submit_many(_rows(5))
        fut = eng.submit(_rows(1)[0], timeout_ms=-1.0)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=60)
        assert _out(eng, _rows(2)).shape == (2, T, 256)
    finally:
        eng.shutdown()
    with pytest.raises(EngineClosed):
        eng.submit(_rows(1)[0])
    with pytest.raises(ValueError, match="max_batch_size"):
        _engine(weights[0], max_batch_size=8)
    with pytest.raises(ValueError, match="max_wait_ms"):
        _engine(weights[0], max_wait_ms=-1.0)
    # a bucket the mesh's worker count does not divide (JAX's error)
    from distkeras_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="not divisible by the mesh's 2"):
        _engine(weights[0], mesh=Mesh(["cpu", "cpu"]))


def test_swap_changes_outputs_and_adds_no_compile(weights):
    telemetry.reset()
    eng = _engine(weights[0])
    try:
        assert telemetry.counter("serving.compiles").value == 2
        rows = _rows(4, seed=3)
        out0 = _out(eng, rows)
        eng.swap_weights(_perturbed(weights[0]), 1)
        out1 = _out(eng, rows)
        assert not np.array_equal(out0, out1)
        assert eng.model_version == 1 and eng.last_swap_time is not None
        eng.swap_weights(weights[0], 2)
        np.testing.assert_array_equal(_out(eng, rows), out0)
        assert eng.compiled_buckets == (1, 4)
        assert telemetry.counter("serving.compiles").value == 2
        assert telemetry.counter("rollout.swaps", engine="serving").value == 2
        st = eng.health_status()
        assert st["model_version"] == 2 and st["compiled_buckets"] == [1, 4]
    finally:
        eng.shutdown()


def test_batches_stay_on_one_version_under_swap_churn(weights):
    """Swaps between two versions and shadow forwards of a third (cast
    into the one bank and back) run beside live batches: each batch
    equals one of the two installed versions' outputs, never a blend and
    never the shadowed candidate."""
    p_a, p_b = weights[0], _perturbed(weights[0])
    p_c = _perturbed(weights[0], seed=13)
    eng = _engine(weights[0])
    try:
        rows = _rows(4, seed=5)
        ref_a = _out(eng, rows)
        eng.swap_weights(p_b, 1)
        ref_b = _out(eng, rows)
        eng.swap_weights(p_a, 2)
        stop = threading.Event()

        def churn():
            flip, v = True, 3
            while not stop.is_set():
                eng.swap_weights(p_b if flip else p_a, v)
                flip, v = not flip, v + 1
                stop.wait(0.002)

        def shadow():
            while not stop.is_set():
                eng.shadow_forward(p_c, rows[:1])

        threads = [threading.Thread(target=fn, daemon=True)
                   for fn in (churn, shadow)]
        for t in threads:
            t.start()
        try:
            for _ in range(20):
                out = _out(eng, rows)
                assert np.array_equal(out, ref_a) or \
                    np.array_equal(out, ref_b), "a batch blended versions"
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert eng.compiled_buckets == (1, 4)
    finally:
        eng.shutdown()


def test_shadow_forward_equals_live_bitwise(weights):
    cand = _perturbed(weights[0], seed=7)
    eng = _engine(weights[0])
    try:
        rows = _rows(4, seed=9)
        live = _out(eng, rows)
        np.testing.assert_array_equal(eng.shadow_forward(eng.params, rows),
                                      live)
        shadow = eng.shadow_forward(cand, rows)
        assert eng.model_version == 0
        np.testing.assert_array_equal(_out(eng, rows), live)
        eng.swap_weights(cand, 1)
        np.testing.assert_array_equal(_out(eng, rows), shadow)
    finally:
        eng.shutdown()


def test_torn_tree_refused_and_incumbent_serves_bitwise(weights):
    telemetry.reset()
    eng = _engine(weights[0])
    try:
        rows = _rows(4, seed=11)
        ref = _out(eng, rows)
        with pytest.raises(ValueError, match="rejected"):
            eng.swap_weights(_torn_copy(_perturbed(weights[0])), 1)
        with pytest.raises(ValueError, match="structure"):
            eng.swap_weights({"not": torch.zeros(3)}, 1)
        cast = {k: v.double() for k, v in weights[0].items()}
        with pytest.raises(ValueError, match="dtype"):
            eng.swap_weights(cast, 1)
        assert eng.model_version == 0
        np.testing.assert_array_equal(_out(eng, rows), ref)
        assert telemetry.counter("rollout.torn_swaps_blocked",
                                 engine="serving").value == 3
    finally:
        eng.shutdown()
