"""Sequence parallelism: the port's ring CausalLM and
``build_sp_train_step`` against the JAX package's.

JAX runs ``build_sp_train_step`` on conftest's 8 CPU devices (workers 2
x seq 4); the port on a mesh that repeats ``cpu`` 8 times. Weights come
from JAX's ``init_sp_state``, bridged. Bounds, float32, where only
summation order differs: the loss at rtol 1e-5, the parameters after one
SGD step at rtol 5e-5 / atol 5e-6 (``test_sequence_parallel.py``'s).
The JAX step is jitted once a module.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distkeras_tpu.parallel import sequence as jseq
from distkeras_tpu_torch import engine
from distkeras_tpu_torch.models import gpt
from distkeras_tpu_torch.ops import optimizers
from distkeras_tpu_torch.parallel import sequence
from distkeras_tpu_torch.utils import bridge


def _batch(b=4, t=64, vocab=256, seed=0):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)
    return {"input_ids": ids, "labels": jseq.shift_labels(ids)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Run this module's torch ops on one intra-op thread, restoring the
    count after: the CPU ring's many small per-shard ops are erratic
    under a thread pool, and several test processes at once each with a
    pool oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_sp_step():
    """JAX's step at workers 2 x seq 4, sgd(0.1): the start and end
    params (numpy) and the step's metrics."""
    mesh = jseq.make_sp_mesh(num_workers=2, seq_parallelism=4)
    model = jgpt_tiny(attention="ring")
    tx = optax.sgd(0.1)
    state = jseq.init_sp_state(model, tx, mesh, (4, 16))
    params0 = _np(jax.device_get(state.params))
    step_fn, _, place_batch = jseq.build_sp_train_step(model, tx, mesh)
    state, ms = step_fn(state, place_batch(_batch()))
    return params0, _np(jax.device_get(state.params)), {
        k: float(v) for k, v in ms.items()}


def _ring_state(params, mesh, lr=0.1, **kw):
    model = gpt.gpt_tiny(attention="ring", **kw)
    state = sequence.init_sp_state(model, optimizers.get("sgd", lr), mesh)
    model.load_state_dict(bridge.flax_to_state_dict(params))
    return state


def test_sp_step_matches_jax(jax_sp_step):
    params0, params1, jms = jax_sp_step
    mesh = sequence.make_sp_mesh(2, 4, devices=["cpu"] * 8)
    assert mesh.shape == {"workers": 2, "seq": 4}
    state = _ring_state(params0, mesh)
    step_fn, place_state, place_batch = sequence.build_sp_train_step(
        state.model, optimizers.get("sgd", 0.1), mesh)
    batch = place_batch(_batch())
    assert len(batch["input_ids"]) == 2 and len(batch["input_ids"][0]) == 4
    assert batch["input_ids"][1][3].shape == (2, 16)
    state, ms = step_fn(place_state(state), batch)
    assert state.step == 1
    np.testing.assert_allclose(float(ms["loss"]), jms["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(ms["accuracy"]), jms["accuracy"],
                               rtol=1e-5)
    want = bridge.flax_to_state_dict(params1)
    for name, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=5e-5,
                                   atol=5e-6, err_msg=name)


def test_ring_forward_equals_full_forward_and_single_device_step():
    """The ring's logits are the full forward's (float32; the fold's
    order only), and one sp step is ``engine.make_train_step``'s
    masked_lm step on the global batch."""
    torch.manual_seed(0)
    ring = gpt.init_params(gpt.gpt_tiny(attention="ring"),
                           torch.Generator().manual_seed(3))
    full = gpt.gpt_tiny(attention="full")
    full.load_state_dict(ring.state_dict())
    batch = _batch(b=2, t=64, seed=4)
    ids = torch.from_numpy(batch["input_ids"])
    with torch.no_grad():
        got = torch.cat(ring(list(ids.chunk(4, dim=1))), dim=1)
        np.testing.assert_allclose(got.numpy(), full(ids).numpy(),
                                   rtol=1e-5, atol=1e-5)
    mesh = sequence.make_sp_mesh(1, 4, devices=["cpu"] * 4)
    tx = optimizers.get("sgd", 0.1)
    step_fn, _, _ = sequence.build_sp_train_step(ring, tx, mesh)
    _, ms = step_fn(engine.TrainState(0, ring, tx(ring.parameters())), batch)
    ref_state = engine.create_train_state(full, tx, device="cpu")
    _, ref = engine.make_train_step(full, "masked_lm", tx)(
        ref_state, {"features": batch["input_ids"],
                    "labels": batch["labels"]})
    np.testing.assert_allclose(float(ms["loss"]), float(ref["loss"]),
                               rtol=1e-5)
    for (name, a), b in zip(ring.state_dict().items(),
                            full.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-5,
                                   atol=5e-6, err_msg=name)


def test_ring_remat_blocks_equals_none():
    """remat="blocks" on the ring path: the same gradients, bit for bit
    (the recompute runs the same ops on the same inputs)."""
    mesh = sequence.make_sp_mesh(2, 2, devices=["cpu"] * 4)
    batch = _batch(b=2, t=32, seed=5)
    grads = {}
    for remat in ("none", "blocks"):
        model = gpt.init_params(gpt.gpt_tiny(attention="ring", remat=remat),
                                torch.Generator().manual_seed(1))
        tx = optimizers.get("sgd", 0.0)
        step_fn, _, _ = sequence.build_sp_train_step(model, tx, mesh)
        opt = tx(model.parameters())
        captured = {}
        opt.step = lambda: captured.update(
            {n: p.grad.clone() for n, p in model.named_parameters()})
        step_fn(engine.TrainState(0, model, opt), batch)
        grads[remat] = captured
    for name, g in grads["none"].items():
        assert torch.equal(g, grads["blocks"][name]), name


def test_sp_training_reduces_loss():
    mesh = sequence.make_sp_mesh(1, 8, devices=["cpu"] * 8)
    model = gpt.gpt_tiny(attention="ring")
    state = sequence.init_sp_state(model, optimizers.get("adam", 3e-3), mesh)
    step_fn, _, place_batch = sequence.build_sp_train_step(
        model, optimizers.get("adam", 3e-3), mesh)
    batch = place_batch(_batch(b=8, t=64, seed=1))
    losses = []
    for _ in range(20):
        state, ms = step_fn(state, batch)
        losses.append(float(ms["loss"]))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_sp_rejects_sequence_beyond_max_len():
    """Fails loudly, before any position row is sliced, when the global
    sequence exceeds max_len (a torch slice would come up short)."""
    mesh = sequence.make_sp_mesh(1, 8, devices=["cpu"] * 8)
    model = gpt.gpt_tiny(attention="ring", max_len=64)
    state = sequence.init_sp_state(model, optimizers.get("sgd", 0.01), mesh)
    step_fn, _, place_batch = sequence.build_sp_train_step(
        model, optimizers.get("sgd", 0.01), mesh)
    with pytest.raises(ValueError, match="max_len"):
        step_fn(state, place_batch(_batch(b=2, t=128, seed=3)))


def test_shift_labels_equals_jax():
    ids = np.random.default_rng(6).integers(0, 50, (3, 9)).astype(np.int32)
    np.testing.assert_array_equal(sequence.shift_labels(ids),
                                  jseq.shift_labels(ids))


def test_sp_mesh_and_model_validation():
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        sequence.make_sp_mesh(2, 4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        jseq.make_sp_mesh(2, 4, devices=jax.devices()[:4])
    mesh = sequence.make_sp_mesh(1, 2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="attention='ring'"):
        sequence.build_sp_train_step(gpt.gpt_tiny(),
                                     optimizers.get("sgd", 0.1), mesh)
    step_fn, _, _ = sequence.build_sp_train_step(
        gpt.gpt_tiny(attention="ring"), optimizers.get("sgd", 0.1), mesh)
    with pytest.raises(ValueError, match="does not split"):
        step_fn(None, _batch(b=2, t=63))
