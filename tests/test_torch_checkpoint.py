"""Serialization and checkpoints of the PyTorch port against the JAX
package.

- DKTP2 bytes: ``serialize_params`` of one numpy tree is byte-identical
  in both packages (bf16 leaves included: ml_dtypes on the JAX side,
  torch's bfloat16 on the port's); a container written by either loads
  in the other (flax layout through ``utils/bridge.py``) and gives the
  same logits (float32, within 1e-5: the two BLAS sum 784 products
  in other orders);
- the container's edges: bf16 round-trips bit for bit, a truncated
  container raises, a v1 ``.npz`` blob is readable;
- ``Checkpointer``: round trip, retention, a missing step raises, the
  manifest probe reads no data;
- trainers: ``SingleTrainer`` and ``ADAG`` resumed from a checkpoint end
  bitwise on the uninterrupted run's parameters on the CPU (JAX
  ``test_trainer_checkpoint.py``, which holds its own to 1e-6), a fresh
  run on a used directory raises, and the elastic cases of JAX
  ``test_elastic_resume.py`` that do not need Orbax's legacy layout.
"""

import io
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distkeras_tpu.models.mlp import MLP as JMLP
from distkeras_tpu.utils import serialization as jser
from distkeras_tpu_torch import (ADAG, EAMSGD, AveragingTrainer,
                                 SingleTrainer, synthetic_mnist)
from distkeras_tpu_torch.checkpoint import (Checkpointer, load_params,
                                            save_params)
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.parallel.mesh import Mesh
from distkeras_tpu_torch.utils import bridge
from distkeras_tpu_torch.utils import serialization as tser


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": rng.standard_normal((5, 3)).astype(
        np.float32), "bias": np.arange(3, dtype=np.int32)},
        "a": [np.float64(2.5), np.ones((2, 2), np.uint8)],
        "scalar": np.asarray(7, np.int64)}


def test_serialize_params_bytes_equal_jax():
    tree = _tree()
    assert tser.serialize_params(tree) == jser.serialize_params(tree)
    bf = np.random.default_rng(1).standard_normal((4, 6)).astype(
        ml_dtypes.bfloat16)
    port_bf = torch.from_numpy(bf.view(np.uint16).copy()).view(
        torch.bfloat16)
    assert tser.serialize_params({"w": port_bf}) == \
        jser.serialize_params({"w": bf})
    buf = io.BytesIO()
    n = tser.write_params(buf, tree)
    assert buf.getvalue() == jser.serialize_params(tree) and n == len(
        buf.getvalue())


def _jax_mlp():
    model = JMLP(features=(16,))
    params = model.init(jax.random.key(0), jnp.zeros((1, 784)))["params"]
    return model, jax.tree.map(np.asarray, params)


def test_containers_cross_load_both_ways_to_the_same_logits():
    jmodel, jparams = _jax_mlp()
    x = np.random.default_rng(2).standard_normal((4, 784)).astype(
        np.float32)
    want = np.asarray(jmodel.apply({"params": jparams}, x))
    # JAX writes, the port loads
    port = bridge.load_flax_params(
        MLP(features=(16,)),
        tser.deserialize_params(jser.serialize_params(jparams)))
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the port writes (perturbed weights), JAX loads with like=
    with torch.no_grad():
        for p in port.parameters():
            p.mul_(1.5)
    blob = tser.serialize_params(bridge.state_dict_to_flax(
        port.state_dict()))
    back = jser.deserialize_params(blob, like=jparams)
    np.testing.assert_allclose(
        np.asarray(jmodel.apply({"params": back}, x)),
        port(torch.from_numpy(x)).detach().numpy(), rtol=1e-5, atol=1e-5)


def test_bf16_round_trip_truncation_and_v1_npz():
    t = torch.randn(3, 5).to(torch.bfloat16)
    back = tser.deserialize_params(tser.serialize_params({"w": t}))["w"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    data = tser.serialize_params(_tree())
    for cut in (3, 20, len(data) - 1):
        with pytest.raises(ValueError):
            tser.deserialize_params(data[:cut])
    with pytest.raises(ValueError):
        tser.deserialize_params(data + b"\0")
    buf = io.BytesIO()
    np.savez(buf, **{"dense/kernel": np.eye(2, dtype=np.float32)})
    old = tser.deserialize_params(buf.getvalue())
    np.testing.assert_array_equal(old["dense"]["kernel"], np.eye(2))
    like = {"dense": {"kernel": torch.zeros(2, 2)}}
    restored = tser.deserialize_params(buf.getvalue(), like=like)
    assert isinstance(restored["dense"]["kernel"], torch.Tensor)
    with pytest.raises(ValueError, match="keys mismatch"):
        tser.deserialize_params(buf.getvalue(), like={"other": 0})


def test_serialize_model_rebuilds_the_module(tmp_path):
    model = MLP(features=(8, 4), dropout_rate=0.25, in_features=12)
    blob = tser.serialize_model(model)
    rebuilt, params = tser.deserialize_model(blob)
    assert (rebuilt.features, rebuilt.dropout_rate, rebuilt.in_features) == \
        ((8, 4), 0.25, 12)
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              rebuilt.state_dict().items()):
        assert torch.equal(a, b), n
    path = str(tmp_path / "p.dktp")
    save_params(path, model.state_dict())
    loaded = load_params(path, like=model.state_dict())
    assert all(torch.equal(loaded[n], v)
               for n, v in model.state_dict().items())
    fresh = tser.uniform_weights(model.state_dict(), seed=3)
    assert all(-0.5 <= float(v.min()) and float(v.max()) <= 0.5
               for v in fresh.values())


def test_checkpointer_round_trip_retention_and_missing_steps(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    for step in range(4):
        ck.save(step, {"w": torch.full((3,), float(step)),
                       "n": np.asarray(step)})
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    got = ck.restore()
    np.testing.assert_array_equal(got["w"], np.full(3, 3.0))
    like = {"w": torch.zeros(3), "n": np.asarray(0)}
    old = ck.restore(like=like, step=2)
    assert isinstance(old["w"], torch.Tensor) and float(old["w"][0]) == 2.0
    with pytest.raises(FileNotFoundError):
        ck.restore(step=0)
    assert ck.metadata()["w"].shape == (3,)
    multi = Checkpointer(str(tmp_path / "m"), items=("state", "carries"))
    multi.save(0, {"state": {"c": np.zeros(2)}, "carries": [{"p": np.ones(
        4)}]})
    assert multi.step_items() == ["carries", "state"]
    assert multi.metadata(item="carries")["0"]["p"].shape == (4,)
    assert set(multi.restore(items=("state",))) == {"state"}
    with pytest.raises(ValueError, match="not declared"):
        multi.save(1, {"other": {}})
    multi.clear()
    assert multi.latest_step() is None
    with pytest.raises(FileNotFoundError):
        multi.restore()


def _model():
    torch.manual_seed(0)
    return MLP(features=(16,), num_classes=10)


def test_single_trainer_resume_matches_uninterrupted(tmp_path):
    ds = synthetic_mnist(n=512)
    kw = dict(worker_optimizer="momentum", learning_rate=0.05,
              batch_size=64, seed=1, device="cpu")
    p_full = SingleTrainer(_model(), num_epoch=4, **kw).train(ds)
    SingleTrainer(_model(), num_epoch=2, checkpoint_dir=str(tmp_path),
                  **kw).train(ds)
    second = SingleTrainer(_model(), num_epoch=4,
                           checkpoint_dir=str(tmp_path), **kw)
    p_resumed = second.train(ds, resume=True)
    assert all(torch.equal(p_full[n], p_resumed[n]) for n in p_full)
    assert len(second.get_history()) == 2 * (512 // 64)


def test_adag_resume_matches_uninterrupted(tmp_path):
    ds = synthetic_mnist(n=1024)
    kw = dict(worker_optimizer="adam", learning_rate=0.01, batch_size=16,
              parallelism_factor=4, communication_window=2, seed=2,
              device="cpu")
    full = ADAG(_model(), num_epoch=4, **kw)
    p_full = full.train(ds)
    first = ADAG(_model(), num_epoch=2, checkpoint_dir=str(tmp_path), **kw)
    first.train(ds)
    assert first.num_updates == 2 * 4 * (1024 // 4 // 32)
    second = ADAG(_model(), num_epoch=4, checkpoint_dir=str(tmp_path), **kw)
    p_resumed = second.train(ds, resume=True)
    assert all(torch.equal(p_full[n], p_resumed[n]) for n in p_full)
    # the staleness rotation continued from the saved round counter
    assert second.num_updates == full.num_updates
    assert second.staleness_history == full.staleness_history[
        len(full.staleness_history) // 2:]


def test_fresh_run_on_a_used_directory_raises(tmp_path):
    ds = synthetic_mnist(n=256)
    kw = dict(batch_size=32, device="cpu", checkpoint_dir=str(tmp_path))
    SingleTrainer(_model(), num_epoch=1, **kw).train(ds)
    with pytest.raises(ValueError, match="resume=False"):
        SingleTrainer(_model(), num_epoch=1, **kw).train(ds)
    # a sync trainer's resume refuses a SingleTrainer's step
    with pytest.raises(ValueError, match="state\\+carries"):
        ADAG(_model(), num_epoch=2, parallelism_factor=2,
             communication_window=2, **kw).train(ds, resume=True)


# -- the elastic cases of JAX's test_elastic_resume.py ------------------------

def _ekw(**over):
    kw = dict(worker_optimizer="sgd", learning_rate=0.05, metrics=(),
              batch_size=8, communication_window=2)
    kw.update(over)
    return kw


def _mesh(n):
    return Mesh(["cpu"] * n)


def test_resume_on_fewer_and_more_workers(tmp_path):
    ds = synthetic_mnist(n=1024)
    t8 = ADAG(_model(), mesh=_mesh(8), num_epoch=2,
              checkpoint_dir=str(tmp_path / "ck"), **_ekw())
    t8.train(ds)
    saved_updates = t8.num_updates
    t4 = ADAG(_model(), mesh=_mesh(4), num_epoch=4,
              checkpoint_dir=str(tmp_path / "ck"), **_ekw())
    with pytest.warns(RuntimeWarning, match="ELASTIC RESUME"):
        t4.train(ds, resume=True)
    rounds_per_epoch = 1024 // 4 // 16
    assert len(t4.staleness_history) == 2 * rounds_per_epoch
    assert t4.num_updates == saved_updates + 2 * rounds_per_epoch * 4
    losses = [h["loss"] for h in t4.history]
    assert np.isfinite(losses).all() and losses[0] < 2.0
    t2 = ADAG(_model(), mesh=_mesh(2), num_epoch=1,
              checkpoint_dir=str(tmp_path / "up"), **_ekw())
    t2.train(ds)
    t8 = ADAG(_model(), mesh=_mesh(8), num_epoch=2,
              checkpoint_dir=str(tmp_path / "up"), **_ekw())
    with pytest.warns(RuntimeWarning, match="ELASTIC RESUME"):
        t8.train(ds, resume=True)
    assert len(t8.staleness_history) == 1024 // 8 // 16


def test_parallelism_factor_change_is_a_full_restore(tmp_path):
    ds = synthetic_mnist(n=1024)
    runs = []
    for mesh, factor, where in ((_mesh(8), 1, "a"), (_mesh(4), 2, "b")):
        ADAG(_model(), mesh=_mesh(8), num_epoch=1,
             checkpoint_dir=str(tmp_path / where), **_ekw()).train(ds)
        tr = ADAG(_model(), mesh=mesh, parallelism_factor=factor,
                  num_epoch=2, checkpoint_dir=str(tmp_path / where),
                  **_ekw())
        assert tr.num_workers == 8
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            tr.train(ds, resume=True)
        runs.append(tr)
    a, b = (sum(float(v.abs().sum()) for v in t.params.values())
            for t in runs)
    # the port's fold sums each device's replicas first (substrate.py),
    # so 8 devices and 4 x 2 associate the same commits differently: the
    # JAX test's 6-decimal loss equality becomes float32 rounding
    np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_allclose([h["loss"] for h in runs[0].history],
                               [h["loss"] for h in runs[1].history],
                               rtol=1e-5)


def test_averaging_refuses_topology_change_with_clear_error(tmp_path):
    ds = synthetic_mnist(n=1024)
    AveragingTrainer(_model(), mesh=_mesh(8), num_epoch=1,
                     checkpoint_dir=str(tmp_path), **_ekw()).train(ds)
    t4 = AveragingTrainer(_model(), mesh=_mesh(4), num_epoch=2,
                          checkpoint_dir=str(tmp_path), **_ekw())
    with pytest.raises(ValueError, match="center-only restore would "
                       "discard the training"):
        t4.train(ds, resume=True)


def test_strategy_change_same_topology_is_a_clear_error(tmp_path):
    ds = synthetic_mnist(n=1024)
    ADAG(_model(), mesh=_mesh(4), num_epoch=1,
         checkpoint_dir=str(tmp_path), **_ekw()).train(ds)
    t2 = EAMSGD(_model(), mesh=_mesh(4), num_epoch=2, rho=1.0,
                checkpoint_dir=str(tmp_path), learning_rate=0.05,
                metrics=(), batch_size=8, communication_window=2)
    with pytest.raises(ValueError, match="strategy"):
        t2.train(ds, resume=True)


def test_checkpoints_split_carries_into_their_own_item(tmp_path):
    ds = synthetic_mnist(n=1024)
    t = ADAG(_model(), mesh=_mesh(8), num_epoch=1,
             checkpoint_dir=str(tmp_path), **_ekw())
    t.train(ds)
    ck = Checkpointer(str(tmp_path), items=("state", "carries"))
    step = ck.latest_step()
    assert ck.step_items(step) == ["carries", "state"]
    assert len(ck.metadata(step, item="carries")) == 8
    out = ck.restore(step=step, host=True, items=("state",))
    assert set(out) == {"state"}
    assert int(out["state"]["counters"][1]) == t.num_updates
    assert int(out["state"]["counters"][2]) == 8
