"""Pipeline parallelism: the port's ``PipelinedLM`` and
``GenericPipeline`` against the JAX package's.

JAX runs each step on conftest's CPU devices (one a stage); the port on
a mesh that repeats ``cpu``. Weights come from JAX's ``init``, bridged
(``utils/bridge.py``'s stacked-tree and per-stage carriers). Bounds,
float32, where only summation order differs: the loss at rtol 1e-5, the
parameters after one SGD step at rtol 5e-5 / atol 5e-6
(``test_pipeline_parallel.py``'s). Each JAX step is jitted once a
module.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn as tnn
from torch.nn import functional as F

from distkeras_tpu.parallel import pipeline as jpp
from distkeras_tpu.parallel import sequence as jseq
from distkeras_tpu_torch.ops import optimizers
from distkeras_tpu_torch.parallel import pipeline as pp
from distkeras_tpu_torch.utils import bridge

SGD_LR = 0.1
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=5e-5, atol=5e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lm_batch(b=8, t=16, vocab=64, seed=0):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)
    return {"input_ids": ids, "labels": jseq.shift_labels(ids)}


LM = dict(vocab_size=64, max_len=32, num_layers=4, num_heads=2, width=32,
          mlp_dim=64, num_stages=4)


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
def jax_lm_step():
    """JAX's PipelinedLM step (4 stages x 1 layer, M = 4, sgd 0.1): start
    and end params (numpy) and its metrics."""
    model = jpp.PipelinedLM(**LM)
    params = _np(model.init(jax.random.key(0), jnp.zeros((2, 16),
                                                         jnp.int32)))
    tx = optax.sgd(SGD_LR)
    step_fn, place_params, place_batch = model.build_train_step(
        tx, jpp.make_pp_mesh(4), num_microbatches=4)
    p = place_params(params)
    p, _, ms = step_fn(p, tx.init(p), place_batch(_lm_batch()))
    return params, _np(jax.device_get(p)), {k: float(v)
                                            for k, v in ms.items()}


def test_pipelined_lm_step_matches_jax(jax_lm_step):
    params0, params1, jms = jax_lm_step
    model = pp.PipelinedLM(**LM, device="cpu")
    mesh = pp.make_pp_mesh(4, devices=["cpu"] * 4)
    step_fn, place_params, place_batch = model.build_train_step(
        optimizers.get("sgd", SGD_LR), mesh, num_microbatches=4)
    state = place_params(bridge.pipelined_lm_to_state_dict(params0))
    state, ms = step_fn(state, place_batch(_lm_batch()))
    np.testing.assert_allclose(float(ms["loss"]), jms["loss"], **LOSS_TOL)
    np.testing.assert_allclose(float(ms["accuracy"]), jms["accuracy"],
                               **LOSS_TOL)
    want = bridge.pipelined_lm_to_state_dict(params1)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   **PARAM_TOL, err_msg=name)


def test_pipelined_lm_reference_apply_matches_jax(jax_lm_step):
    params0 = jax_lm_step[0]
    jmodel = jpp.PipelinedLM(**LM)
    ids = _lm_batch(b=2)["input_ids"]
    want = np.asarray(jax.jit(jmodel.reference_apply)(params0,
                                                      jnp.asarray(ids)))
    model = pp.PipelinedLM(**LM, device="cpu")
    model.load_state_dict(bridge.pipelined_lm_to_state_dict(params0))
    with torch.no_grad():
        got = model.reference_apply(ids)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pipelined_lm_bridge_round_trip(jax_lm_step):
    params0 = jax_lm_step[0]
    sd = bridge.pipelined_lm_to_state_dict(params0)
    assert sd["stages.2.0.attn.qkv.weight"].shape == (96, 32)
    np.testing.assert_array_equal(
        sd["stages.3.0.mlp.fc1.weight"].numpy(),
        params0["blocks"]["mlp"]["fc1"]["kernel"][3, 0].T)
    back = bridge.state_dict_to_pipelined_lm(sd)
    leaves = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    want, got = leaves(params0), leaves(back)
    assert set(want) == set(got)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf)


def test_pipelined_lm_stacked_layout_and_training():
    """init draws each layer on its own (layer s*L/P + j is stage s's
    j-th block); 2 stages x 2 layers train on a mesh of 2."""
    model = pp.PipelinedLM(**{**LM, "num_stages": 2}, device="cpu").init(1)
    w = [model.stages[s][j].attn.qkv.weight for s in range(2)
         for j in range(2)]
    assert all(not torch.equal(a, b) for a, b in zip(w, w[1:]))
    tx = optimizers.get("adam", 3e-3)
    step_fn, place_params, place_batch = model.build_train_step(
        tx, pp.make_pp_mesh(2, devices=["cpu"] * 2), num_microbatches=2)
    state = place_params()
    batch = place_batch(_lm_batch(seed=1))
    losses = []
    for _ in range(15):
        state, ms = step_fn(state, batch)
        losses.append(float(ms["loss"]))
    assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])


def test_pipelined_lm_validation():
    with pytest.raises(ValueError, match="divide"):
        pp.PipelinedLM(**{**LM, "num_layers": 6}, device="cpu")
    model = pp.PipelinedLM(**LM, device="cpu")
    with pytest.raises(ValueError, match="stage devices"):
        model.build_train_step(optimizers.get("sgd", 0.1),
                               pp.make_pp_mesh(2, devices=["cpu"] * 2), 2)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        pp.make_pp_mesh(4, devices=["cpu"] * 2)
    step_fn, place_params, _ = model.build_train_step(
        optimizers.get("sgd", 0.1), pp.make_pp_mesh(4, devices=["cpu"] * 4),
        3)
    with pytest.raises(ValueError, match="divisible"):
        step_fn(place_params(), _lm_batch(b=8))


# -- GenericPipeline: test_generic_pipeline.py's heterogeneous stages --------

class _JDenseRelu(nn.Module):
    width: int

    @nn.compact
    def __call__(self, x):
        return nn.relu(nn.Dense(self.width, name="fc")(x))


class _JConvPool(nn.Module):
    channels: int

    @nn.compact
    def __call__(self, x):
        y = nn.relu(nn.Conv(self.channels, (3, 3), name="conv")(x))
        return nn.avg_pool(y, (2, 2), strides=(2, 2))


class _JHead(nn.Module):
    classes: int

    @nn.compact
    def __call__(self, x):
        return nn.Dense(self.classes, name="out")(x.reshape((x.shape[0], -1)))


# the port's stages take float32 parameters and promote their input, as
# flax's modules do with a bf16 input (dtype None: promote_types)
class _DenseRelu(tnn.Module):
    def __init__(self, fan_in, width):
        super().__init__()
        self.fc = tnn.Linear(fan_in, width)

    def forward(self, x):
        return F.relu(self.fc(x.float()))


class _ConvPool(tnn.Module):
    """NHWC in and out, as flax's: SAME 3x3 conv, relu, 2x2 mean pool."""

    def __init__(self, fan_in, channels):
        super().__init__()
        self.conv = tnn.Conv2d(fan_in, channels, 3, padding=1)

    def forward(self, x):
        y = F.relu(self.conv(x.float().permute(0, 3, 1, 2)))
        return F.avg_pool2d(y, 2).permute(0, 2, 3, 1)


class _Head(tnn.Module):
    def __init__(self, fan_in, classes):
        super().__init__()
        self.out = tnn.Linear(fan_in, classes)

    def forward(self, x):
        return self.out(x.float().reshape(x.shape[0], -1))


def _gp_data(seed=0, n=8, classes=5):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, 8, 8, 3)).astype(np.float32)
    labels = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return {"features": feats, "labels": labels}


def _port_pipe(m=2, **kw):
    stages = [_ConvPool(3, 8), _ConvPool(8, 16), _DenseRelu(16, 32),
              _Head(2 * 2 * 32, 5)]
    return pp.GenericPipeline(stages, num_microbatches=m, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_generic_step():
    pipe = jpp.GenericPipeline([_JConvPool(8), _JConvPool(16),
                                _JDenseRelu(32), _JHead(5)],
                               num_microbatches=2)
    batch = _gp_data()
    params = _np(pipe.init(jax.random.key(0), batch["features"][:4]))
    tx = optax.sgd(SGD_LR)
    step, place_params, place_batch = pipe.build_train_step(
        tx, jpp.make_pp_mesh(4))
    p = place_params(params)
    p, _, ms = step(p, tx.init(p), place_batch(batch))
    return params, _np(jax.device_get(p)), float(ms["loss"])


def test_generic_pipeline_step_matches_jax(jax_generic_step):
    params0, params1, jloss = jax_generic_step
    pipe = _port_pipe()
    batch = _gp_data()
    pipe.init(batch["features"][:4])
    assert pipe._shapes == [(4, 4, 4, 8), (4, 2, 2, 16), (4, 2, 2, 32),
                            (4, 5)]
    step, place_params, place_batch = pipe.build_train_step(
        optimizers.get("sgd", SGD_LR),
        pp.make_pp_mesh(4, devices=["cpu"] * 4))
    state = place_params(bridge.pipeline_stages_to_state_dicts(params0))
    state, ms = step(state, place_batch(batch))
    np.testing.assert_allclose(float(ms["loss"]), jloss, **LOSS_TOL)
    want = bridge.pipeline_stages_to_state_dicts(params1)
    for k, stage in enumerate(pipe.stages):
        for name, p in stage.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[k][name].numpy(),
                                       **PARAM_TOL, err_msg=f"{k}.{name}")
    back = bridge.state_dicts_to_pipeline_stages(
        tuple(s.state_dict() for s in pipe.stages))
    np.testing.assert_allclose(back[0]["conv"]["kernel"],
                               params1[0]["conv"]["kernel"], **PARAM_TOL)


def test_generic_pipeline_bf16_hops_round_as_jax(jax_generic_step):
    """dtype=bf16: features and every hop are cast to bf16 (the flat
    buffer), the stages compute in float32 (flax promotes a bf16 input
    against float32 params): the loss is JAX's bf16 pipeline's, apart
    from float32 summation order (a rare bf16 rounding flip moves it by
    far less than 1e-4), and not the float32 pipeline's."""
    params0, _, loss_f32 = jax_generic_step
    pipe = jpp.GenericPipeline([_JConvPool(8), _JConvPool(16),
                                _JDenseRelu(32), _JHead(5)],
                               num_microbatches=2, dtype=jnp.bfloat16)
    batch = _gp_data()
    pipe.init(jax.random.key(0), batch["features"][:4])
    tx = optax.sgd(0.0)
    step, place_params, place_batch = pipe.build_train_step(
        tx, jpp.make_pp_mesh(4))
    p = place_params(params0)
    _, _, ms = step(p, tx.init(p), place_batch(batch))
    port = _port_pipe(dtype=torch.bfloat16)
    port.init(batch["features"][:4])
    step, place_params, _ = port.build_train_step(
        optimizers.get("sgd", 0.0), pp.make_pp_mesh(4, devices=["cpu"] * 4))
    state = place_params(bridge.pipeline_stages_to_state_dicts(params0))
    _, got = step(state, batch)
    np.testing.assert_allclose(float(got["loss"]), float(ms["loss"]),
                               rtol=1e-4)
    assert float(got["loss"]) != loss_f32


def test_generic_pipeline_trains():
    """Starts from its JAX twin's weights (``key(0)``, bridged), so the
    start does not hang on torch's global generator and on which tests
    ran before."""
    rng = np.random.default_rng(1)
    y = rng.integers(0, 5, 32)
    batch = {"features": rng.standard_normal((32, 12)).astype(np.float32)
             + y[:, None].astype(np.float32),
             "labels": np.eye(5, dtype=np.float32)[y]}
    params0 = _np(jpp.GenericPipeline(
        [_JDenseRelu(16), _JHead(5)], num_microbatches=4).init(
            jax.random.key(0), batch["features"][:8]))
    pipe = pp.GenericPipeline([_DenseRelu(12, 16), _Head(16, 5)],
                              num_microbatches=4, device="cpu")
    pipe.init(batch["features"][:8])
    step, place_params, place_batch = pipe.build_train_step(
        optimizers.get("sgd", 0.2), pp.make_pp_mesh(2, devices=["cpu"] * 2))
    state = place_params(bridge.pipeline_stages_to_state_dicts(params0))
    batch = place_batch(batch)
    losses = []
    for _ in range(25):
        state, ms = step(state, batch)
        losses.append(float(ms["loss"]))
    assert losses[-1] < 0.6 * losses[0], losses[::6]


def test_generic_pipeline_validation():
    """JAX's cases: >= 2 stages, init before build, the mesh's stage
    count, batch divisibility; and a microbatch of another shape than
    init's."""
    cpu = lambda n: pp.make_pp_mesh(n, devices=["cpu"] * n)
    with pytest.raises(ValueError, match=">= 2"):
        pp.GenericPipeline([_Head(6, 3)], num_microbatches=2, device="cpu")
    pipe = pp.GenericPipeline([_DenseRelu(6, 8), _Head(8, 3)],
                              num_microbatches=2, device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        pipe.build_train_step(optimizers.get("sgd", 0.1), cpu(2))
    pipe.init(np.zeros((4, 6), np.float32))
    with pytest.raises(ValueError, match="stage devices"):
        pipe.build_train_step(optimizers.get("sgd", 0.1), cpu(4))
    step, place_params, place_batch = pipe.build_train_step(
        optimizers.get("sgd", 0.1), cpu(2))
    state = place_params()
    bad = {"features": np.zeros((5, 6), np.float32),
           "labels": np.zeros((5, 3), np.float32)}
    with pytest.raises(ValueError, match="divisible"):
        step(state, place_batch(bad))
    other = {"features": np.zeros((4, 6), np.float32),
             "labels": np.zeros((4, 3), np.float32)}
    with pytest.raises(ValueError, match="init recorded"):
        step(state, other)
