"""The one-process workers x model mesh on a card: ``chip_smoke.py``
phase 29's (b)-(d) checks at small shapes, on meshes that repeat
``cuda:0``.

Skipped without a CUDA device. This file imports no JAX, so it runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_pjit_cuda.py

- (b) ``PjitTrainer(bert_tiny(), precision="int8")`` (re-stamped): the
  int8 kernel launched ``4 x layers + 1`` times a step, model 2 and
  model 1 losses and params bitwise equal, every sharded parameter's
  shards half its bytes, adam's moments on the shards;
- (c) the MoE classifier with ``attention="flash"`` under
  ``ep_partition_rules()`` at workers 2 x model 2: each flash kernel
  launched once a block a step (the global batch's one pass), the
  expert tensors sharded on their stacked axis, finite losses within
  1e-3 relative of workers 1 x model 1's at steps 1-2;
- (d) ``ServingEngine(mesh=Mesh(["cuda:0"] * 2))`` over a flash causal
  LM in bf16: buckets x shards graphs all captured in ``__init__``, none
  under traffic, layers x shards flash launches a batch counted per
  replay, rows within 2e-2 * max|ref| of the ``mesh=None`` engine's.
"""

import math

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import Dataset, PjitTrainer
from distkeras_tpu_torch.models import moe, transformer
from distkeras_tpu_torch.models.bert import bert_tiny
from distkeras_tpu_torch.parallel import tensor
from distkeras_tpu_torch.parallel.mesh import Mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _train(model, ds, mesh, kernels, **kw):
    trainer = PjitTrainer(model, mesh=mesh, metrics=(), **kw)
    for k in kernels:
        k.launches = 0
    params = trainer.train(ds)
    torch.cuda.synchronize()
    return trainer, params, {k.__name__: k.launches for k in kernels}


def test_int8_restamped_bert_model2_is_bitwise_model1(cuda_device):
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8

    rng = np.random.default_rng(0)
    ids = rng.integers(1, 256, (64, 32)).astype(np.int32)
    labels = np.where(rng.random((64, 32)) < 0.15, ids, -1).astype(np.int32)
    ds = Dataset.from_arrays(features=ids, label=labels)
    start = transformer.init_params(bert_tiny(num_layers=2),
                                    torch.Generator().manual_seed(0))
    state = {n: t.clone() for n, t in start.state_dict().items()}
    out = {}
    for m in (2, 1):
        model = bert_tiny(num_layers=2)
        model.load_state_dict(state)
        out[m] = _train(model, ds, Mesh([cuda_device] * m,
                                        model_parallelism=m),
                        (i8.int8_matmul_dequant,), loss="masked_lm",
                        precision="int8", worker_optimizer="adam",
                        learning_rate=1e-3, batch_size=16)
    steps = 64 // 16
    for m in (1, 2):
        assert out[m][0].model.precision == "int8"
        assert out[m][2]["int8_matmul_dequant"] == (4 * 2 + 1) * steps
    assert [h["loss"] for h in out[2][0].history] == \
        [h["loss"] for h in out[1][0].history]
    assert all(math.isfinite(h["loss"]) for h in out[2][0].history)
    assert all(torch.equal(out[2][1][n], out[1][1][n]) for n in out[1][1])
    inner = out[2][0].state.opt_state.inner
    sharded = [p for p in out[2][0].state.params.values()
               if isinstance(p, tensor.Sharded)]
    assert sharded
    for p in sharded:
        whole = math.prod(p.shape) * p.shards[0].element_size()
        for s in p.shards:
            assert 2 * s.nbytes == whole and s.device.type == "cuda"
            assert inner.state[s]["exp_avg"].shape == s.shape
            assert inner.state[s]["exp_avg"].device == s.device


def test_moe_flash_under_ep_rules_workers2_model2(cuda_device):
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 128, 128)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    ds = Dataset.from_arrays(features=x, label=y)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)

    def model():
        return transformer.init_params(moe.MoEClassifier(
            4, num_layers=2, num_heads=2, num_experts=4, mlp_dim=256,
            width=128, attention="flash"), torch.Generator().manual_seed(0))

    runs = {}
    for key, (w, m) in (("w2m2", (2, 2)), ("w1m1", (1, 1))):
        runs[key] = _train(model(), ds, Mesh([cuda_device] * (w * m),
                                             model_parallelism=m),
                           kernels, partition_rules=moe.ep_partition_rules(),
                           worker_optimizer="adam", learning_rate=1e-4,
                           batch_size=8)
    steps = 16 // 8
    for trainer, _, launches in runs.values():  # 2 blocks a step
        assert all(n == 2 * steps for n in launches.values()), launches
        assert all(math.isfinite(h["loss"]) for h in trainer.history)
    w1 = runs["w2m2"][0].state.params["block0.moe.experts.fc1.weight"]
    assert w1.dim == 0 and [tuple(s.shape) for s in w1.shards] == \
        [(2, 256, 128)] * 2
    losses = {k: [h["loss"] for h in r[0].history] for k, r in runs.items()}
    # the global batch's loss at both mesh shapes: steps 1-2 agree
    for a, b in zip(losses["w2m2"], losses["w1m1"], strict=True):
        assert abs(a - b) <= 1e-3 * abs(b)


def test_serving_engine_over_a_mesh(cuda_device):
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.models.gpt import CausalLM, init_params
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.serving import ServingEngine

    def lm():
        return init_params(CausalLM(vocab_size=512, max_len=256,
                                    num_layers=2, num_heads=2, width=128,
                                    mlp_dim=256, attention="flash"),
                           torch.Generator().manual_seed(0))

    rows = np.random.default_rng(2).integers(0, 512, (5, 128)).astype(
        np.int32)
    kw = dict(input_dtype=np.int32, buckets=(2, 4), max_wait_ms=50.0)
    telemetry.reset()
    fa.flash_attention_fwd.captured = 0
    eng = ServingEngine(lm(), (128,), mesh=Mesh([cuda_device] * 2), **kw)
    try:
        captured = fa.flash_attention_fwd.captured
        assert eng.captures == 4 and captured == 2 * 4
        fa.flash_attention_fwd.launches = 0
        got = np.stack([f.result(timeout=60)
                        for f in eng.submit_many(rows)]).astype(np.float32)
        batches = telemetry.counter("serving.batches").value
        assert fa.flash_attention_fwd.launches == 2 * 2 * batches
        assert fa.flash_attention_fwd.captured == captured
        assert telemetry.counter("serving.compiles").value == 4
    finally:
        eng.shutdown()
    with ServingEngine(lm(), (128,), device=cuda_device, **kw) as one:
        want = np.stack([f.result(timeout=60)
                         for f in one.submit_many(rows)]).astype(np.float32)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
