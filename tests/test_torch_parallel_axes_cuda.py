"""Sequence and pipeline parallelism on a card: ``chip_smoke.py`` phase
30's checks at small shapes, on meshes that repeat ``cuda:0``.

Skipped without a CUDA device. This file imports no JAX, so it runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_axes_cuda.py

- ring attention against the plain one-device attention: float32 (TF32
  off) within 2e-5, the JAX tests' bound (the fold's order only), bf16
  within 2e-2 (phase 7's bf16 bound; the plain path rounds its softmax
  weights to bf16, the ring keeps them float32), finite gradients;
- one sequence-parallel step (float32) against ``engine.make_train_step``
  on the global batch through ``attention="full"``: the loss within 1e-5
  relative, the parameters after one SGD step within 5e-5 / 5e-6;
- one ``PipelinedLM`` step against ``reference_apply`` over the same
  microbatches, and one ``GenericPipeline`` step over ``resnet50()``
  against its sequential oracle: the losses within 1e-6 relative (the
  same ops on the same shapes), both GroupNorm kernels launched
  53 x M times over the pipelined step.
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import engine
from distkeras_tpu_torch.models import gpt, resnet
from distkeras_tpu_torch.ops import optimizers
from distkeras_tpu_torch.ops.attention import dot_product_attention
from distkeras_tpu_torch.ops.ring_attention import ring_attention_sharded
from distkeras_tpu_torch.parallel import pipeline, sequence

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _ids(b, t, vocab, seed):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)
    return {"input_ids": ids, "labels": sequence.shift_labels(ids)}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_ring_matches_plain_attention(cuda_device, dtype, tol):
    mesh = sequence.make_sp_mesh(1, 4, devices=[cuda_device] * 4)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 256, 4, 64, generator=gen).to(cuda_device,
                                                           dtype)
               .requires_grad_() for _ in range(3))
    for causal in (False, True):
        got = ring_attention_sharded(q, k, v, mesh, causal=causal)
        assert got.dtype == dtype
        want = dot_product_attention(q.float(), k.float(), v.float(),
                                     causal=causal)
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    got.float().square().sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


def test_sp_step_matches_single_device_step(cuda_device):
    ring = gpt.init_params(gpt.gpt_tiny(attention="ring"),
                           torch.Generator().manual_seed(1)).to(cuda_device)
    full = gpt.gpt_tiny(attention="full")
    full.load_state_dict(ring.state_dict())
    batch = _ids(4, 64, 256, seed=2)
    tx = optimizers.get("sgd", 0.1)
    mesh = sequence.make_sp_mesh(2, 2, devices=[cuda_device] * 4)
    step_fn, _, _ = sequence.build_sp_train_step(ring, tx, mesh)
    _, ms = step_fn(engine.TrainState(0, ring, tx(ring.parameters())), batch)
    state = engine.create_train_state(full, tx, device=cuda_device)
    _, ref = engine.make_train_step(full, "masked_lm", tx)(
        state, {"features": batch["input_ids"], "labels": batch["labels"]})
    assert abs(float(ms["loss"]) - float(ref["loss"])) \
        <= 1e-5 * abs(float(ref["loss"]))
    for (name, a), b in zip(ring.state_dict().items(),
                            full.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=5e-5, atol=5e-6, msg=name)


def test_pipelined_lm_matches_reference_microbatches(cuda_device):
    from distkeras_tpu_torch.ops import losses

    model = pipeline.PipelinedLM(
        vocab_size=256, max_len=64, num_layers=4, num_heads=2, width=64,
        mlp_dim=128, num_stages=4, dtype=torch.bfloat16,
        device=cuda_device).init(3)
    batch = _ids(8, 64, 256, seed=4)
    ids = torch.from_numpy(batch["input_ids"]).to(cuda_device)
    labels = torch.from_numpy(batch["labels"]).to(cuda_device)
    nll = count = 0.0
    for m in range(4):
        terms = losses.masked_lm_terms(
            model.reference_apply(ids[2 * m:2 * m + 2]),
            labels[2 * m:2 * m + 2])
        nll, count = nll + terms[0], count + terms[2]
    ref = (nll / count).item()
    step_fn, place_params, place_batch = model.build_train_step(
        optimizers.get("sgd", 0.0),
        pipeline.make_pp_mesh(4, devices=[cuda_device] * 4), 4)
    _, ms = step_fn(place_params(), place_batch(batch))
    assert abs(float(ms["loss"]) - ref) <= 1e-6 * abs(ref)


def test_generic_pipeline_over_resnet50_counts_groupnorm(cuda_device):
    from torch import nn
    from torch.nn import functional as F

    from distkeras_tpu_torch.ops.kernels import groupnorm as gn

    model = resnet.init_params(resnet.resnet50(),
                               torch.Generator().manual_seed(5))

    class Stem(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv_stem, self.norm_stem = model.conv_stem, \
                model.norm_stem

        def forward(self, x):
            x = self.conv_stem(x.to(model.dtype).permute(0, 3, 1, 2))
            x = self.norm_stem(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            return F.max_pool2d(F.relu(x), 3, stride=2, padding=1)

    class Rest(nn.Module):
        def __init__(self):
            super().__init__()
            self.blocks = nn.ModuleList(getattr(model, n)
                                        for n in model._blocks)
            self.head = model.head

        def forward(self, x):
            x = x.contiguous(memory_format=torch.channels_last)
            for block in self.blocks:
                x = block(x)
            return self.head(x.mean(dim=(2, 3)).float())

    pipe = pipeline.GenericPipeline([Stem(), Rest()], num_microbatches=2,
                                    dtype=torch.bfloat16, device=cuda_device)
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    labels = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, 4)]
    pipe.init(feats[:2])
    step_fn, place_params, place_batch = pipe.build_train_step(
        optimizers.get("sgd", 0.0),
        pipeline.make_pp_mesh(2, devices=[cuda_device] * 2))
    placed = place_batch({"features": feats, "labels": labels})
    with torch.no_grad():
        oracle = sum(pipe.loss_fn(
            pipe.reference_apply(placed["features"][2 * m:2 * m + 2])
            .float(), placed["labels"][2 * m:2 * m + 2])
            for m in range(2)).item() / 2
    state = place_params()
    gn.group_norm_fwd.launches = gn.group_norm_bwd.launches = 0
    _, ms = step_fn(state, placed)
    torch.cuda.synchronize()
    assert abs(float(ms["loss"]) - oracle) <= 1e-6 * abs(oracle)
    assert gn.group_norm_fwd.launches == gn.group_norm_bwd.launches == 106
