"""The measurement plane and checkpoints on a card: FLOPs counts on
``cuda:0`` (the kernels report their formulas) against the CPU's (their
plain versions run as aten ops), the profiler capture naming the
hand-written kernels, the calibration inside ``CAL_BAND``, and a trainer
resumed from a checkpoint on the card against the uninterrupted run.

Skipped without a CUDA device. This file imports no JAX, so it runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_measure_cuda.py

Bounds: counts are equal (integer-valued sums of the same formulas);
the resumed run equals the uninterrupted one bitwise (float32, TF32 off,
cuDNN deterministic: the same kernels on the same inputs in the same
order).
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import ADAG, SingleTrainer, observability
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models.gpt import CausalLM, init_params
from distkeras_tpu_torch.models.resnet import (BasicBlock, ResNet,
                                               init_params as resnet_init)
from distkeras_tpu_torch.ops.kernels import flash_attention as fa
from distkeras_tpu_torch.ops.kernels import groupnorm as gn
from distkeras_tpu_torch.ops.kernels import int8_matmul as i8
from distkeras_tpu_torch.profiling import capture_op_times


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda:0")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = prev


def _both(dev, fn, *arrays):
    """``count_flops(fn(*tensors))`` on the card and on the CPU."""
    out = []
    for where in (dev, torch.device("cpu")):
        ts = [torch.as_tensor(a).to(where) for a in arrays]
        out.append(observability.count_flops(lambda: fn(*ts)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_counts_on_the_card_equal_the_cpus(cuda_device, dtype):
    rng = np.random.default_rng(0)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (1, 128, 2, 64)).astype(np.float32)).to(dtype) for _ in range(4))
    card, cpu = _both(cuda_device, lambda *a: fa.flash_attention_fwd(*a),
                      q, k, v)
    assert card == cpu == fa.flash_flops("flash_attention_fwd", q.shape)
    out, lse = fa.flash_attention_reference(q, k, v)
    delta = fa.flash_attention_delta(out, dout)
    for fn in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        card, cpu = _both(cuda_device, fn, q, k, v, dout, lse, delta)
        assert card == cpu == fa.flash_flops(fn.__name__, q.shape)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64)).astype(
        np.float32)).to(dtype)
    card, cpu = _both(cuda_device, lambda *a: gn.group_norm_fwd(*a, 32), x,
                      torch.ones(64), torch.zeros(64))
    assert card == cpu == 0
    qx = torch.from_numpy(rng.integers(-127, 128, (128, 64)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-127, 128, (96, 64)).astype(np.int8))
    card, cpu = _both(cuda_device, lambda *a: i8.int8_matmul_dequant(
        *a, torch.bfloat16), qx, qw, torch.tensor([0.5]))
    assert card == cpu == 2 * 128 * 96 * 64


@pytest.mark.cuda
def test_flash_model_step_counts_on_the_card_equal_the_cpus(cuda_device):
    from distkeras_tpu_torch import engine

    rng = np.random.default_rng(1)
    x = rng.integers(1, 256, (2, 128))
    batch = {"features": x, "labels": np.concatenate(
        [x[:, 1:], np.full((2, 1), -1)], axis=1)}
    counts = []
    for where in (cuda_device, torch.device("cpu")):
        model = init_params(CausalLM(vocab_size=256, max_len=128,
                                     num_layers=2, num_heads=2, width=128,
                                     mlp_dim=256, dtype=torch.bfloat16,
                                     attention="flash"),
                            torch.Generator().manual_seed(0)).to(where)
        grad = engine.make_grad_fn(model, "masked_lm")
        b = engine.to_device(batch, where)
        counts.append(observability.count_flops(lambda: grad(b)))
    assert counts[0] == counts[1] > 0


@pytest.mark.cuda
def test_capture_names_the_kernels(cuda_device):
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 256, 2, 64)).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for _ in range(3))
    x = torch.from_numpy(rng.standard_normal((2, 256, 64)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    gamma = torch.ones(64, device=cuda_device)
    beta = torch.zeros(64, device=cuda_device)

    def step():
        out, _ = fa.flash_attention_fwd(q, k, v)
        y, _ = gn.group_norm_fwd(x, gamma, beta, 32)
        return out.sum() + y.float().sum()

    step()
    table = capture_op_times(step, steps=2)
    assert table.available, table.note
    assert {"flash_attention_fwd", "group_norm_fwd"} <= set(table.kernels())
    assert 0 < table.busy_share <= 1.5
    assert table.steps == 2 and table.wall_s > 0


@pytest.mark.cuda
def test_calibration_lands_in_the_band(cuda_device):
    cal = observability.calibrate_peak()
    if cal is None:
        pytest.skip(f"the peak table does not know "
                    f"{torch.cuda.get_device_name(0)!r}")
    lo, hi = observability.CAL_BAND
    assert lo <= cal["ratio"] <= hi, cal


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return Dataset.from_arrays(features=x, label=y)


def _resnet():
    return resnet_init(ResNet(stage_sizes=(1, 1), block=BasicBlock, width=8,
                              num_classes=10, dtype=torch.float32,
                              norm="gn"), torch.Generator().manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["adag", "single"])
def test_resume_on_the_card_matches_the_uninterrupted_run(cuda_device,
                                                          tmp_path, kind):
    def trainer(epochs, directory):
        kw = dict(worker_optimizer="momentum", learning_rate=0.05,
                  batch_size=16, num_epoch=epochs, metrics=(),
                  checkpoint_dir=directory)
        if kind == "single":
            return SingleTrainer(_resnet(), **kw)
        return ADAG(_resnet(), parallelism_factor=2, communication_window=2,
                    **kw)

    ds = _images(128)
    full = trainer(3, None).train(ds)
    trainer(2, str(tmp_path)).train(ds)
    resumed = trainer(3, str(tmp_path)).train(ds, resume=True)
    for n in full:
        assert full[n].device.type == "cuda"
        assert torch.equal(full[n], resumed[n]), n
