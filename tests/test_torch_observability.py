"""The port's observability against the JAX package's, on the CPU.

- ``count_flops``: the port's count (``FlopCounterMode`` plus the JAX
  convention's convolution-gradient formula) equals the JAX package's
  jaxpr count within 1e-9 relative, forward and one gradient step, on
  bridged ``mnist_mlp``, a narrow ``cifar10_cnn``, ``bench.py``'s tiny
  NF ResNet and ``gpt_tiny``;
- each hand-written kernel's formula equals its plain version's
  ``FlopCounterMode`` count at two shapes (on the CPU the wrappers run
  the plain versions, which the counter sees);
- the peak table by (monkeypatched) CUDA device name, ``mfu``,
  ``StepTimer``, ``time_threaded_steps``, and the card-only probes, which
  return None here.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from distkeras_tpu import engine as jengine
from distkeras_tpu import observability as jobs
from distkeras_tpu.models import cnn as jcnn
from distkeras_tpu.models import gpt as jgpt
from distkeras_tpu.models import mlp as jmlp
from distkeras_tpu.models import resnet as jresnet
from distkeras_tpu_torch import engine as tengine
from distkeras_tpu_torch import observability as tobs
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import cnn as tcnn
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.models import mlp as tmlp
from distkeras_tpu_torch.models import resnet as tresnet
from distkeras_tpu_torch.ops.kernels import accounting
from distkeras_tpu_torch.ops.kernels import flash_attention as fa
from distkeras_tpu_torch.ops.kernels import groupnorm as gn
from distkeras_tpu_torch.ops.kernels import int8_matmul as i8
from distkeras_tpu_torch.utils import bridge


def _inputs(name):
    rng = np.random.default_rng(0)
    if name == "gpt_tiny":
        x = rng.integers(1, 256, (2, 128))
        y = np.concatenate([x[:, 1:], np.full((2, 1), -1)], axis=1)
        return x.astype(np.int32), y.astype(np.int32), "masked_lm"
    shape = {"mnist_mlp": (8, 784), "cifar10_cnn": (4, 32, 32, 3),
             "nf_resnet": (4, 32, 32, 3)}[name]
    x = rng.standard_normal(shape).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, shape[0])]
    return x, y, "categorical_crossentropy"


def _pair(name):
    if name == "mnist_mlp":
        return jmlp.mnist_mlp(), tmlp.mnist_mlp()
    if name == "cifar10_cnn":
        kw = dict(channels=(8, 16), dense_width=64)
        return jcnn.cifar10_cnn(**kw), tcnn.cifar10_cnn(**kw)
    if name == "nf_resnet":  # bench.py's tiny configuration
        kw = dict(stage_sizes=(1, 1), width=8, num_classes=10, norm="nf")
        return (jresnet.ResNet(block=jresnet.BasicBlock, dtype=jnp.float32,
                               **kw),
                tresnet.ResNet(block=tresnet.BasicBlock,
                               dtype=torch.float32, **kw))
    return jgpt.gpt_tiny(), tgpt.gpt_tiny()


MODELS = ("mnist_mlp", "cifar10_cnn", "nf_resnet", "gpt_tiny")


@pytest.fixture(scope="module")
def bridged():
    """name -> (jax model, jax params, port model, x, y, loss), the port
    model holding the JAX params."""
    out = {}
    for name in MODELS:
        jm, tm = _pair(name)
        x, y, loss = _inputs(name)
        params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
        bridge.load_flax_params(tm, jax.tree.map(np.asarray, params))
        out[name] = (jm, params, tm, x, y, loss)
    return out


@pytest.mark.parametrize("what", ["forward", "grad"])
@pytest.mark.parametrize("name", MODELS)
def test_count_flops_equals_jax(bridged, name, what):
    jm, params, tm, x, y, loss = bridged[name]
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    if what == "forward":
        want = jobs.count_flops(lambda p, a: jm.apply({"params": p}, a),
                                params, x)
        got = tobs.count_flops(lambda: tm(tx))
    else:
        jgrad = jengine.make_grad_fn(jm, loss)
        want = jobs.count_flops(lambda p, b: jgrad(p, b, None), params,
                                {"features": x, "labels": y})
        tgrad = tengine.make_grad_fn(tm, loss)
        got = tobs.count_flops(lambda: tgrad({"features": tx,
                                              "labels": ty}))
    assert want > 0
    assert got == pytest.approx(want, rel=1e-9)


def _plain_count(fn, *args):
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return counter.get_total_flops()


def _attn(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 128, 2, 16), (2, 256, 1, 32)])
def test_flash_formulas_equal_the_plain_versions_counts(shape, causal):
    q, k, v, dout = _attn(shape)
    assert _plain_count(fa.flash_attention_reference, q, k, v, causal) == \
        fa.flash_flops("flash_attention_fwd", shape)
    out, lse = fa.flash_attention_reference(q, k, v, causal)
    delta = fa.flash_attention_delta(out, dout)
    assert _plain_count(fa.flash_attention_bwd_dq_reference, q, k, v, dout,
                        lse, delta, causal) == \
        fa.flash_flops("flash_attention_bwd_dq", shape)
    assert _plain_count(fa.flash_attention_bwd_dkv_reference, q, k, v, dout,
                        lse, delta, causal) == \
        fa.flash_flops("flash_attention_bwd_dkv", shape)
    # the JAX convention: a causal call counts the whole square
    assert fa.flash_flops("flash_attention_fwd", shape) == \
        4 * shape[0] * shape[2] * shape[1] ** 2 * shape[3]


@pytest.mark.parametrize("b,t,h,d,pages,pmax", [(1, 2, 2, 16, 4, 8),
                                                (3, 5, 1, 32, 8, 4)])
def test_paged_formula_equals_the_plain_versions_count(b, t, h, d, pages,
                                                       pmax):
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (b * pmax + 1, pages, h, d)).astype(np.float32)) for _ in range(2))
    table = torch.from_numpy(rng.permutation(b * pmax + 1)[:b * pmax]
                             .reshape(b, pmax).astype(np.int32))
    ci = torch.from_numpy(rng.integers(0, pmax * pages - t + 1, b).astype(
        np.int32))
    assert _plain_count(fa.paged_flash_attention_reference, q, kp, vp,
                        table, ci) == fa.paged_flops(q.shape, pmax * pages)
    assert tobs.count_flops(fa.paged_flash_attention, q, kp, vp, table,
                            ci) == fa.paged_flops(q.shape, pmax * pages)


@pytest.mark.parametrize("m,n,k", [(16, 32, 64), (33, 8, 48)])
def test_int8_and_groupnorm_formulas_equal_the_plain_versions_counts(m, n,
                                                                     k):
    rng = np.random.default_rng(2)
    qx = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    s = torch.tensor([0.25])
    assert _plain_count(i8.int8_matmul_dequant_reference, qx, qw, s) == \
        accounting.matmul_flops(m, n, k)
    # torch's registry has no _int_mm formula: the port adds one
    a = qx[:32] if m >= 32 else torch.cat([qx, qx])[:32]
    b = qw.t().contiguous()
    assert tobs.count_flops(lambda: torch._int_mm(a, b)) == \
        accounting.matmul_flops(a.shape[0], b.shape[1], k)
    x = torch.from_numpy(rng.standard_normal((2, m, 32)).astype(np.float32))
    gamma, beta = torch.ones(32), torch.zeros(32)
    y, stats = gn.group_norm_fwd_reference(x, gamma, beta, 8)
    assert _plain_count(gn.group_norm_fwd_reference, x, gamma, beta, 8) == 0
    assert _plain_count(gn.group_norm_bwd_reference, x, gamma, stats, y,
                        8) == 0


def test_cpu_wrappers_report_no_kernel_launch():
    q, k, v, _ = _attn((1, 128, 1, 16))
    calls = []
    with accounting.listen(calls.append):
        fa.flash_attention(q, k, v)
    assert calls == []


@pytest.mark.parametrize("name,bf16,f32,int8", [
    ("NVIDIA H100 80GB HBM3", 989e12, 67e12, 1979e12),
    ("NVIDIA H100 PCIe", 756e12, 51e12, 1513e12),
    ("NVIDIA H100 NVL", 835.5e12, 60e12, 1670.5e12),
    ("NVIDIA A100-SXM4-80GB", None, None, None)])
def test_peak_lookup_by_device_name(monkeypatch, name, bf16, f32, int8):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert tobs.device_peak_flops("cuda:0") == bf16
    assert tobs.device_peak_flops("cuda:0", dtype="f32") == f32
    assert tobs.device_peak_flops("cuda:0", "int8") == int8
    with pytest.raises(ValueError, match="dtype"):
        tobs.device_peak_flops("cuda:0", dtype="fp4")


def test_no_card_no_peak_no_calibration():
    assert tobs.device_peak_flops("cpu") is None
    if not torch.cuda.is_available():
        assert tobs.device_peak_flops() is None
        assert tobs.calibrate_peak() is None
    assert tobs.calibrate_peak(device="cpu") is None
    assert tobs.mfu(1e12, 1.0) is None or torch.cuda.is_available()


def test_mfu_publishes_gauges():
    assert tobs.mfu(1e12, 1.0, peak_per_chip=4e12, dtype="int8") == 0.25
    gauges = telemetry.get_registry().snapshot()["gauges"]
    assert "observability.mfu{dtype=int8}" in gauges
    assert tobs.mfu(0, 1.0, peak_per_chip=4e12) is None
    assert tobs.mfu(1e12, 0.0, peak_per_chip=4e12) is None


def test_step_timer_and_time_threaded_steps():
    timer = tobs.StepTimer()
    with timer.measure(0):
        pass
    assert timer.mean_step_s is None and timer.total_s >= 0

    def step(state, batch):
        return state + 1, torch.tensor(float(state)) * batch

    state, timer = tobs.time_threaded_steps(step, 0, 2.0, warmup=2, steps=5)
    assert state == 8 and timer.steps == 5 and timer.mean_step_s >= 0


def test_compiled_probes_decline_without_a_graph(monkeypatch):
    monkeypatch.setattr(tobs, "_cost_analysis_noted", False)
    counter = telemetry.counter("observability.cost_analysis_unavailable")
    before = counter.value
    assert tobs.compiled_flops(object()) is None
    assert tobs.compiled_memory_bytes(object()) is None
    assert counter.value == before + 1

    class Recorded:
        flops = 123.0

    assert tobs.compiled_flops(Recorded()) == 123.0


def test_profiler_trace_writes_a_trace(tmp_path):
    with tobs.profiler_trace(str(tmp_path)):
        torch.ones(4).sum()
    assert any(p.name.endswith(".json") for p in tmp_path.iterdir())
