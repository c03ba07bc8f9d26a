"""The encoder families on a card: the non-causal flash kernels inside
``MultiHeadAttention`` and the MoE classifier, BERT-base's int8 products,
and remat's second forward launch.

Skipped without a CUDA device. This file imports no JAX, so it runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_encoders_cuda.py

Bounds (TF32 off): a layer through the flash kernels against the same
layer through the plain attention, float32 within 1e-4 * max(1,
max|ref|) (phase 7's per-kernel 1e-5 grows through the out projection),
bf16 within 2e-2 * max|ref|; the int8 products bitwise to their plain
version, as everywhere; remat's loss bitwise to ``"none"`` (the same
kernels on the same inputs) and its bf16 gradients within 2e-2 *
max|ref| (cuBLAS and the embedding's backward may sum in another order
on a second run).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import engine
from distkeras_tpu_torch.models.bert import bert_base
from distkeras_tpu_torch.models.gpt import CausalLM, init_params
from distkeras_tpu_torch.models.moe import MoEClassifier
from distkeras_tpu_torch.models.transformer import init_params as enc_init
from distkeras_tpu_torch.ops.attention import MultiHeadAttention
from distkeras_tpu_torch.ops.kernels import flash_attention as tfa
from distkeras_tpu_torch.ops.kernels import int8_matmul as tk

FLASH = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
         tfa.flash_attention_bwd_dkv)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    bound = 1e-4 * max(1.0, scale) if dtype == torch.float32 \
        else 2e-2 * scale
    assert err <= bound, (err, bound)


def _launches():
    return [f.launches for f in FLASH]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_flash_is_the_plain_attention_non_causally(cuda_device, dtype):
    """``MultiHeadAttention(attention="flash")`` at BERT-base's widths
    over 256 tokens: one forward launch, one dq and one dk/dv launch in
    the backward; output and every gradient against the same weights
    through ``attention="xla"``."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 256, 768)).astype(np.float32)).to(cuda_device, dtype)
    layers = {}
    for mode in ("flash", "xla"):
        torch.manual_seed(0)
        layers[mode] = MultiHeadAttention(768, 12, dtype=dtype,
                                          attention=mode).to(cuda_device)
    before = _launches()
    out = layers["flash"](x)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [1, 1, 1]
    ref = layers["xla"](x)
    ref.float().square().sum().backward()
    _close(out, ref, dtype)
    for (name, p), q in zip(layers["flash"].named_parameters(),
                            layers["xla"].parameters()):
        _close(p.grad, q.grad, dtype)


@pytest.mark.cuda
def test_moe_classifier_flash_against_xla(cuda_device):
    """A 2-layer MoE classifier at the smoke's widths (768, 12 heads, 8
    experts) on [4, 256, 768] bf16 features: logits through the kernels
    against the plain attention."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 256, 768)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    logits = {}
    for mode in ("flash", "xla"):
        model = MoEClassifier(8, num_layers=2, num_heads=12, num_experts=8,
                              mlp_dim=3072, attention=mode, width=768)
        enc_init(model, torch.Generator().manual_seed(0)).to(cuda_device)
        before = _launches()[0]
        with torch.no_grad():
            logits[mode] = model(x)
        launched = _launches()[0] - before
        assert launched == (2 if mode == "flash" else 0)
    assert torch.isfinite(logits["flash"]).all()
    _close(logits["flash"], logits["xla"], torch.bfloat16)


#: BERT-base's products at config 4's 32 x 128 tokens (qkv, out, fc1, fc2)
INT8_BERT_SHAPES = [(4096, 768, 2304), (4096, 768, 768), (4096, 768, 3072),
                    (4096, 3072, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", INT8_BERT_SHAPES)
def test_int8_kernel_at_bert_products(cuda_device, out_dtype, m, k, n):
    rng = np.random.default_rng(m + k + n)
    qx = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    sxw = torch.tensor(rng.uniform(1e-4, 1e-2), dtype=torch.float32)
    qx, qw, sxw = (t.to(cuda_device) for t in (qx, qw, sxw))
    got = tk.int8_matmul_dequant(qx, qw, sxw, out_dtype)
    want = tk.int8_matmul_dequant_reference(qx, qw, sxw, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_bert_int8_forward_equals_its_plain_product(cuda_device):
    """``bert_base(precision="int8")`` cut to 2 layers on 32 x 128 int16
    ids: 2 x 4 + 1 kernel launches, logits equal to the same forward
    through the plain int8 product."""
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        1, 30522, (32, 128)).astype(np.int16)).to(cuda_device)
    model = enc_init(bert_base(num_layers=2, precision="int8"),
                     torch.Generator().manual_seed(0)).to(cuda_device)
    before = tk.int8_matmul_dequant.launches
    with torch.no_grad():
        got = model(ids)
    torch.cuda.synchronize()
    assert tk.int8_matmul_dequant.launches - before == 9
    with mock.patch.object(tk, "int8_matmul_dequant",
                           tk.int8_matmul_dequant_reference), \
            torch.no_grad():
        want = model(ids)
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.cuda
def test_remat_blocks_launches_the_forward_twice(cuda_device):
    """A 2-layer flash CausalLM at gpt_small's widths on [2, 256]:
    ``remat="blocks"`` launches the forward kernel twice a layer a step
    and gives the loss of ``"none"`` bit for bit and its gradients."""
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        1, 50304, (2, 256))).to(cuda_device)
    batch = {"features": ids, "labels": ids}
    out = {}
    for policy in ("none", "blocks"):
        model = init_params(CausalLM(vocab_size=50304, max_len=256,
                                     num_layers=2, num_heads=12, width=768,
                                     attention="flash", remat=policy),
                            torch.Generator().manual_seed(0)).to(cuda_device)
        before = _launches()
        (loss, _), grads = engine.make_grad_fn(model, "masked_lm")(batch)
        torch.cuda.synchronize()
        out[policy] = (loss, grads,
                       [a - b for a, b in zip(_launches(), before)])
    assert out["none"][2] == [2, 2, 2] and out["blocks"][2] == [4, 2, 2]
    assert torch.equal(out["none"][0], out["blocks"][0])
    for k, g in out["blocks"][1].items():
        _close(g, out["none"][1][k], torch.bfloat16)
