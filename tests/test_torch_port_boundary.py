"""What the PyTorch port promises at its boundary.

- Entry points run on the card by default: ``device=None`` resolves to
  ``cuda:0`` and, with no CUDA device, raises instead of running on the
  CPU.
- The port imports neither JAX/flax nor anything of ``distkeras_tpu``:
  checked by importing it in a fresh interpreter, and by scanning the
  package's and ``chip_smoke.py``'s import statements.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from distkeras_tpu_torch import observability, precision
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.serving import (GenerationEngine, KVCachePool,
                                         PagedKVCachePool)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "distkeras_tpu")


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_raises_without_one(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("build", [
    lambda m: PagedKVCachePool(m, 2, page_size=16),
    lambda m: GenerationEngine(m, num_slots=2, prefill_buckets=(16,),
                               page_size=16),
    lambda m: KVCachePool(m, 2),
    lambda m: GenerationEngine(m, num_slots=2, prefill_buckets=(16,)),
])
def test_entry_points_do_not_fall_back_to_cpu(monkeypatch, build):
    _no_cuda(monkeypatch)
    model = tgpt.gpt_tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(model)
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_hbm_stats_is_none_on_cpu_and_precision_policies():
    assert observability.hbm_stats(torch.device("cpu")) is None
    assert observability.hbm_stats(None) is None
    assert precision.resolve(None, torch.float32) == torch.float32
    assert precision.resolve("bf16", torch.float32) == torch.bfloat16
    assert precision.resolve("f32", torch.bfloat16) == torch.float32
    assert precision.resolve("int8", torch.float32) == torch.bfloat16
    assert precision.resolve("fp8-sim", torch.float32) == torch.bfloat16
    with pytest.raises(ValueError):
        precision.resolve("fp64", torch.float32)


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = ("import sys\n"
            "import distkeras_tpu_torch\n"
            "import distkeras_tpu_torch.serving\n"
            "import distkeras_tpu_torch.utils.bridge\n"
            "import distkeras_tpu_torch.engine\n"
            "import distkeras_tpu_torch.ops.kernels.flash_attention\n"
            "import distkeras_tpu_torch.models\n"
            "import distkeras_tpu_torch.precision\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _port_sources():
    root = os.path.join(REPO, "distkeras_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")
    for script in ("ab_driver.py", "groupnorm_ab.py", "int8_ab.py",
                   "serving_ab.py"):
        yield os.path.join(REPO, script)


def test_no_forbidden_import_statement_in_port_or_chip_smoke():
    sources = list(_port_sources())
    assert len(sources) >= 15
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
