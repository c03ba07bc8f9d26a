"""What the PyTorch port promises at its boundary.

- Entry points run on the card by default: ``device=None`` resolves to
  ``cuda:0`` and, with no CUDA device, raises instead of running on the
  CPU, with every option on (int8 KV pages, the prefix cache,
  speculative decoding with either draft), and so does the one-shot
  ``ServingEngine``.
- The port imports neither JAX/flax/ml_dtypes nor anything of
  ``distkeras_tpu``: checked by importing it in a fresh interpreter, and
  by scanning the package's, ``chip_smoke.py``'s and
  ``bench_torch.py``'s import statements.
- The measurement plane measures nothing on the CPU as if it were the
  card: with no card, the capture and the calibration decline, and the
  runners and ``bench_torch.py`` refuse unless asked for the host.
- The encoder families likewise: trainers over ``bert_base()``,
  ``vit_base()`` and ``MoEClassifier`` resolve to ``cuda:0`` and raise
  without a card, leaving the model on the host.
- The true-async plane likewise: ``HostAsyncRunner``, the five exchanging
  trainers in ``mode="host_async"`` (also with each lossy codec),
  ``WeightPublisher(ps=...)`` and the staleness twin resolve to
  ``cuda:0``, raise without a card, and run on the host with
  ``device="cpu"``.
- The one-process mesh likewise: ``PjitTrainer`` (by default, and over a
  mesh of cards), ``ServingEngine(mesh=...)`` and
  ``ModelPredictor(mesh=...)`` raise without a card and run on the host
  with ``device="cpu"`` or a CPU mesh.
- The multi-process plane calls no pickling ``*_object`` collective.
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
                                         ModelDraft, NgramDraft,
                                         PagedKVCachePool, ServingEngine)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
             "distkeras_tpu")


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
    lambda m: PagedKVCachePool(m, 2, page_size=16, kv_dtype="int8"),
    lambda m: GenerationEngine(m, num_slots=2, prefill_buckets=(16,),
                               page_size=16, kv_dtype="int8"),
    lambda m: GenerationEngine(m, num_slots=2, prefill_buckets=(16,),
                               page_size=16, prefix_cache_bytes=1 << 20),
    lambda m: GenerationEngine(m, num_slots=2, prefill_buckets=(16,),
                               draft=NgramDraft(), spec_k=2),
    lambda m: GenerationEngine(m, num_slots=2, prefill_buckets=(16,),
                               page_size=16, spec_k=2,
                               draft=ModelDraft(tgpt.gpt_tiny())),
])
def test_entry_points_do_not_fall_back_to_cpu(monkeypatch, build):
    _no_cuda(monkeypatch)
    model = tgpt.gpt_tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(model)
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_serving_engine_does_not_fall_back_to_cpu(monkeypatch):
    """The one-shot engine resolves ``device=None`` to the card and raises
    without one, before touching the model; ``device="cpu"`` serves."""
    _no_cuda(monkeypatch)
    model = tgpt.gpt_tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, (16,), input_dtype="int32", buckets=(1,))
    assert all(p.device.type == "cpu" for p in model.parameters())
    with ServingEngine(model, (16,), input_dtype="int32", buckets=(1,),
                       device="cpu") as eng:
        assert eng.submit([1] * 16).result(timeout=60).shape == (16, 256)


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


def test_trainers_do_not_fall_back_to_cpu(monkeypatch):
    """A trainer or a predictor resolves its mesh (or its device) to the
    card and raises without one; ``device="cpu"`` or a CPU mesh runs on
    the host."""
    from distkeras_tpu_torch import (ADAG, AveragingTrainer, ModelClassifier,
                                     ModelPredictor, SingleTrainer)
    from distkeras_tpu_torch.models import MLP
    from distkeras_tpu_torch.parallel import mesh as mesh_lib

    _no_cuda(monkeypatch)
    for build in (lambda: ADAG(MLP(features=(4,))),
                  lambda: AveragingTrainer(MLP(features=(4,)),
                                           parallelism_factor=2),
                  lambda: SingleTrainer(MLP(features=(4,))),
                  lambda: mesh_lib.make_mesh(1),
                  lambda: ModelClassifier(MLP(features=(4,))),
                  lambda: ModelPredictor(MLP(features=(4,)),
                                         MLP(features=(4,)).state_dict())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert ADAG(MLP(features=(4,)), device="cpu").mesh.home.type == "cpu"
    mesh = mesh_lib.make_mesh(devices=["cpu", "cpu"])
    assert ADAG(MLP(features=(4,)), mesh=mesh).num_workers == 2
    for kw in (dict(device="cpu"), dict(mesh=mesh_lib.make_mesh(
            devices=["cpu"]))):
        assert ModelClassifier(MLP(features=(4,)), **kw).device.type == "cpu"


@pytest.mark.parametrize("family", ["bert_base", "vit_base", "moe"])
def test_encoder_trainers_do_not_fall_back_to_cpu(monkeypatch, family):
    from distkeras_tpu_torch import DynSGD, SingleTrainer
    from distkeras_tpu_torch.models import MoEClassifier, bert_base, vit_base

    _no_cuda(monkeypatch)
    model = {"bert_base": bert_base, "vit_base": vit_base,
             "moe": lambda: MoEClassifier(8, num_layers=4, num_heads=12,
                                          num_experts=8, mlp_dim=3072,
                                          attention="flash",
                                          width=768)}[family]()
    for trainer in (DynSGD, SingleTrainer):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trainer(model, loss="masked_lm")
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_mesh_paths_do_not_fall_back_to_cpu(monkeypatch):
    from distkeras_tpu_torch import ModelPredictor, PjitTrainer
    from distkeras_tpu_torch.models import MLP
    from distkeras_tpu_torch.parallel import pipeline, sequence
    from distkeras_tpu_torch.parallel.mesh import Mesh

    _no_cuda(monkeypatch)
    cards = Mesh(["cuda:0"] * 2)
    lm = dict(vocab_size=16, max_len=8, num_layers=2, num_heads=1, width=4,
              mlp_dim=8, num_stages=2)
    for build in (lambda: sequence.make_sp_mesh(),
                  lambda: sequence.make_sp_mesh(1, 2, devices=["cuda:0"] * 2),
                  lambda: pipeline.make_pp_mesh(1),
                  lambda: pipeline.PipelinedLM(**lm),
                  lambda: pipeline.GenericPipeline(
                      [MLP(features=(4,)), MLP(features=(4,))], 2),
                  lambda: PjitTrainer(MLP(features=(4,))),
                  lambda: PjitTrainer(MLP(features=(4,)), mesh=Mesh(
                      ["cuda:0"] * 2, model_parallelism=2)),
                  lambda: ServingEngine(MLP(features=(4,), in_features=8),
                                        (8,), buckets=(2,), mesh=cards),
                  lambda: ModelPredictor(MLP(features=(4,)), mesh=cards)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert PjitTrainer(MLP(features=(4,)), device="cpu", num_workers=2,
                       model_parallelism=2).mesh.shape == {"workers": 2,
                                                           "model": 2}
    host = Mesh(["cpu"] * 2)
    assert ModelPredictor(MLP(features=(4,)), mesh=host).device.type == "cpu"
    assert sequence.make_sp_mesh(1, 2, devices=["cpu"] * 2).home.type \
        == "cpu"
    assert pipeline.make_pp_mesh(2, devices=["cpu"] * 2).shape == {
        "workers": 1, "stages": 2}
    assert next(pipeline.PipelinedLM(**lm, device="cpu").parameters()) \
        .device.type == "cpu"
    with ServingEngine(MLP(features=(4,), in_features=8), (8,),
                       buckets=(2,), mesh=host) as eng:
        assert [d.type for d in eng.devices] == ["cpu", "cpu"]


def _async_builds():
    from distkeras_tpu_torch import trainers
    from distkeras_tpu_torch.benchmarks import staleness_tradeoff
    from distkeras_tpu_torch.models import MLP
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.parallel import host_async, strategies
    from distkeras_tpu_torch.parameter_servers import DeltaParameterServer
    from distkeras_tpu_torch.serving.rollout import WeightPublisher

    def trainer(name, **kw):
        return lambda **place: getattr(trainers, name)(
            MLP(features=(4,)), mode="host_async", num_workers=2, **kw,
            **place)

    builds = {name: trainer(name) for name in
              ("DOWNPOUR", "ADAG", "DynSGD", "AEASGD", "EAMSGD")}
    builds.update({f"ADAG-{c}": trainer("ADAG", codec=c)
                   for c in ("f16", "bf16", "int8")})
    builds["HostAsyncRunner"] = lambda **place: host_async.HostAsyncRunner(
        MLP(features=(4,)), "categorical_crossentropy",
        optimizers.get("sgd", 0.1), strategies.get("adag"), 2, **place)
    builds["WeightPublisher"] = lambda **place: WeightPublisher(
        ps=DeltaParameterServer({"w": torch.zeros(2)}), **place)
    builds["staleness_tradeoff"] = lambda **place: staleness_tradeoff.sweep(
        strategies=["adag"], windows=[1], workers=[2], modes=["host_async"],
        n_train=128, n_heldout=32, batch_size=16, epochs=1, **place)
    return builds


@pytest.mark.parametrize("name", sorted(_async_builds()))
def test_async_plane_does_not_fall_back_to_cpu(monkeypatch, name):
    build = _async_builds()[name]
    with monkeypatch.context() as m:
        _no_cuda(m)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    built = build(device="cpu")
    devices = getattr(built, "devices", None) or [getattr(
        built, "device", None)]
    if isinstance(built, dict):  # the twin's result
        devices = [torch.device(built["protocol"]["platform"])]
    assert [torch.device(d).type for d in devices] == ["cpu"] * len(devices)


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = ("import sys\n"
            "import distkeras_tpu_torch\n"
            "import distkeras_tpu_torch.serving\n"
            "import distkeras_tpu_torch.serving.kv_cache\n"
            "import distkeras_tpu_torch.utils.bridge\n"
            "import distkeras_tpu_torch.engine\n"
            "import distkeras_tpu_torch.ops.kernels.flash_attention\n"
            "import distkeras_tpu_torch.models\n"
            "import distkeras_tpu_torch.models.bert\n"
            "import distkeras_tpu_torch.models.vit\n"
            "import distkeras_tpu_torch.models.moe\n"
            "import distkeras_tpu_torch.models.remat\n"
            "import distkeras_tpu_torch.models.aux_losses\n"
            "import distkeras_tpu_torch.models.transformer\n"
            "import distkeras_tpu_torch.ops.attention\n"
            "import distkeras_tpu_torch.benchmarks.run_config\n"
            "import distkeras_tpu_torch.precision\n"
            "import distkeras_tpu_torch.serving.engine\n"
            "import distkeras_tpu_torch.serving.rollout\n"
            "import distkeras_tpu_torch.serving.server\n"
            "import distkeras_tpu_torch.parallel.remote_ps\n"
            "import distkeras_tpu_torch.comms.retry\n"
            "import distkeras_tpu_torch.utils.fault\n"
            "import distkeras_tpu_torch.health.recorder\n"
            "import distkeras_tpu_torch.health.endpoints\n"
            "import distkeras_tpu_torch.health\n"
            "import distkeras_tpu_torch.health.cli\n"
            "import distkeras_tpu_torch.health.collector\n"
            "import distkeras_tpu_torch.health.timeseries\n"
            "import distkeras_tpu_torch.serving.fleet\n"
            "import distkeras_tpu_torch.predictors\n"
            "import distkeras_tpu_torch.evaluators\n"
            "import distkeras_tpu_torch.trainers\n"
            "import distkeras_tpu_torch.parallel.substrate\n"
            "import distkeras_tpu_torch.parallel.strategies\n"
            "import distkeras_tpu_torch.parallel.mesh\n"
            "import distkeras_tpu_torch.parameter_servers\n"
            "import distkeras_tpu_torch.data\n"
            "import distkeras_tpu_torch.transformers\n"
            "import distkeras_tpu_torch.utils.rng\n"
            "import distkeras_tpu_torch.observability\n"
            "import distkeras_tpu_torch.profiling\n"
            "import distkeras_tpu_torch.checkpoint\n"
            "import distkeras_tpu_torch.utils.serialization\n"
            "import distkeras_tpu_torch.benchmarks\n"
            "import distkeras_tpu_torch.benchmarks.staleness_tradeoff\n"
            "import distkeras_tpu_torch.comms\n"
            "import distkeras_tpu_torch.comms.codec\n"
            "import distkeras_tpu_torch.parallel.host_async\n"
            "import distkeras_tpu_torch.parallel.elastic\n"
            "import distkeras_tpu_torch.parallel.failover\n"
            "import distkeras_tpu_torch.utils.transfer\n"
            "import distkeras_tpu_torch.parallel.collectives\n"
            "import distkeras_tpu_torch.parallel.tensor\n"
            "import distkeras_tpu_torch.parallel.distributed\n"
            "import distkeras_tpu_torch.data.native\n"
            "import distkeras_tpu_torch.utils.compat\n"
            "import distkeras_tpu_torch.job_deployment\n"
            "from distkeras_tpu_torch import (PjitTrainer, Job, Punchcard,"
            " LocalLauncher)\n"
            "from distkeras_tpu_torch.models.moe import EP_RULES\n"
            "import bench_torch\n"
            "from distkeras_tpu_torch import (ADAG, DOWNPOUR, DynSGD, AEASGD,"
            " EAMSGD, AveragingTrainer, EnsembleTrainer, SingleTrainer,"
            " Pipeline, MinMaxTransformer, OneHotTransformer,"
            " ModelClassifier, AccuracyEvaluator, synthetic_mnist,"
            " Dataset)\n"
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
    yield os.path.join(REPO, "bench_torch.py")
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


def test_no_pickling_collective_in_port_or_chip_smoke():
    """The multi-process plane moves numpy payloads as tensors: no
    ``torch.distributed`` ``*_object`` collective (they pickle, and
    nothing on a wire may execute code) is called or named."""
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            name = node.attr if isinstance(node, ast.Attribute) else \
                node.id if isinstance(node, ast.Name) else ""
            assert not name.endswith("_object") and \
                not name.endswith("_object_list"), (path, name)


def test_measurement_plane_does_not_measure_the_cpu_without_a_card(
        monkeypatch, capsys):
    """With no card: the capture returns ``available=False`` without
    running the step, the calibration returns None, a runner prints an
    error line and exits 1, and ``bench_torch.py`` exits 1 with no
    result; each measures the host only when asked with ``--device cpu``
    (the runners' smoke shapes, ``bench_torch.py --tiny``)."""
    from distkeras_tpu_torch.benchmarks import run_config
    from distkeras_tpu_torch.profiling import capture_op_times

    sys.path.insert(0, REPO)
    import bench_torch

    _no_cuda(monkeypatch)
    ran = []
    assert not capture_op_times(lambda: ran.append(1)).available
    assert ran == []
    assert observability.calibrate_peak() is None
    assert observability.device_peak_flops() is None
    assert run_config.main(["3"]) == 1
    assert '"error"' in capsys.readouterr().out
    assert bench_torch.main([]) == 1
    assert capsys.readouterr().out == ""
