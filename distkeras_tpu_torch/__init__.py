"""distkeras_tpu_torch — the PyTorch/CUDA port of ``distkeras_tpu``.

The JAX package stays the reference; this package re-implements it slice
by slice in PyTorch for NVIDIA Hopper (``sm_90a``), with hand-written
kernels where the JAX package wrote Pallas kernels for the TPU. It imports
``torch`` and never ``jax`` or anything of ``distkeras_tpu``.

dist-keras's own flow, preprocess -> train -> predict -> evaluate, with
the same names as the JAX package (only the placement differs)::

    from distkeras_tpu_torch import (ADAG, AccuracyEvaluator,
                                     MinMaxTransformer, ModelClassifier,
                                     OneHotTransformer, Pipeline,
                                     synthetic_mnist)
    from distkeras_tpu_torch.models import mnist_mlp

    ds = Pipeline([MinMaxTransformer(o_min=-1.0, o_max=1.0),
                   OneHotTransformer(10, input_col="label_index",
                                     output_col="label")]).transform(
        synthetic_mnist(n=8192))
    model = mnist_mlp()
    trainer = ADAG(model, worker_optimizer="momentum", learning_rate=0.3,
                   batch_size=64, num_epoch=3, num_workers=1,
                   parallelism_factor=4, communication_window=4)
    params = trainer.train(ds, shuffle=True)
    scored = ModelClassifier(model, params).predict(ds)
    acc = AccuracyEvaluator("prediction", "label_index").evaluate(scored)

Paged generative serving of a causal LM::

    from distkeras_tpu_torch.models.gpt import gpt_small, init_params
    from distkeras_tpu_torch.serving import GenerationEngine

    model = gpt_small()
    init_params(model, torch.Generator().manual_seed(0))
    with GenerationEngine(model, page_size=16, num_slots=8) as eng:
        result = eng.generate(prompt, max_new_tokens=32).result()

Data (x tensor) parallel training over a workers x model mesh, in one
process (BASELINE config 5's trainer)::

    from distkeras_tpu_torch import PjitTrainer
    from distkeras_tpu_torch.models import vit_base
    from distkeras_tpu_torch.parallel.mesh import Mesh

    trainer = PjitTrainer(vit_base(), worker_optimizer="adamw",
                          learning_rate=1e-3, batch_size=64,
                          mesh=Mesh(["cuda:0"] * 4, model_parallelism=2))

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``
(see :func:`distkeras_tpu_torch.device.resolve_device`).

Importing this package is light: the names below load their modules on
first use.
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "Dataset": "data.dataset", "synthetic_mnist": "data.dataset",
    "AccuracyEvaluator": "evaluators",
    "CanaryAgreementEvaluator": "evaluators", "Evaluator": "evaluators",
    "LossEvaluator": "evaluators",
    "ModelClassifier": "predictors", "ModelPredictor": "predictors",
    "Predictor": "predictors",
    "PRECISION_POLICIES": "precision", "PrecisionPolicy": "precision",
    "ServingEngine": "serving.engine",
    "DenseTransformer": "transformers",
    "LabelIndexTransformer": "transformers",
    "MinMaxTransformer": "transformers", "OneHotTransformer": "transformers",
    "Pipeline": "transformers", "ReshapeTransformer": "transformers",
    "Transformer": "transformers",
    "ADAG": "trainers", "AEASGD": "trainers", "DOWNPOUR": "trainers",
    "AveragingTrainer": "trainers", "DistributedTrainer": "trainers",
    "DynSGD": "trainers", "EAMSGD": "trainers",
    "EnsembleTrainer": "trainers", "PjitTrainer": "trainers",
    "SingleTrainer": "trainers", "Trainer": "trainers",
    "Job": "job_deployment", "LocalLauncher": "job_deployment",
    "Punchcard": "job_deployment",
    "telemetry": None,
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = _EXPORTS[name]
    if module is None:
        return importlib.import_module(f"{__name__}.{name}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
