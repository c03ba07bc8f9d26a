"""BASELINE config runners (port of ``distkeras_tpu/benchmarks/run_config.py``):
one JSON line a config, through the port's public trainers.

  1 mnist-mlp-adag       MLP, ADAG single-worker
  2 cifar-cnn-downpour   CIFARConvNet, DOWNPOUR
  3 resnet50-aeasgd      ResNet-50 (norm-free), AEASGD elastic averaging
  4 bert-dynsgd          BERT MLM, DynSGD
  5 vit-pjit             ViT, PjitTrainer

Usage::

    python -m distkeras_tpu_torch.benchmarks <1-5|all> [--full] [--marginal]
                                             [--device cpu]

The runs go on the card: configs 2 and 4 on ``min(4, cards)`` workers and
5 on ``min(8, cards)``, one card a worker, as the JAX runner takes
``jax.devices()``; 1 and 3 on ``cuda:0``. Without a card they fail (an
``error`` line,
exit code 1) unless ``--device cpu`` names the host, which only the
smoke shapes use (``--full`` is the card's benchmark scale). A line
holds samples/s, steps, wall seconds and the final loss and, on a card
the peak table knows, MFU against its bf16 peak; ``--marginal`` adds the
staging-cancelled per-epoch throughput (the walls at E and 2E epochs,
differenced). Each config trains once to warm up, then once timed; the
line's ``first_loss`` and ``final_loss`` are the timed run's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _flops_per_step(trainer, ds):
    """Analytic matmul/conv FLOPs of ONE worker's local step (forward and
    backward, ``engine.make_grad_fn``) on a batch of the dataset, counted
    on the device the trained model sits on. None when the count fails
    (an exotic loss)."""
    from distkeras_tpu_torch import engine, observability

    try:
        n = trainer.batch_size
        device = next(trainer.model.parameters()).device
        batch = engine.to_device(
            {"features": np.array(ds[trainer.features_col][:n]),
             "labels": np.array(ds[trainer.label_col][:n])}, device)
        grad_fn = engine.make_grad_fn(trainer.model, trainer.loss)
        return observability.count_flops(lambda: grad_fn(batch))
    except (RuntimeError, ValueError, TypeError, KeyError):
        return None


def _device(trainer) -> torch.device:
    mesh = getattr(trainer, "mesh", None)
    return mesh.home if mesh is not None else trainer._device


def _num_cards(trainer) -> int:
    """The distinct devices a trainer's mesh runs on (a mesh may repeat
    one card; JAX's ``_num_chips`` counts the mesh's devices)."""
    mesh = getattr(trainer, "mesh", None)
    if mesh is None:
        return 1
    return len({str(d) for row in mesh.grid for d in row})


def _workers(device, most: int = 4) -> int:
    """The JAX runner's ``min(most, len(jax.devices()))``: every visible
    card up to ``most`` on the card, one worker on a named device."""
    from distkeras_tpu_torch.device import visible_devices

    return 1 if device is not None else min(most, len(visible_devices()))


def _time_trainer(trainer, ds, marginal: bool = False) -> dict:
    """Two runs: one to warm up (and move the model to the card), one
    timed, so samples/s and MFU measure the steady state. ``marginal``
    also times 2E epochs and differences the walls (staging and the
    first-call costs cancel); the reported figures are the E-epoch run's.
    """
    from distkeras_tpu_torch import observability

    trainer.train(ds)  # warm-up
    flops_step = _flops_per_step(trainer, ds)
    t0 = time.perf_counter()
    trainer.train(ds)
    dt = time.perf_counter() - t0
    n_steps = len(trainer.get_history())
    first_loss = trainer.get_history()[0]["loss"]
    final_loss = trainer.get_history()[-1]["loss"]
    marg = None
    if marginal:
        base_epochs = trainer.num_epoch
        try:
            trainer.num_epoch = 2 * base_epochs
            t1 = time.perf_counter()
            trainer.train(ds)
            dt2 = time.perf_counter() - t1
            if dt2 > dt:  # otherwise fixed costs swamped the epochs
                marg = (dt2 - dt, len(trainer.get_history()) - n_steps)
        finally:
            trainer.num_epoch = base_epochs
    # the zoo's batch_size is per worker; history is per worker-averaged
    # step
    workers = getattr(trainer, "num_workers", 1)
    samples = n_steps * trainer.batch_size * workers
    device = _device(trainer)
    out = {"samples_per_sec": round(samples / dt, 2),
           "steps": n_steps, "wall_s": round(dt, 2),
           "first_loss": round(first_loss, 4),
           "final_loss": round(final_loss, 4),
           "device": observability.device_name(device) or str(device)}
    peak = observability.device_peak_flops(device)
    if peak:
        peak *= _num_cards(trainer)
    if flops_step and peak:
        out["mfu"] = round(flops_step * n_steps * workers / (dt * peak), 4)
    if marg is not None:
        mdt, msteps = marg
        out["marginal_samples_per_sec"] = round(
            msteps * trainer.batch_size * workers / mdt, 2)
        if flops_step and peak:
            out["marginal_mfu"] = round(
                flops_step * msteps * workers / (mdt * peak), 4)
    return out


def _images(n, side, classes, full, seed=0):
    """Seeded images (uint8 at full scale: the model normalizes on the
    device; float32 in smoke mode) and one-hot labels."""
    from distkeras_tpu_torch.data.dataset import Dataset

    rng = np.random.default_rng(seed)
    x = np.frombuffer(rng.bytes(n * side * side * 3), np.uint8).reshape(
        n, side, side, 3) if full else rng.standard_normal(
        (n, side, side, 3)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return Dataset.from_arrays(features=x, label=y)


def config_1(full, marginal=False, device=None):
    from distkeras_tpu_torch import ADAG, synthetic_mnist
    from distkeras_tpu_torch.models import mnist_mlp

    n = 16384 if full else 2048
    torch.manual_seed(0)
    t = ADAG(mnist_mlp(), worker_optimizer="momentum", learning_rate=0.05,
             num_workers=1, batch_size=128, communication_window=8,
             num_epoch=3 if full else 1, device=device)
    return _time_trainer(t, synthetic_mnist(n=n), marginal)


def config_2(full, marginal=False, device=None):
    from distkeras_tpu_torch import DOWNPOUR
    from distkeras_tpu_torch.models import cifar10_cnn

    n = 8192 if full else 1024
    torch.manual_seed(0)
    # smoke mode narrows the CNN, as the JAX runner does
    model = (cifar10_cnn(dtype=torch.bfloat16) if full
             else cifar10_cnn(channels=(8, 16), dense_width=64))
    t = DOWNPOUR(model, worker_optimizer="adam", learning_rate=1e-3,
                 num_workers=_workers(device), batch_size=64, communication_window=4,
                 num_epoch=4 if full else 1, device=device)
    return _time_trainer(t, _images(n, 32, 10, full), marginal)


def config_3(full, marginal=False, device=None):
    from distkeras_tpu_torch import AEASGD
    from distkeras_tpu_torch.models.resnet import (BasicBlock, ResNet,
                                                   init_params, resnet50)

    side, n, bs = (224, 2048, 128) if full else (32, 256, 16)
    classes = 1000 if full else 10
    model = resnet50(norm="nf") if full else ResNet(
        stage_sizes=(1, 1), block=BasicBlock, width=8, num_classes=10,
        dtype=torch.float32, norm="nf")
    init_params(model, torch.Generator().manual_seed(0))
    t = AEASGD(model, rho=1.0, worker_optimizer="sgd", learning_rate=0.05,
               num_workers=1, batch_size=bs, communication_window=8,
               num_epoch=12 if full else 1, metrics=(), device=device)
    return _time_trainer(t, _images(n, side, classes, full), marginal)


def config_4(full, marginal=False, device=None):
    from distkeras_tpu_torch import DynSGD
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.models.bert import (bert_base, bert_tiny,
                                                 init_params)

    model = bert_base() if full else bert_tiny()
    init_params(model, torch.Generator().manual_seed(0))
    seq = 128 if full else 32
    n = 2048 if full else 512
    rng = np.random.default_rng(0)
    # int16 token staging (BERT's vocab fits): the model casts on the device
    dt = np.int16 if model.vocab_size < 2 ** 15 else np.int32
    ids = rng.integers(1, model.vocab_size, (n, seq)).astype(dt)
    labels = np.where(rng.random((n, seq)) < 0.15, ids, -1).astype(dt)
    t = DynSGD(model, loss="masked_lm", metrics=(),
               worker_optimizer="adam", learning_rate=1e-4,
               num_workers=_workers(device),
               batch_size=32 if full else 16, communication_window=2,
               num_epoch=3 if full else 1, device=device)
    return _time_trainer(t, Dataset.from_arrays(features=ids, label=labels),
                         marginal)


def config_5(full, marginal=False, device=None):
    from distkeras_tpu_torch import PjitTrainer
    from distkeras_tpu_torch.models.vit import (init_params, vit_base,
                                                vit_tiny)

    model = vit_base() if full else vit_tiny()
    init_params(model, torch.Generator().manual_seed(0))
    side = 224 if full else 16
    classes = 1000 if full else 10
    # n=512 in both modes, batch 64, as the JAX runner; full mode stages
    # uint8 (ViT normalizes on the device)
    n, bs = 512, 64
    t = PjitTrainer(model, worker_optimizer="adamw", learning_rate=1e-3,
                    num_workers=_workers(device, 8), batch_size=bs,
                    num_epoch=8 if full else 1, metrics=(), device=device)
    return _time_trainer(t, _images(n, side, classes, full), marginal)


CONFIGS = {
    "1": ("mnist-mlp-adag", config_1),
    "2": ("cifar-cnn-downpour", config_2),
    "3": ("resnet50-aeasgd", config_3),
    "4": ("bert-dynsgd", config_4),
    "5": ("vit-pjit", config_5),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m distkeras_tpu_torch.benchmarks")
    ap.add_argument("which", choices=list(CONFIGS) + ["all"])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--marginal", action="store_true",
                    help="also report staging-cancelled per-epoch throughput")
    ap.add_argument("--device", default=None,
                    help="cpu runs the smoke shapes on the host (one "
                         "worker); default the visible cards")
    args = ap.parse_args(argv)
    if args.full and args.device is not None \
            and torch.device(args.device).type == "cpu":
        ap.error("--full is the card's scale; --device cpu runs the smoke "
                 "shapes only")
    keys = list(CONFIGS) if args.which == "all" else [args.which]
    failed = False
    for k in keys:
        name, fn = CONFIGS[k]
        mode = "full" if args.full else "smoke"
        try:
            result = fn(args.full, args.marginal, device=args.device)
            print(json.dumps({"config": k, "name": name, "mode": mode,
                              **result}), flush=True)
        except Exception as e:  # one config's failure is its line
            failed = True
            print(json.dumps({"config": k, "name": name, "mode": mode,
                              "error": f"{type(e).__name__}: {e}"}),
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
