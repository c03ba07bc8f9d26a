"""Benchmark: the port's flagship distributed training step on one card
(the PyTorch twin of ``bench.py``).

    python3 bench_torch.py                       # on cuda:0
    python3 bench_torch.py --tiny --device cpu   # a tiny check on the host

Runs the port's training machinery (the substrate's epoch function, the
ADAG strategy, one worker) on ``resnet50_nf()`` with seeded ImageNet-
shaped uint8 data resident on the card: sgd(0.05), batch 128, 224²,
window 16, 24 rounds (384 local steps a call), 1,000 classes. Earlier
lines name the card, its power limit and the configuration that ran; the
last line is ONE JSON object with ``bench.py``'s keys::

    {"metric": "resnet50_adag_samples_per_sec_per_chip", "value": N,
     "unit": "samples/sec/chip", "vs_baseline": MFU / 0.50, "mfu": ...,
     "calibration_ratio": ...}

MFU is the analytic FLOPs of the calls (``observability.count_flops`` of
one local step, forward and backward, times the steps) over the median
call's wall time against the card's bf16 peak. It is reported only when
``observability.calibrate_peak`` lands inside ``observability.CAL_BAND``.

Unlike ``bench.py`` it has no silent fallback: without a card it exits
non-zero (the tiny configuration runs on the host only when asked with
``--tiny --device cpu``), and it falls back to the smaller b=64
configuration only on ``torch.cuda.OutOfMemoryError``, saying so.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

METRIC = "resnet50_adag_samples_per_sec_per_chip"

CONFIGS = [dict(batch_size=128, image_side=224, window=16, rounds=24,
                num_classes=1000, tiny=False),
           dict(batch_size=64, image_side=224, window=8, rounds=24,
                num_classes=1000, tiny=False)]
TINY = dict(batch_size=8, image_side=32, window=2, rounds=2, num_classes=10,
            tiny=True)


def _data(device, rounds, window, batch_size, side, num_classes):
    """Seeded uint8 images and one-hot labels, ``(rounds, 1, window,
    batch, ...)``, made on the device (in bulk on the host for the CPU)."""
    shape = (rounds, 1, window, batch_size)
    if device.type == "cuda":
        gen = torch.Generator(device=device).manual_seed(0)
        feats = torch.randint(0, 256, shape + (side, side, 3),
                              dtype=torch.uint8, device=device,
                              generator=gen)
        idx = torch.randint(0, num_classes, shape, device=device,
                            generator=gen)
    else:
        rng = np.random.default_rng(0)
        feats = torch.from_numpy(np.frombuffer(
            rng.bytes(int(np.prod(shape)) * side * side * 3),
            np.uint8).reshape(shape + (side, side, 3)).copy())
        idx = torch.from_numpy(rng.integers(0, num_classes, shape))
    labels = torch.nn.functional.one_hot(idx, num_classes).float()
    return {"features": [feats], "labels": [labels]}


def build(batch_size: int, image_side: int, window: int, rounds: int,
          num_classes: int, tiny: bool, device=None) -> dict:
    """The benchmark's pieces on ``device`` (``cuda:0`` by default):
    ``epoch_fn``, ``center``, ``carries`` and the resident ``data`` of
    one call (``rounds`` rounds), and ``flops_per_call``, the analytic
    FLOPs of one call (``observability.count_flops`` of one local step's
    forward and backward on one batch, times the call's steps; the fold
    and the optimizer carry no products)."""
    from distkeras_tpu_torch import engine, observability
    from distkeras_tpu_torch.device import resolve_device
    from distkeras_tpu_torch.models.resnet import (BasicBlock, ResNet,
                                                   init_params, resnet50_nf)
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.parallel import mesh as mesh_lib
    from distkeras_tpu_torch.parallel import strategies, substrate

    device = resolve_device(device)
    if tiny:
        model = ResNet(stage_sizes=(1, 1), block=BasicBlock, width=8,
                       num_classes=num_classes, dtype=torch.float32,
                       norm="nf")
    else:
        model = resnet50_nf(num_classes=num_classes)
    init_params(model, torch.Generator().manual_seed(0))
    model.to(device)
    tx = optimizers.get("sgd", 0.05)
    strategy = strategies.get("adag", learning_rate=0.05)
    mesh = mesh_lib.Mesh([device])
    params = {n: p.detach() for n, p in model.named_parameters()}
    center, carries = substrate.init_center_and_carries(
        params, tx, strategy, mesh, 1)
    epoch_fn = substrate.build_epoch_fn(
        model, "categorical_crossentropy", tx, strategy, mesh,
        num_workers=1, window=window, metrics=())
    data = _data(device, rounds, window, batch_size, image_side,
                 num_classes)
    grad_fn = engine.make_grad_fn(model, "categorical_crossentropy")
    batch = {"features": data["features"][0][0, 0, 0],
             "labels": data["labels"][0][0, 0, 0]}
    flops_per_call = rounds * window * observability.count_flops(
        lambda: grad_fn(batch))
    return {"device": device, "epoch_fn": epoch_fn, "center": center,
            "carries": carries, "data": data, "rounds": rounds,
            "flops_per_call": flops_per_call}


def run(batch_size: int, image_side: int, window: int, rounds: int,
        num_classes: int, tiny: bool, device=None, warmup: int = 2,
        timed: int = 3) -> dict:
    """One configuration: ``warmup`` untimed epoch calls, then ``timed``
    calls (host clock, each ending in a sync); returns samples/s of the
    median call, its MFU (None off the card), the FLOPs a call and the
    call times."""
    from distkeras_tpu_torch import observability

    b = build(batch_size, image_side, window, rounds, num_classes, tiny,
              device)
    device, epoch_fn, data = b["device"], b["epoch_fn"], b["data"]
    center, carries = b["center"], b["carries"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    offset = 0
    for _ in range(warmup):
        center, carries, _ = epoch_fn(center, carries, data, offset)
        offset += rounds
    sync()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        center, carries, ms = epoch_fn(center, carries, data, offset)
        sync()
        times.append(time.perf_counter() - t0)
        offset += rounds
    loss = ms["loss"]
    if not bool(torch.isfinite(loss).all()):
        raise FloatingPointError(f"non-finite training loss: {loss}")
    step_time = statistics.median(times)
    sps = rounds * window * batch_size / step_time
    return {"samples_per_sec": sps, "call_s": times,
            "flops_per_call": b["flops_per_call"],
            "mfu": observability.mfu(b["flops_per_call"], step_time)
            if device.type == "cuda" else None}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else ""


def calibrated_mfu(mfu_val):
    """``(mfu or None, calibration ratio or None)``: the MFU is kept only
    when the calibration ran and landed inside ``CAL_BAND``."""
    from distkeras_tpu_torch import observability

    cal = observability.calibrate_peak()
    ratio = cal["ratio"] if cal else None
    band = observability.CAL_BAND
    if ratio is None:
        print("# calibration unavailable: refusing to report MFU",
              file=sys.stderr)
        return None, None
    if not band[0] <= ratio <= band[1]:
        print(f"# calibration ratio {ratio:.4f} outside {band}: refusing to "
              f"report MFU", file=sys.stderr)
        return None, ratio
    return mfu_val, ratio


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny configuration (a quick check)")
    ap.add_argument("--device", default=None,
                    help="cpu (with --tiny only); default cuda:0")
    args = ap.parse_args(argv)
    on_cpu = args.device is not None and torch.device(args.device).type \
        == "cpu"
    if on_cpu and not args.tiny:
        ap.error("--device cpu runs the tiny configuration only: pass "
                 "--tiny too")
    if not on_cpu and not torch.cuda.is_available():
        print("bench_torch: no CUDA device (torch.cuda.is_available() is "
              "False); pass --tiny --device cpu for the host check",
              file=sys.stderr)
        return 1
    if not on_cpu:
        print(card_line(), flush=True)
        print(f"# {torch.cuda.get_device_name(0)}", flush=True)
    configs = [TINY] if args.tiny else CONFIGS
    result = None
    for cfg in configs:
        print(f"# configuration: {json.dumps(cfg)}", flush=True)
        try:
            result = run(**cfg, device=args.device)
            break
        except torch.cuda.OutOfMemoryError as e:
            print(f"# out of device memory at {cfg}: {e}", file=sys.stderr)
            torch.cuda.empty_cache()
    if result is None:
        return 1
    mfu_val, ratio = (result["mfu"], None) if on_cpu \
        else calibrated_mfu(result["mfu"])
    print(f"# calls {', '.join(f'{t:.3f}' for t in result['call_s'])} s, "
          f"{result['flops_per_call']:.6g} FLOPs a call", flush=True)
    out = {"metric": METRIC, "value": round(result["samples_per_sec"], 2),
           "unit": "samples/sec/chip",
           "vs_baseline": round(mfu_val / 0.50, 4)
           if mfu_val is not None else None}
    if mfu_val is not None:
        out["mfu"] = round(mfu_val, 4)
    if ratio is not None:
        out["calibration_ratio"] = round(ratio, 4)
    # where the number was taken: a host run is not a card's rate
    out["device"] = "cpu" if on_cpu else torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
