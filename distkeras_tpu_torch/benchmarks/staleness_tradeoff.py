"""Staleness vs wall-clock trade-off (port of
``distkeras_tpu/benchmarks/staleness_tradeoff.py``).

BASELINE.md names two halves of the primary metric: samples/s (the
config runners) and async staleness vs wall-clock, the curve that
justifies a communication window and an async mode. This harness sweeps

    strategy x communication_window x num_workers x {sync, host_async}

on the port's own paths (the substrate's epoch function for ``sync``,
:class:`~distkeras_tpu_torch.parallel.host_async.HostAsyncRunner` for
``host_async``) and reports per point, under the JAX package's JSON
fields:

- the staleness distribution of every commit (mean/p95/max: the
  rotation position in sync mode, the server-clock gap in host_async);
- the held-out-loss vs wall-clock curve (evaluated at epoch boundaries,
  evaluation excluded from the wall);
- time-to-target and loss-at-budget (:func:`derive`).

Usage::

    python -m distkeras_tpu_torch.benchmarks.staleness_tradeoff \\
        [--strategies adag,dynsgd] [--windows 1,4] [--workers 2,4] \\
        [--device cpu] [--out staleness_tradeoff.json]

Runs go on ``cuda:0``; without a card the command exits 1 and prints no
result unless ``--device cpu`` names the host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset, synthetic_mnist
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.ops import losses as losses_lib
from distkeras_tpu_torch.ops import optimizers as opt_lib
from distkeras_tpu_torch.parallel import mesh as mesh_lib
from distkeras_tpu_torch.parallel import strategies as strategies_lib
from distkeras_tpu_torch.parallel import substrate

MODES = ("sync", "host_async")


def _strategy_for(name: str, learning_rate: float, rho: float,
                  momentum: float):
    kw = {}
    if name in ("aeasgd", "eamsgd"):
        kw["rho"] = rho
    if name == "eamsgd":
        kw["momentum"] = momentum
    return strategies_lib.get(name, learning_rate=learning_rate, **kw)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _make_eval_fn(model, loss):
    loss_fn = losses_lib.get(loss)

    @torch.no_grad()
    def eval_loss(params: dict, feats, labels) -> float:
        logits = torch.func.functional_call(model, params, (feats,))
        return float(loss_fn(logits, labels))

    return eval_loss


def _init(model, seed: int) -> dict:
    """Seeded weights (the MLP's flax-default init) as a name -> tensor
    dict on the model's device."""
    from distkeras_tpu_torch.models.mlp import init_params

    init_params(model, torch.Generator().manual_seed(seed))
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def run_point(*, strategy: str, window: int, num_workers: int, mode: str,
              model, train_ds: Dataset, heldout: Dataset,
              loss: str = "categorical_crossentropy",
              learning_rate: float = 0.05, batch_size: int = 32,
              epochs: int = 8, seed: int = 0,
              rho: float = 5.0, momentum: float = 0.9,
              features_col: str = "features",
              label_col: str = "label", device=None) -> dict:
    """One sweep point: train ``epochs`` passes, time each (a warm-up
    window first; evaluation excluded), collect every commit's
    staleness, and evaluate the held-out loss at each epoch boundary."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    device = resolve_device(device)
    model.train().to(device)
    tx = opt_lib.get("sgd", learning_rate)
    strat = _strategy_for(strategy, learning_rate, rho, momentum)
    eval_fn = _make_eval_fn(model, loss)
    hx = torch.as_tensor(np.asarray(heldout[features_col])).to(device)
    hy = torch.as_tensor(np.asarray(heldout[label_col])).to(device)
    params = _init(model, seed)

    staleness: list = []
    curve: list = []
    wall = 0.0
    n_commits = 0

    if mode == "sync":
        mesh = mesh_lib.Mesh([device])
        center, carries = substrate.init_center_and_carries(
            params, tx, strat, mesh, num_workers)
        epoch_fn = substrate.build_epoch_fn(
            model, loss, tx, strat, mesh, num_workers, window, metrics=(),
            dropout_seed=seed)
        data, rounds = substrate.stage_epoch_data(
            train_ds.repartition(num_workers), features_col, label_col,
            batch_size, window, mesh)
        # warm-up on throwaway copies (the epoch function updates the
        # carries in place)
        _, wcarries = substrate.init_center_and_carries(
            params, tx, strat, mesh, num_workers)
        epoch_fn(dict(center), wcarries, data, 0)
        _sync(device)
        eval_fn(center, hx, hy)
        round_offset = 0
        for _ in range(epochs):
            t0 = time.perf_counter()
            center, carries, ms = epoch_fn(center, carries, data,
                                           round_offset)
            _sync(device)
            wall += time.perf_counter() - t0
            round_offset += rounds
            staleness.extend(
                float(s) for s in ms["staleness"].cpu().numpy().ravel())
            n_commits += rounds * num_workers
            curve.append({"wall_s": wall,
                          "heldout_loss": eval_fn(center, hx, hy)})
    else:
        from distkeras_tpu_torch.parallel import host_async

        runner = host_async.HostAsyncRunner(
            model, loss, tx, strat, window, metrics=(), seed=seed,
            devices=[device])
        shards = host_async.stage_worker_shards(
            train_ds.repartition(num_workers), features_col, label_col,
            batch_size, window)
        rounds = len(shards[0])
        # warm-up: one window on a throwaway carry
        wcarry = strat.init_carry(params, tx, device=device)
        runner.window_fn(wcarry, params, {
            k: torch.as_tensor(v).to(device) for k, v in
            shards[0][0].items()}, 0)
        _sync(device)
        eval_fn(params, hx, hy)
        clock = 0
        for _ in range(epochs):
            t0 = time.perf_counter()
            params, _hist, stal, clock = runner.run(params, [shards],
                                                    start_clock=clock)
            _sync(device)
            wall += time.perf_counter() - t0
            staleness.extend(stal)
            n_commits += len(stal)
            curve.append({"wall_s": wall,
                          "heldout_loss": eval_fn(params, hx, hy)})
    samples = epochs * rounds * num_workers * window * batch_size

    stal_arr = np.asarray(staleness, np.float64) if staleness else \
        np.zeros((1,))
    return {
        "strategy": strategy, "window": window, "num_workers": num_workers,
        "mode": mode, "epochs": epochs, "batch_size": batch_size,
        "rounds_per_epoch": rounds, "commits": n_commits,
        "staleness_mean": round(float(stal_arr.mean()), 4),
        "staleness_p95": round(float(np.percentile(stal_arr, 95)), 4),
        "staleness_max": round(float(stal_arr.max()), 4),
        "total_wall_s": round(wall, 4),
        "samples_per_sec": round(samples / wall, 2) if wall > 0 else None,
        "final_heldout_loss": round(curve[-1]["heldout_loss"], 6),
        "curve": [{"wall_s": round(c["wall_s"], 4),
                   "heldout_loss": round(c["heldout_loss"], 6)}
                  for c in curve],
    }


def derive(points: Sequence[dict], target_loss: Optional[float] = None,
           wall_budget: Optional[float] = None) -> dict:
    """Attach the two headline scalars to every point.

    ``target_loss`` defaults to 1.05x the best final held-out loss of the
    sweep (so at least one point reaches it); ``wall_budget`` to the
    largest first epoch-boundary wall (so every point has a measurement
    inside the budget)."""
    if target_loss is None:
        target_loss = 1.05 * min(p["final_heldout_loss"] for p in points)
    if wall_budget is None:
        wall_budget = max(p["curve"][0]["wall_s"] for p in points)
    for p in points:
        p["time_to_target_s"] = next(
            (c["wall_s"] for c in p["curve"]
             if c["heldout_loss"] <= target_loss), None)
        within = [c for c in p["curve"] if c["wall_s"] <= wall_budget]
        p["loss_at_budget"] = within[-1]["heldout_loss"] if within else None
    return {"target_loss": round(float(target_loss), 6),
            "wall_budget_s": round(float(wall_budget), 4),
            "points": list(points)}


def sweep(*, strategies: Sequence[str], windows: Sequence[int],
          workers: Sequence[int], modes: Sequence[str] = MODES,
          n_train: int = 4096, n_heldout: int = 1024,
          model=None, batch_size: int = 32, learning_rate: float = 0.05,
          epochs: int = 8, seed: int = 0,
          target_loss: Optional[float] = None,
          wall_budget: Optional[float] = None,
          verbose: bool = False, device=None) -> dict:
    """The full grid. One model and one train/held-out split serve every
    point (each point restarts from the same seeded weights), so the
    differences come from the sweep axes alone."""
    device = resolve_device(device)
    if model is None:
        from distkeras_tpu_torch.models.mlp import MLP

        model = MLP(features=(64,), num_classes=10)
    full = synthetic_mnist(n=n_train + n_heldout, seed=seed)
    cols = {c: np.asarray(full[c]) for c in full.columns}
    train_ds = Dataset({c: v[:n_train] for c, v in cols.items()})
    heldout = Dataset({c: v[n_train:] for c, v in cols.items()})
    points = []
    for mode in modes:
        for s in strategies:
            for k in workers:
                for w in windows:
                    p = run_point(strategy=s, window=w, num_workers=k,
                                  mode=mode, model=model, train_ds=train_ds,
                                  heldout=heldout, batch_size=batch_size,
                                  learning_rate=learning_rate, epochs=epochs,
                                  seed=seed, device=device)
                    if verbose:
                        print(f"# {mode:10s} {s:9s} K={k} w={w:3d}: "
                              f"stal {p['staleness_mean']:.2f} "
                              f"p95 {p['staleness_p95']:.1f}  "
                              f"final {p['final_heldout_loss']:.4f}  "
                              f"wall {p['total_wall_s']:.2f}s", flush=True)
                    points.append(p)
    out = derive(points, target_loss, wall_budget)
    out["protocol"] = {
        "n_train": n_train, "n_heldout": n_heldout,
        "batch_size": batch_size, "learning_rate": learning_rate,
        "epochs": epochs, "seed": seed,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "device_count": 1,
        "notes": "wall excludes the warm-up window and held-out "
                 "evaluation; staleness is per-commit (rotation position "
                 "in sync mode, server-clock gap in host_async mode)"}
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strategies", default="downpour,adag,aeasgd,eamsgd,"
                    "dynsgd")
    ap.add_argument("--windows", default="1,2,4,8,16,32")
    ap.add_argument("--workers", default="4,8")
    ap.add_argument("--modes", default="sync,host_async")
    ap.add_argument("--n-train", type=int, default=8192)
    ap.add_argument("--n-heldout", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--learning-rate", type=float, default=0.05)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--target-loss", type=float, default=None)
    ap.add_argument("--wall-budget", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="cpu runs on the host; default cuda:0")
    ap.add_argument("--out", default="staleness_tradeoff.json")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"# {e}", file=sys.stderr)
        return 1
    result = sweep(
        strategies=[s for s in args.strategies.split(",") if s],
        windows=[int(w) for w in args.windows.split(",") if w],
        workers=[int(k) for k in args.workers.split(",") if k],
        modes=[m for m in args.modes.split(",") if m],
        n_train=args.n_train, n_heldout=args.n_heldout,
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        epochs=args.epochs, seed=args.seed, target_loss=args.target_loss,
        wall_budget=args.wall_budget, verbose=True, device=device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"# wrote {args.out} ({len(result['points'])} points)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
