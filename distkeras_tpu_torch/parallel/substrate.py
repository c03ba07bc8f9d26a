"""The substrate: the update rules run on a mesh (port of
``distkeras_tpu/parallel/substrate.py``).

The JAX package compiles an epoch into one jitted ``shard_map`` of
``lax.scan(rounds)`` over ``lax.scan(window)``, with the round's commits
folded by one ``psum``. The port runs the same schedule as plain loops
in one process: over rounds, then over each device's stacked replicas in
worker order, then over the window's steps. A replica's round is the
JAX order, pull -> steps -> commit -> weighted fold -> ``post_commit``,
and every replica of a round reads the same center.

What comes out as the JAX package has it:

- logical worker ``k`` (on ``mesh.devices[k // factor]``) commits at
  schedule position ``(k + r) % K`` in global round ``r``, weighted by
  ``strategy.staleness_weight(position)``; ``round_offset`` continues
  the rotation across epochs;
- the fold sums the weighted commits of each device's replicas first,
  then those sums over the devices in mesh order, then adds the total to
  the center. The sum runs leaf by leaf, so ``bucket_bytes`` (which the
  JAX package uses to split its all-reduce into buckets) is validated and
  cannot change it;
- metrics come back as ``(workers, rounds, window)`` tensors, with
  ``staleness`` as ``(workers, rounds)``.

The replicas are not ``torch.func.vmap``-ed: the hand-written kernels
(GroupNorm, flash attention) are ``autograd.Function``s without a vmap
rule, and a loop leaves them as they are. Dropout draws from a generator
seeded from ``(dropout_seed, k, round, step)``, not JAX's threefry bits.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from distkeras_tpu_torch import engine
from distkeras_tpu_torch.parallel import mesh as mesh_lib
from distkeras_tpu_torch.parallel.mesh import Mesh
from distkeras_tpu_torch.parallel.strategies import Strategy
from distkeras_tpu_torch.utils import rng
from distkeras_tpu_torch.utils.trees import tree_add, tree_scale

WORKERS = mesh_lib.WORKER_AXIS


class StagedChunk(dict):
    """One staged chunk: ``key -> [D tensors (rounds, factor, window,
    batch, ...)]``, tensor ``d`` on ``mesh.devices[d]``. On a card the
    copies were queued on a side stream; :meth:`wait` makes the current
    stream wait for them (the epoch function calls it)."""

    def __init__(self, data: dict, events=(), hold=()):
        super().__init__(data)
        self._events = list(events)
        self._hold = list(hold)  # pinned host blocks of queued copies

    def wait(self) -> None:
        for tensor, event in self._events:
            stream = torch.cuda.current_stream(tensor.device)
            stream.wait_event(event)
            tensor.record_stream(stream)
        self._events, self._hold = [], []


def build_epoch_fn(model, loss, tx, strategy: Strategy, mesh: Mesh,
                   num_workers: int, window: int,
                   metrics: Sequence[str] = (), dropout_seed: int = 0,
                   accum_steps: int = 1, precision=None,
                   bucket_bytes: Optional[int] = None) -> Callable:
    """The per-epoch training function of ``num_workers`` logical
    workers (K) on ``mesh`` (D devices, K/D replicas each).

    Returns ``epoch_fn(center, carries, data, round_offset) ->
    (center, carries, metrics)`` where

    - ``center``: name -> tensor dict on ``mesh.home`` (the parameter
      server's state); a new dict is returned;
    - ``carries``: the K workers' :class:`~.strategies.Carry`, in worker
      order, each on its device, updated in place and returned;
    - ``data``: a :func:`stage_epoch_chunks` chunk;
    - ``round_offset``: the global round counter;
    - ``metrics``: ``(workers, rounds, window)`` float32 tensors on
      ``mesh.home`` (``loss`` and each name of ``metrics``), plus
      ``staleness`` ``(workers, rounds)``.

    ``tx`` is the worker optimizer's factory; the carries hold the
    optimizers it built. ``accum_steps > 1`` runs each local step as that
    many microbatches (``engine.make_accum_grad_fn``). ``precision=``
    threads a policy's static loss scale into the grad function, as in
    the JAX package.
    """
    mesh_lib.check_single_process("the substrate's fold")
    if bucket_bytes is not None and int(bucket_bytes) <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    metric_names = tuple(metrics)
    accum_steps = int(accum_steps)
    if accum_steps > 1:
        grad_fn = engine.make_accum_grad_fn(model, loss, accum_steps,
                                            metric_names,
                                            precision=precision,
                                            functional=True)
    else:
        grad_fn = engine.make_grad_fn(model, loss, precision=precision,
                                      functional=True)
    mesh_workers = mesh.shape[WORKERS]
    if num_workers % mesh_workers != 0:
        raise ValueError(
            f"num_workers={num_workers} must be a multiple of the mesh's "
            f"workers axis ({mesh_workers}); pick parallelism_factor so "
            f"logical workers divide evenly onto devices")
    factor = num_workers // mesh_workers
    names = ("loss",) + metric_names

    def step_metrics(out: dict, batch: dict) -> dict:
        ms = {"loss": out["loss"]}
        for name in metric_names:
            if accum_steps > 1:
                ms[name] = engine.finalize_metric(out["logits"][name])
            else:
                ms[name] = engine.compute_metric(name, out["logits"],
                                                 batch["labels"])
        return ms

    def epoch_fn(center: dict, carries: list, data: dict,
                 round_offset: int) -> Tuple[dict, list, dict]:
        if isinstance(data, StagedChunk):
            data.wait()
        num_rounds = next(iter(data.values()))[0].shape[0]
        # per worker, per round, per step: 0-d tensors on the worker's
        # device, stacked once at the end (no host read in the loop)
        hist = {n: [[[] for _ in range(num_rounds)]
                    for _ in range(num_workers)] for n in names}
        staleness = np.zeros((num_workers, num_rounds), np.float32)
        with torch.no_grad():
            replicas = [{n: x.to(dev) for n, x in center.items()}
                        for dev in mesh.devices]
        for ri in range(num_rounds):
            r_idx = int(round_offset) + ri
            device_sums, commits = [], []
            for d, dev in enumerate(mesh.devices):
                local = None
                for j in range(factor):
                    k = d * factor + j
                    carry = strategy.round_start(carries[k], replicas[d])
                    for s in range(window):
                        batch = {key: cols[d][ri, j, s]
                                 for key, cols in data.items()}
                        gen = rng.step_generator(dropout_seed, k, r_idx, s,
                                                 dev)
                        carry, out = strategy.local_step(grad_fn, carry,
                                                         batch, gen)
                        for n, v in step_metrics(out, batch).items():
                            hist[n][k][ri].append(v)
                    carries[k] = carry
                    if not strategy.exchanges:
                        continue
                    commit = strategy.commit(carry, replicas[d], window)
                    position = (k + r_idx) % num_workers
                    weighted = tree_scale(
                        commit, strategy.staleness_weight(position))
                    staleness[k, ri] = position
                    local = weighted if local is None \
                        else tree_add(local, weighted)
                    commits.append(commit)
                device_sums.append(local)
            if not strategy.exchanges:
                continue
            with torch.no_grad():
                total = device_sums[0]
                for part in device_sums[1:]:
                    total = tree_add(total, {n: x.to(mesh.home)
                                             for n, x in part.items()})
                center = tree_add(center, total)
                replicas = [{n: x.to(dev) for n, x in center.items()}
                            for dev in mesh.devices]
            for k in range(num_workers):
                carries[k] = strategy.post_commit(
                    carries[k], commits[k], replicas[k // factor])
        ms = {n: torch.stack([torch.stack([torch.stack(step).to(mesh.home)
                                           for step in per_round])
                              for per_round in per_worker]).float()
              for n, per_worker in hist.items()}
        ms["staleness"] = torch.from_numpy(staleness).to(mesh.home)
        return center, carries, ms

    return epoch_fn


def init_center_and_carries(params: dict, tx, strategy: Strategy,
                            mesh: Mesh, num_workers: int) -> Tuple[dict,
                                                                   list]:
    """The center on ``mesh.home`` and K carries, worker ``k`` on its
    device, all starting from ``params`` (the reference's model
    broadcast)."""
    factor = num_workers // mesh.shape[WORKERS]
    center = mesh_lib.put_replicated(params, mesh)
    carries = [strategy.init_carry(params, tx,
                                   device=mesh_lib.worker_device(mesh, k,
                                                                 factor))
               for k in range(num_workers)]
    return center, carries


def stage_epoch_data(shards, features_col: str, label_col: str,
                     batch_size: int, window: int, mesh: Mesh,
                     max_rounds: Optional[int] = None) -> Tuple[StagedChunk,
                                                                int]:
    """Per-worker shards -> one staged chunk of the whole epoch, ``key ->
    [D tensors (rounds, factor, window, batch, ...)]``, and its round
    count. Every worker gets the same round count, the smallest shard's;
    surplus rows are dropped. For data that should not be resident as a
    whole use :func:`stage_epoch_chunks`."""
    return next(stage_epoch_chunks(shards, features_col, label_col,
                                   batch_size, window, mesh,
                                   max_rounds=max_rounds))


def _to_device(shape: tuple, dtype, fill: Callable, device: torch.device,
               stream):
    """A ``shape``/``dtype`` tensor on ``device`` that ``fill`` writes on
    the host. On a card ``fill`` writes into pinned memory, copied with
    ``non_blocking`` on ``stream``; returns ``(tensor, event or None,
    pinned or None)``."""
    if device.type != "cuda":
        host = np.empty(shape, dtype)
        fill(host)
        return torch.from_numpy(host).to(device), None, None
    pinned = torch.empty(shape, dtype=torch.from_numpy(
        np.empty(0, dtype)).dtype, pin_memory=True)
    fill(pinned.numpy())
    with torch.cuda.stream(stream):
        out = pinned.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event, pinned


def stage_epoch_chunks(shards, features_col: str, label_col: str,
                       batch_size: int, window: int, mesh: Mesh,
                       chunk_rounds: Optional[int] = None,
                       max_rounds: Optional[int] = None,
                       local_positions: Optional[Sequence[int]] = None):
    """A generator of ``(chunk, rounds)`` of at most ``chunk_rounds``
    rounds each (all rounds in one chunk when None), staging memory
    O(chunk). Data is round-major, ``(rounds, workers, window, batch,
    ...)``, split on the workers axis into each device's replicas.
    Columns keep their dtype: uint8 images stay uint8 until the model
    normalizes them on the device.

    On a card each block is stacked into pinned host memory and copied
    with ``non_blocking`` on a side stream, so a caller that runs chunk
    ``i`` while this generator (on a prefetch thread) stages chunk
    ``i + 1`` overlaps the host work and the copy with the compute.

    ``local_positions`` is the JAX package's host-sharded contract; one
    process owns every position, so only the full list is accepted."""
    factor = len(shards) // mesh.shape[WORKERS]
    if factor * mesh.shape[WORKERS] != len(shards):
        raise ValueError(
            f"{len(shards)} shards do not divide onto the mesh's "
            f"{mesh.shape[WORKERS]} devices")
    if local_positions is not None and list(local_positions) != \
            mesh_lib.local_worker_positions(mesh):
        raise ValueError(
            f"local_positions={list(local_positions)}: this process owns "
            f"every position of the mesh")
    per_round = batch_size * window
    rounds = min(len(s) // per_round for s in shards)
    if max_rounds is not None:
        rounds = min(rounds, max_rounds)
    if rounds == 0:
        raise ValueError(
            f"Shards of sizes {[len(s) for s in shards]} cannot form a "
            f"single round of window={window} x batch={batch_size}")
    if chunk_rounds is None:
        chunk_rounds = rounds
    cols = {"features": features_col, "labels": label_col}
    # columns stay lazy (ndarray views, memmaps, ShardedColumns); rows are
    # read per chunk slice below
    arrs = {key: [s[col] for s in shards] for key, col in cols.items()}
    streams = {dev: torch.cuda.Stream(dev) for dev in set(mesh.devices)
               if dev.type == "cuda"}

    def gen():
        for start in range(0, rounds, chunk_rounds):
            cnt = min(chunk_rounds, rounds - start)
            lo = start * per_round
            hi = lo + cnt * per_round
            data, events, hold = {}, [], []
            for key in cols:
                data[key] = []
                for d, dev in enumerate(mesh.devices):
                    mine = arrs[key][d * factor:(d + 1) * factor]
                    tail = tuple(mine[0].shape[1:])
                    blocks = [np.asarray(a[lo:hi]).reshape(
                        (cnt, window, batch_size) + tail) for a in mine]
                    out, event, pinned = _to_device(
                        (cnt, factor, window, batch_size) + tail,
                        blocks[0].dtype,
                        lambda host, b=blocks: np.stack(b, axis=1,
                                                        out=host),
                        dev, streams.get(dev))
                    data[key].append(out)
                    if event is not None:
                        events.append((out, event))
                        hold.append(pinned)
            yield StagedChunk(data, events, hold), cnt

    return gen()
