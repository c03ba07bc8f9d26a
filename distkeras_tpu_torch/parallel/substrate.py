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

On a mesh that spans a process group (:mod:`~distkeras_tpu_torch.parallel.mesh`)
each process runs its own worker rows only (their carries, their staged
data): it folds its workers' weighted commits in worker order into a
partial, and the partials are summed across processes
(:func:`~distkeras_tpu_torch.parallel.collectives.cross_process_sum`,
bucketed as ``bucket_bytes`` asks) before the center moves, so every
process holds the same center. The metrics are all-gathered, so every
process returns the whole ``(workers, ...)`` tensors.

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
from distkeras_tpu_torch.parallel import collectives, distributed
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
      order, each on its device, updated in place and returned (on a
      mesh over processes: this process's workers' only);
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
    # this process's worker rows (every row in one process)
    local = mesh_lib.local_worker_positions(mesh)
    spans = mesh.spans_processes
    if spans and set(mesh.owners) != set(range(distributed.process_count())):
        raise ValueError(
            f"mesh owners {mesh.owners}: every process of the group must "
            f"own a worker row")
    local_k = local_workers(mesh, num_workers)

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
        # per local worker, per round, per step: 0-d tensors on the
        # worker's device, stacked once at the end (no host read in the
        # loop); carries, data and metrics are indexed by local worker
        hist = {n: [[[] for _ in range(num_rounds)]
                    for _ in local_k] for n in names}
        staleness = np.zeros((len(local_k), num_rounds), np.float32)
        with torch.no_grad():
            replicas = [{n: x.to(mesh.devices[d]) for n, x in center.items()}
                        for d in local]
        for ri in range(num_rounds):
            r_idx = int(round_offset) + ri
            device_sums, commits = [], []
            for li, d in enumerate(local):
                dev = mesh.devices[d]
                part = None
                for j in range(factor):
                    lk, k = li * factor + j, d * factor + j
                    carry = strategy.round_start(carries[lk], replicas[li])
                    for s in range(window):
                        batch = {key: cols[li][ri, j, s]
                                 for key, cols in data.items()}
                        gen = rng.step_generator(dropout_seed, k, r_idx, s,
                                                 dev)
                        carry, out = strategy.local_step(grad_fn, carry,
                                                         batch, gen)
                        for n, v in step_metrics(out, batch).items():
                            hist[n][lk][ri].append(v)
                    carries[lk] = carry
                    if not strategy.exchanges:
                        continue
                    commit = strategy.commit(carry, replicas[li], window)
                    position = (k + r_idx) % num_workers
                    weighted = tree_scale(
                        commit, strategy.staleness_weight(position))
                    staleness[lk, ri] = position
                    part = weighted if part is None \
                        else tree_add(part, weighted)
                    commits.append(commit)
                device_sums.append(part)
            if not strategy.exchanges:
                continue
            with torch.no_grad():
                total = device_sums[0]
                for part in device_sums[1:]:
                    total = tree_add(total, {n: x.to(mesh.home)
                                             for n, x in part.items()})
                if spans:
                    total = collectives.cross_process_sum(total,
                                                          bucket_bytes)
                center = tree_add(center, total)
                replicas = [{n: x.to(mesh.devices[d])
                             for n, x in center.items()} for d in local]
            for lk in range(len(local_k)):
                carries[lk] = strategy.post_commit(
                    carries[lk], commits[lk], replicas[lk // factor])
        ms = {n: torch.stack([torch.stack([torch.stack(step).to(mesh.home)
                                           for step in per_round])
                              for per_round in per_worker]).float()
              for n, per_worker in hist.items()}
        ms["staleness"] = torch.from_numpy(staleness).to(mesh.home)
        if spans:  # every process returns every worker's rows
            ms = {n: torch.from_numpy(np.concatenate(
                distributed.process_allgather(v.cpu().numpy()))).to(
                    mesh.home) for n, v in ms.items()}
        return center, carries, ms

    return epoch_fn


def init_center_and_carries(params: dict, tx, strategy: Strategy,
                            mesh: Mesh, num_workers: int) -> Tuple[dict,
                                                                   list]:
    """The center on ``mesh.home`` and K carries, worker ``k`` on its
    device, all starting from ``params`` (the reference's model
    broadcast); on a mesh over processes the carries of this process's
    workers only."""
    factor = num_workers // mesh.shape[WORKERS]
    center = mesh_lib.put_replicated(params, mesh)
    carries = [strategy.init_carry(params, tx,
                                   device=mesh_lib.worker_device(mesh, k,
                                                                 factor))
               for k in local_workers(mesh, num_workers)]
    return center, carries


def local_workers(mesh: Mesh, num_workers: int) -> list:
    """The global ids of this process's logical workers, in order (all K
    in one process)."""
    factor = num_workers // mesh.shape[WORKERS]
    return [d * factor + j for d in mesh_lib.local_worker_positions(mesh)
            for j in range(factor)]


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
    ...)``, split on the workers axis into each of this process's
    devices' replicas (a chunk lists this process's positions only).
    Columns keep their dtype: uint8 images stay uint8 until the model
    normalizes them on the device.

    On a card each block is stacked into pinned host memory and copied
    with ``non_blocking`` on a side stream, so a caller that runs chunk
    ``i`` while this generator (on a prefetch thread) stages chunk
    ``i + 1`` overlaps the host work and the copy with the compute.

    The JAX package's two multi-process data contracts, on a mesh over
    processes:

    - ``local_positions=None`` (replicated): every process holds the
      same full dataset, ``shards`` covers every worker, and this process
      stages its own positions' shards only;
    - ``local_positions`` (host-sharded, this process's
      :func:`~distkeras_tpu_torch.parallel.mesh.local_worker_positions`):
      ``shards`` holds those positions' workers only, ``factor`` each in
      order. The common round count is negotiated with a process
      all-gather (once a call, on the caller's thread), and a process
      whose shards cannot form a round makes every process raise.

    In one process every position is local."""
    local = mesh_lib.local_worker_positions(mesh)
    if local_positions is not None:
        if list(local_positions) != local:
            raise ValueError(
                f"local_positions={list(local_positions)}: this process "
                f"runs positions {local}")
        width = len(local)
    else:
        width = mesh.shape[WORKERS]
    factor = len(shards) // width
    if factor * width != len(shards) or factor == 0:
        raise ValueError(
            f"{len(shards)} shards do not divide onto the mesh's "
            f"{width} devices")
    if local_positions is None and mesh.spans_processes:
        shards = [s for d in local
                  for s in shards[d * factor:(d + 1) * factor]]
    per_round = batch_size * window
    local_rounds = min(len(s) // per_round for s in shards)
    rounds = local_rounds
    if local_positions is not None and distributed.process_count() > 1:
        # the global minimum: shard sizes may differ across processes
        rounds = int(np.min(distributed.process_allgather(
            np.int64(local_rounds))))
    if max_rounds is not None:
        rounds = min(rounds, max_rounds)
    if rounds == 0:
        if rounds != local_rounds:
            raise ValueError(
                f"A PEER process's shards cannot form a single round of "
                f"window={window} x batch={batch_size} (negotiated global "
                f"round count is 0; this host's shards of sizes "
                f"{[len(s) for s in shards]} could form {local_rounds})")
        raise ValueError(
            f"Shards of sizes {[len(s) for s in shards]} cannot form a "
            f"single round of window={window} x batch={batch_size}")
    if chunk_rounds is None:
        chunk_rounds = rounds
    cols = {"features": features_col, "labels": label_col}
    # columns stay lazy (ndarray views, memmaps, ShardedColumns); rows are
    # read per chunk slice below
    arrs = {key: [s[col] for s in shards] for key, col in cols.items()}
    devices = [mesh.devices[d] for d in local]
    streams = {dev: torch.cuda.Stream(dev) for dev in set(devices)
               if dev.type == "cuda"}

    def gen():
        for start in range(0, rounds, chunk_rounds):
            cnt = min(chunk_rounds, rounds - start)
            lo = start * per_round
            hi = lo + cnt * per_round
            data, events, hold = {}, [], []
            for key in cols:
                data[key] = []
                for d, dev in enumerate(devices):
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
