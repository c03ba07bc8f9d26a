"""Cross-host data mixing for the host-sharded input contract (port of
``distkeras_tpu/data/global_shards.py``).

dist-keras's ``utils.shuffle(df)`` re-dealt rows to Spark executors on
EVERY call, so no executor was permanently married to a data subset.
:class:`GlobalShards` keeps those global semantics at zero RAM cost: the
dataset is a pool of equal-sized shard FILES visible to every host; each
epoch, a seed-derived permutation re-deals shard files to processes, and
a process opens ONLY its epoch's files (lazy mmap: re-pointing processes
at different files moves no bytes). Within-process order can further be
shuffled by the trainer's ``shuffle=True``.

Every process computes the same permutation from ``(seed, epoch)`` with
no communication, bitwise the JAX package's. The process count and index
are the ``torch.distributed`` group's, ``1`` and ``0`` when no group is
up: in one process the pool is re-dealt among the process's workers each
epoch (:meth:`~distkeras_tpu_torch.trainers.DistributedTrainer.train`
re-resolves :meth:`GlobalShards.epoch_dataset` every epoch).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

import torch

from distkeras_tpu_torch.data.dataset import Dataset, ShardedColumn
from distkeras_tpu_torch.utils import rng


def _process_topology() -> tuple:
    """``(process_count, process_index)`` of this process: the
    ``torch.distributed`` group's world size and rank when one is up, else
    ``(1, 0)``."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ShardingError(ValueError):
    """A shard pool that cannot satisfy the legacy equal-shard contract
    (unequal row counts, mismatched shard counts, or a shard count that
    does not divide the process count). Subclasses :class:`ValueError` so
    pre-existing broad handlers keep working; the message always names the
    offending counts. The streaming data service
    (:mod:`distkeras_tpu_torch.data.service`) has no such constraint — it is the
    intended escape when this fires."""


class GlobalShards:
    """An epoch-seeded assignment of shard files to hosts.

    ``columns`` maps each column name to the FULL ordered list of its shard
    file paths (``.npy``); every host passes the same lists. All shards of
    a column must hold the same row count, and all columns the same shard
    count (so any shard index selects consistent rows across columns and
    every host stages equal row counts — the host-sharded contract's
    static-shape requirement).

    Pass the object wherever a host-sharded trainer takes a dataset::

        gs = GlobalShards({"features": feat_paths, "label": label_paths})
        ADAG(model, ..., data_layout="host_sharded").train(gs)

    Epoch e on process p sees ``epoch_dataset(e)`` — the shards at
    ``permutation(seed, e)[p * S/P : (p+1) * S/P]``, presented as one lazy
    Dataset. The union over processes is the whole pool (a permutation), so
    the global per-epoch multiset of rows is preserved while each host's
    subset changes every epoch.

    **Legacy equal-shard constraint (superseded).** This path requires
    equal-sized shard files, a shard count divisible by the process count,
    and a filesystem every host can see — Spark's assumptions from the
    dist-keras lineage, enforced here as typed :class:`ShardingError`\\ s.
    The streaming data service (:mod:`distkeras_tpu_torch.data.service`,
    DESIGN.md §20) supersedes all three: a :class:`~distkeras_tpu_torch.data.
    service.DataCoordinator` leases unequal row ranges to however many
    workers are alive, and :meth:`streaming_dataset` is the bridge — the
    whole pool as one lazy Dataset for the coordinator to serve.
    """

    def __init__(self, columns: Dict[str, Sequence[Union[str, bytes]]],
                 seed: int = 0, mmap: bool = True):
        if not columns:
            raise ValueError("GlobalShards needs at least one column")
        counts = {c: len(ps) for c, ps in columns.items()}
        if len(set(counts.values())) != 1:
            raise ShardingError(
                f"Every column needs the SAME shard count (shard i of each "
                f"column holds the same rows); got {counts}")
        self.num_shards = next(iter(counts.values()))
        if self.num_shards == 0:
            raise ValueError("GlobalShards needs at least one shard file")
        self.seed = int(seed)
        self._mmap = bool(mmap)
        self._paths: Dict[str, List[str]] = {
            c: [str(p) for p in ps] for c, ps in columns.items()}
        # Validate row counts from the npy HEADERS alone: no memmaps (and
        # no file descriptors) are held open here — a pool of thousands of
        # shard files must not exhaust the fd limit at construction; files
        # are opened lazily in epoch_dataset, only the shards assigned to
        # this host this epoch.
        sizes = {self._npy_rows(p)
                 for ps in self._paths.values() for p in ps}
        if len(sizes) != 1:
            raise ShardingError(
                f"All shard files must hold the SAME row count (hosts must "
                f"stage equal rows under the static-shape contract); got "
                f"sizes {sorted(sizes)} — unequal shards stream fine "
                f"through data.service.DataCoordinator")
        self.rows_per_shard = sizes.pop()

    @staticmethod
    def _npy_rows(path: str) -> int:
        """Leading-axis length read from the .npy header (fd closed on
        return — nothing stays open)."""
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            if version >= (2, 0):
                shape, _, _ = np.lib.format.read_array_header_2_0(f)
            else:
                shape, _, _ = np.lib.format.read_array_header_1_0(f)
        if not shape:
            raise ValueError(f"{path!r} holds a 0-d array, not rows")
        return int(shape[0])

    @property
    def columns(self) -> List[str]:
        return list(self._paths)

    def __len__(self) -> int:
        """Total rows in the pool (all shards)."""
        return self.num_shards * self.rows_per_shard

    def epoch_assignment(self, epoch: int,
                         process_count: Optional[int] = None) -> List[List[int]]:
        """Per-process shard-index lists for one epoch — a contiguous split
        of the (seed, epoch)-permuted pool. Deterministic and
        communication-free: every host computes the same answer."""
        p = process_count if process_count is not None else \
            _process_topology()[0]
        if self.num_shards % p:
            raise ShardingError(
                f"{self.num_shards} shard files do not split evenly over "
                f"{p} processes (remainder {self.num_shards % p}); provide "
                f"a multiple (equal host row counts are the host-sharded "
                f"contract), or stream the pool through "
                f"data.service.DataCoordinator, which has no divisibility "
                f"constraint")
        perm = rng.permutation(self.seed * 1_000_003 + epoch,
                               self.num_shards)
        per = self.num_shards // p
        return [list(map(int, perm[i * per:(i + 1) * per]))
                for i in range(p)]

    def epoch_dataset(self, epoch: int,
                      process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> Dataset:
        """This process's lazy Dataset for one epoch (no bytes read)."""
        pi = process_index if process_index is not None else \
            _process_topology()[1]
        idxs = self.epoch_assignment(epoch, process_count)[pi]
        mode = "r" if self._mmap else None
        out = {}
        for c, paths in self._paths.items():
            chosen = [np.load(paths[i], mmap_mode=mode) for i in idxs]
            out[c] = chosen[0] if len(chosen) == 1 else ShardedColumn(chosen)
        return Dataset(out)

    def streaming_dataset(self) -> Dataset:
        """The WHOLE pool as one lazy Dataset — the bridge to the
        streaming data service (DESIGN.md §20)::

            coord = DataCoordinator(dataset=gs.streaming_dataset(), ...)

        Every shard becomes part of a lazy :class:`ShardedColumn` (mmap —
        no bytes read here); the coordinator reads only the row ranges
        workers actually lease, so only IT needs to see the files. No
        divisibility or equal-host-rows constraint applies: range
        permutation replaces shard permutation, and epoch/cursor state
        lives in the coordinator."""
        mode = "r" if self._mmap else None
        out = {}
        for c, paths in self._paths.items():
            parts = [np.load(p, mmap_mode=mode) for p in paths]
            out[c] = parts[0] if len(parts) == 1 else ShardedColumn(parts)
        return Dataset(out)
