"""Columnar in-memory dataset (port of ``distkeras_tpu/data/dataset.py``):
the Spark-DataFrame stand-in. Numpy code, kept as a copy so that the port
imports nothing of the JAX package; every output is bitwise the JAX
package's. The in-memory shuffle gathers through the threaded native
assembler when it builds (``data/native.py``, the JAX package's), else
with numpy; the rows are the same.

Reference parity: dist-keras consumes Spark DataFrames with named feature /
label columns, repartitions them per worker, and iterates rows per partition
(``distkeras/trainers.py``/``workers.py`` — unverified, mount empty). The
port's equivalent is a host-resident columnar store (dict of NumPy
arrays) with the same vocabulary: named columns, ``shuffle``, ``repartition``
into per-worker shards, and *batched* iteration with static shapes (pad or
drop ragged tails — the steps and their CUDA graphs take fixed shapes).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from distkeras_tpu_torch.utils import rng


class ShardedColumn:
    """Lazy concatenation of per-file array shards (memmaps stay on disk).

    Presents just enough of the ndarray protocol for the data path: length,
    shape/dtype, contiguous slicing (returns a trimmed *view* — no bytes
    read), integer row access, and materialization via ``np.asarray``. The
    staging layer slices chunks out of worker shards and materializes only
    those, so an epoch never has to exist in host RAM at once.
    """

    def __init__(self, parts: Sequence[np.ndarray]):
        if not parts:
            raise ValueError("ShardedColumn needs at least one part")
        tails = {p.shape[1:] for p in parts}
        dtypes = {p.dtype for p in parts}
        if len(tails) != 1 or len(dtypes) != 1:
            raise ValueError(
                f"Shard shape/dtype mismatch: shapes {sorted(tails)}, "
                f"dtypes {sorted(map(str, dtypes))}")
        self.parts = list(parts)
        self._offsets = np.cumsum([0] + [len(p) for p in parts])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    @property
    def shape(self):
        return (len(self),) + self.parts[0].shape[1:]

    @property
    def dtype(self):
        return self.parts[0].dtype

    def __array__(self, dtype=None, copy=None):
        out = np.concatenate([np.asarray(p) for p in self.parts])
        return out.astype(dtype) if dtype is not None else out

    def __getitem__(self, key):
        if isinstance(key, slice):
            lo, hi, step = key.indices(len(self))
            if step != 1:
                return np.asarray(self)[key]
            views = []
            for p, off in zip(self.parts, self._offsets[:-1]):
                a, b = max(lo - off, 0), min(hi - off, len(p))
                if a < b:
                    views.append(p[a:b])
            if not views:
                views = [self.parts[0][:0]]
            return views[0] if len(views) == 1 else ShardedColumn(views)
        if np.isscalar(key) or isinstance(key, (int, np.integer)):
            i = int(key) + (len(self) if key < 0 else 0)
            part = int(np.searchsorted(self._offsets, i, side="right")) - 1
            return self.parts[part][i - self._offsets[part]]
        idx = np.asarray(key)
        if idx.ndim == 1 and \
                (np.issubdtype(idx.dtype, np.integer) or idx.size == 0):
            # per-part gather: reads O(len(idx)) rows from disk, never the
            # whole column (memmap fancy indexing touches only those pages)
            idx = idx.astype(np.int64, copy=False)
            if idx.size and (idx.min() < -len(self) or
                             idx.max() >= len(self)):
                raise IndexError(
                    f"index out of bounds for ShardedColumn of "
                    f"length {len(self)}: {key!r}")
            idx = np.where(idx < 0, idx + len(self), idx)
            out = np.empty((len(idx),) + self.parts[0].shape[1:], self.dtype)
            part_of = np.searchsorted(self._offsets, idx, side="right") - 1
            for p in np.unique(part_of):
                m = part_of == p
                out[m] = self.parts[p][idx[m] - self._offsets[p]]
            return out
        return np.asarray(self)[key]  # boolean/N-d keys materialize


class PermutedColumn:
    """Lazy row-permuted view of a (possibly file-backed) column.

    ``shuffle()`` on a lazy column keeps the O(n) permutation INDEX
    (8 bytes/row — trivial even at ImageNet scale) but defers the row
    gather: slicing returns another lazy view, and only materialization
    (``np.asarray`` of a chunk/batch slice) reads the underlying rows —
    O(slice) disk reads, never the whole column. Sample order is
    bit-identical to the materializing shuffle: the same
    ``rng.permutation`` indices, applied late instead of eagerly.
    """

    def __init__(self, base, perm: np.ndarray):
        self.base = base
        self.perm = np.asarray(perm)

    def __len__(self) -> int:
        return len(self.perm)

    @property
    def shape(self):
        return (len(self.perm),) + tuple(self.base.shape[1:])

    @property
    def dtype(self):
        return self.base.dtype

    def _gather(self, idx: np.ndarray) -> np.ndarray:
        # memmap / ShardedColumn fancy indexing reads O(len(idx)) rows
        return np.asarray(self.base[idx])

    def __array__(self, dtype=None, copy=None):
        out = self._gather(self.perm)
        return out.astype(dtype) if dtype is not None else out

    def __getitem__(self, key):
        if isinstance(key, slice):
            return PermutedColumn(self.base, self.perm[key])  # stays lazy
        if np.isscalar(key) or isinstance(key, (int, np.integer)):
            return self.base[int(self.perm[key])]
        return self._gather(self.perm[np.asarray(key)])


ColumnLike = Union[np.ndarray, ShardedColumn, PermutedColumn]


class Dataset:
    """An immutable set of equal-length named columns."""

    def __init__(self, columns: Dict[str, ColumnLike]):
        if not columns:
            raise ValueError("Dataset needs at least one column")
        n = {len(v) for v in columns.values()}
        if len(n) != 1:
            raise ValueError(f"Column length mismatch: "
                             f"{ {k: len(v) for k, v in columns.items()} }")
        # ShardedColumns, memmaps and PermutedColumns pass through
        # un-materialized (memmap is kept as its own type so laziness stays
        # visible downstream)
        self._columns = {
            k: v if isinstance(v, (ShardedColumn, np.memmap, PermutedColumn))
            else np.asarray(v)
            for k, v in columns.items()}

    # -- basic accessors ----------------------------------------------------
    def __len__(self) -> int:
        return len(next(iter(self._columns.values())))

    def __contains__(self, col: str) -> bool:
        return col in self._columns

    def __getitem__(self, col: str) -> np.ndarray:
        return self._columns[col]

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    def with_column(self, name: str, values: np.ndarray) -> "Dataset":
        """Functional 'withColumn' — the transformer output path."""
        new = dict(self._columns)
        new[name] = np.asarray(values)
        return Dataset(new)

    def select(self, cols: Sequence[str]) -> "Dataset":
        return Dataset({c: self._columns[c] for c in cols})

    def take(self, n: int) -> "Dataset":
        return Dataset({k: v[:n] for k, v in self._columns.items()})

    # -- distribution-shaped ops -------------------------------------------
    def shuffle(self, seed: int = 0) -> "Dataset":
        """utils.shuffle(df) parity, but deterministic by seed.

        In-memory columns are gathered eagerly (through the native threaded
        assembler when available, data/native.py). File-backed columns
        (memmap / ShardedColumn) become lazy :class:`PermutedColumn` views —
        the streaming shuffle: only the permutation index (8 bytes/row) is
        materialized now; rows are read from disk O(chunk) at a time as the
        staging layer slices them. Indices are identical on every path, so
        numerics do not depend on which one executed."""
        from distkeras_tpu_torch.data import native

        perm = rng.permutation(seed, len(self))
        out: Dict[str, ColumnLike] = {}
        for k, v in self._columns.items():
            if isinstance(v, PermutedColumn):
                out[k] = PermutedColumn(v.base, v.perm[perm])  # compose lazily
            elif isinstance(v, (ShardedColumn, np.memmap)):
                out[k] = PermutedColumn(v, perm)
            else:
                out[k] = native.gather_rows(np.asarray(v), perm)
        return Dataset(out)

    def repartition(self, num_partitions: int) -> List["Dataset"]:
        """Split into contiguous near-equal shards (Spark repartition parity;
        call shuffle() first for the randomized behavior). Slice-based, so
        shards of memmap/file-backed columns stay views — no bytes read."""
        sizes = np.full(num_partitions, len(self) // num_partitions)
        sizes[:len(self) % num_partitions] += 1  # np.array_split's split
        bounds = np.cumsum(np.concatenate([[0], sizes]))
        return [Dataset({k: v[lo:hi] for k, v in self._columns.items()})
                for lo, hi in zip(bounds[:-1], bounds[1:])]

    def batches(self, batch_size: int, cols: Optional[Sequence[str]] = None,
                drop_remainder: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Static-shape minibatches. The ragged tail is dropped by default
        (a new shape is a new graph; the reference's row-iterator had no such
        constraint but also no compiled step)."""
        cols = list(cols) if cols is not None else self.columns
        n = len(self)
        limit = (n // batch_size) * batch_size if drop_remainder else n
        for start in range(0, limit, batch_size):
            # np.asarray materializes lazy columns (ShardedColumn/memmap)
            # batch by batch
            yield {c: np.asarray(self._columns[c][start:start + batch_size])
                   for c in cols}

    def num_batches(self, batch_size: int, drop_remainder: bool = True) -> int:
        n = len(self)
        return n // batch_size if drop_remainder else -(-n // batch_size)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_arrays(**columns) -> "Dataset":
        return Dataset(columns)

    @staticmethod
    def from_files(columns: Dict[str, Union[str, Sequence[str]]],
                   mmap: bool = True) -> "Dataset":
        """File-backed dataset from ``.npy`` files: one path or a list of
        shard paths per column (SURVEY §7's "input pipeline" hard part —
        ImageNet-scale epochs must be feedable without host-RAM residency).

        With ``mmap=True`` (default) every file is ``np.load``-ed with
        ``mmap_mode="r"``: rows are read from disk only when a staging
        chunk materializes them, so training streams the epoch in O(chunk)
        host memory (`substrate.stage_epoch_chunks` + `staging_rounds=`).
        Multi-file columns are presented as one logical column via
        :class:`ShardedColumn` — shard boundaries need not align with
        worker or chunk boundaries.

        ``shuffle()`` on a file-backed dataset is a streaming shuffle: it
        returns lazy :class:`PermutedColumn` views and rows are read from
        disk O(chunk) at a time during staging (random-access reads; for
        spinning disks, pre-shuffled shard files are still friendlier).
        """
        cols: Dict[str, ColumnLike] = {}
        mode = "r" if mmap else None
        for name, paths in columns.items():
            if isinstance(paths, (str, bytes)) or hasattr(paths, "__fspath__"):
                paths = [paths]
            parts = [np.load(p, mmap_mode=mode) for p in paths]
            cols[name] = parts[0] if len(parts) == 1 else ShardedColumn(parts)
        return Dataset(cols)

    @staticmethod
    def concat(parts: Sequence["Dataset"]) -> "Dataset":
        """Concatenate datasets row-wise. When any input column is lazy
        (memmap / ShardedColumn / PermutedColumn) the result column is a
        ShardedColumn over the parts — no bytes are read; in-memory inputs
        concatenate eagerly as before."""
        cols = parts[0].columns
        out: Dict[str, ColumnLike] = {}
        for c in cols:
            vs = [p[c] for p in parts]
            lazy = any(isinstance(
                v, (ShardedColumn, np.memmap, PermutedColumn)) for v in vs)
            # mixed dtypes fall back to eager concatenation, which PROMOTES
            # (f32 + f64 -> f64) the way plain np.concatenate always did;
            # the lazy view requires one common dtype
            if lazy and len({np.dtype(v.dtype) for v in vs}) == 1:
                out[c] = vs[0] if len(vs) == 1 else ShardedColumn(vs)
            else:
                out[c] = np.concatenate([np.asarray(v) for v in vs])
        return Dataset(out)


def synthetic_mnist(n: int = 4096, seed: int = 0,
                    features_col: str = "features",
                    label_col: str = "label") -> Dataset:
    """Deterministic MNIST-shaped synthetic data (for tests and smoke benches).

    Labels are a (noisy) linear function of the features so that learning is
    actually possible and convergence tests mean something.
    """
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 784)).astype(np.float32)
    w = rng.standard_normal((784, 10)).astype(np.float32) * 0.3
    logits = x @ w + 0.05 * rng.standard_normal((n, 10)).astype(np.float32)
    y = logits.argmax(-1).astype(np.int32)
    onehot = np.eye(10, dtype=np.float32)[y]
    return Dataset({features_col: x, label_col: onehot, "label_index": y})
