"""Device meshes (port of ``distkeras_tpu/parallel/mesh.py``): the
cluster abstraction.

The JAX package's cluster is a ``jax.sharding.Mesh`` with a ``workers``
axis of data-parallel replicas and a ``model`` axis over which
:mod:`~distkeras_tpu_torch.parallel.tensor` shards parameters. The
port's :class:`Mesh` is the same workers x model grid of torch devices,
row-major: worker ``w`` holds the row ``grid[w]``, its model positions
``grid[w][m]``. ``devices`` lists the workers axis (each row's first
device), which is where the substrate, the predictors and the serving
engine place their replicas. Every device of a port mesh lives in this
process unless the mesh spans a process group (below). The second axis
may take another name:
:mod:`~distkeras_tpu_torch.parallel.sequence`'s workers x ``seq`` grid
and :mod:`~distkeras_tpu_torch.parallel.pipeline`'s one row of
``stages`` are the same grid.

Inside a ``torch.distributed`` group of P processes a mesh spans them:
:func:`make_mesh` lays every process's ``devices`` (each process passes
as many) end to end in rank order, row-major, as JAX reshapes
``jax.devices()`` into (workers, model). Ownership is per device:
``Mesh.device_owners[w][m]`` is the process that holds ``grid[w][m]``, and
``Mesh.owners[w]`` is the process of row ``w``'s first device (the row's
lead). A device owned by another process names that process's device in
its own numbering (``cuda:0`` on each of two hosts). Two layouts come out
of it: with ``model_parallelism`` dividing a process's device count, rows
lie inside a process; with a process's device count dividing
``model_parallelism``, a row spans whole processes (one device a process
at model 2 over two processes: a 1 x 2 mesh whose row both hold). A
worker row is local to every process that holds one of its devices
(:func:`local_worker_positions`, JAX's rule), and :attr:`Mesh.home` is
this process's first own device. A mesh built by hand (``Mesh(devices)``)
belongs to the process that builds it.

The substrate runs ``K = D * factor`` logical workers on a mesh of D
worker devices: worker ``k`` lives on ``devices[k // factor]``. By default
a mesh takes every visible card, as JAX's takes ``jax.devices()``; on a
host with one card the mesh is ``[cuda:0]`` and the K replicas are stacked
there (the trainers' ``parallelism_factor``). A mesh may repeat a device,
as the tests repeat ``cpu`` (and a one-card host repeats ``cuda:0``) to
get two-level layouts and workers x model grids without more cards.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from distkeras_tpu_torch import device as device_lib
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.parallel import distributed

WORKER_AXIS = "workers"
MODEL_AXIS = "model"


class Mesh:
    """A workers x model grid of devices, from ``devices`` listed
    row-major (``len(devices) / model_parallelism`` workers of
    ``model_parallelism`` positions each). ``shape`` maps each axis name
    (``axis_names``, outer then inner) to its size, as a JAX mesh's
    does."""

    def __init__(self, devices: Sequence, model_parallelism: int = 1,
                 axis_names: Sequence[str] = (WORKER_AXIS, MODEL_AXIS),
                 owners: Optional[Sequence[int]] = None):
        model_parallelism = int(model_parallelism)
        self.axis_names = tuple(axis_names)
        if not devices:
            raise ValueError("a Mesh needs at least one device")
        if model_parallelism < 1 or len(devices) % model_parallelism:
            raise ValueError(
                f"{len(devices)} devices do not form rows of "
                f"model_parallelism={model_parallelism}")
        flat = [torch.device(d) for d in devices]
        #: ``grid[w][m]``: the device of worker ``w``, model position ``m``
        self.grid = [flat[i:i + model_parallelism]
                     for i in range(0, len(flat), model_parallelism)]
        #: the workers axis: each worker's first device
        self.devices = [row[0] for row in self.grid]
        me = distributed.process_index()
        if owners is None:  # a mesh built by hand is this process's
            owners = [me] * len(flat)
        owners = [int(o) for o in owners]
        if len(owners) != len(flat):
            raise ValueError(f"{len(owners)} owners for {len(flat)} "
                             f"devices")
        #: ``device_owners[w][m]``: the process that holds ``grid[w][m]``
        self.device_owners = [owners[i:i + model_parallelism]
                              for i in range(0, len(owners),
                                             model_parallelism)]
        #: ``owners[w]``: the process of row ``w``'s first device (the
        #: row's lead, which counts the row in a fold over processes)
        self.owners = [row[0] for row in self.device_owners]

    @property
    def shape(self) -> dict:
        outer, inner = self.axis_names
        return {outer: len(self.grid), inner: len(self.grid[0])}

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` at position 0 of the other axis."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has axes {self.axis_names}, not {axis!r}")
        return list(self.devices if axis == self.axis_names[0]
                    else self.grid[0])

    @property
    def home(self) -> torch.device:
        """The device the center (the parameter server's state) and the
        metrics live on: this process's first own device (the first
        worker's in one process)."""
        me = distributed.process_index()
        for row, owners in zip(self.grid, self.device_owners):
            for dev, owner in zip(row, owners):
                if owner == me:
                    return dev
        return self.devices[0]

    @property
    def spans_processes(self) -> bool:
        """True when another process holds a device of the mesh."""
        return len({o for row in self.device_owners for o in row}) > 1

    def owns(self, worker: int, model: int = 0) -> bool:
        """True when this process holds the device at (``worker``,
        ``model``)."""
        return self.device_owners[worker][model] == \
            distributed.process_index()

    @property
    def row_processes(self) -> int:
        """How many processes hold a device of each worker row: 1 when
        rows lie inside a process, else the processes a row spans. Rows
        over processes must span whole processes, each process holding as
        many of a row's devices (the rows' process sets equal or
        disjoint): another layout raises ValueError."""
        sets = [tuple(sorted(set(row))) for row in self.device_owners]
        size = len(sets[0])
        ok = all(len(s) == size for s in sets) and all(
            a == b or not set(a) & set(b) for a in sets for b in sets) \
            and all(row.count(o) * size == len(row)
                    for row in self.device_owners for o in set(row))
        if not ok:
            raise ValueError(
                f"mesh rows over processes {self.device_owners}: a row must "
                f"lie inside a process or span whole processes, each holding "
                f"as many of its devices")
        return size

    def device(self, worker: int, model: int = 0) -> torch.device:
        """The device at (``worker``, ``model``) of the grid."""
        return self.grid[worker][model]

    def __repr__(self) -> str:
        flat = [str(d) for row in self.grid for d in row]
        if self.spans_processes:
            return f"Mesh({flat}, model_parallelism={len(self.grid[0])}, " \
                f"owners={self.device_owners})"
        if self.axis_names != (WORKER_AXIS, MODEL_AXIS):
            return f"Mesh({flat}, axes={self.shape})"
        if len(self.grid[0]) == 1:
            return f"Mesh({flat})"
        return f"Mesh({flat}, model_parallelism={len(self.grid[0])})"


def global_devices(devices: Optional[Sequence] = None) -> tuple:
    """``(devices, owners)``: this process's ``devices`` (default
    :func:`~distkeras_tpu_torch.device.visible_devices`: every card in one
    process, this process's card in a group) laid end to end with every
    other process's in rank order (each process passes as many), and the
    process that owns each. In one process: ``devices``, all owned by
    it."""
    devices = list(devices) if devices is not None \
        else device_lib.visible_devices()
    count = distributed.process_count()
    return devices * count, [p for p in range(count) for _ in devices]


def make_mesh(num_workers: Optional[int] = None,
              model_parallelism: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (workers, model) mesh over ``devices`` (default
    :func:`~distkeras_tpu_torch.device.visible_devices`: every visible
    card, ``[cuda:0]`` on a one-card host, raising without a card), which
    may repeat a device. ``num_workers=None`` uses every device:
    ``len(devices) // model_parallelism`` workers. Asking for more
    devices than are listed raises ValueError, as JAX's does.

    Inside a group of P processes ``devices`` are this process's, every
    process passes as many, and the mesh is over all of them, process 0's
    first (JAX's global device list), each device owned by the process
    that passed it: a row lies inside a process or spans several (module
    docstring). No collective runs."""
    model_parallelism = int(model_parallelism)
    if model_parallelism < 1:
        raise ValueError(
            f"model_parallelism must be >= 1, got {model_parallelism}")
    devices, owners = global_devices(devices)
    if num_workers is None:
        num_workers = len(devices) // model_parallelism
    need = num_workers * model_parallelism
    if need > len(devices):
        raise ValueError(
            f"Mesh needs {need} devices ({num_workers} workers x "
            f"{model_parallelism} model shards) but only {len(devices)} "
            f"are visible")
    return Mesh([resolve_device(d) for d in devices[:need]],
                model_parallelism=model_parallelism, owners=owners[:need])


def local_worker_positions(mesh: Mesh) -> list:
    """Worker-axis positions this process runs (JAX's positions with a
    device owned by this process): every position in one process, so
    host-sharded staging is then the replicated case; a row that spans
    processes is local to each of them."""
    me = distributed.process_index()
    return [w for w, owners in enumerate(mesh.device_owners) if me in owners]


def put_replicated(tree: dict, mesh: Mesh) -> dict:
    """A copy of ``tree`` (name -> tensor or array) on the mesh's home
    device: the center every worker reads."""
    return {n: torch.as_tensor(x).detach().to(mesh.home, copy=True)
            for n, x in tree.items()}


def worker_device(mesh: Mesh, k: int, factor: int) -> torch.device:
    """The device of logical worker ``k`` when each device holds
    ``factor`` stacked replicas."""
    return mesh.devices[k // factor]
