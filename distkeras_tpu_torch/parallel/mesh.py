"""Device meshes (port of ``distkeras_tpu/parallel/mesh.py``): the
cluster abstraction.

The JAX package's cluster is a ``jax.sharding.Mesh`` with a ``workers``
axis of data-parallel replicas and a ``model`` axis. The port's
:class:`Mesh` is an ordered list of torch devices on the ``workers``
axis, with a ``model`` axis of 1 (tensor parallelism waits for ROADMAP.md
Queue A, item 16). Every device of a port mesh lives in this process; a
mesh over several processes (a NCCL or gloo group) is item 16 too.

The substrate runs ``K = D * factor`` logical workers on a mesh of D
devices: worker ``k`` lives on ``devices[k // factor]``. On a host with
one card the mesh is ``[cuda:0]`` and the K replicas are stacked there
(the trainers' ``parallelism_factor``). A mesh may repeat a device, as
the tests repeat ``cpu`` to get two-level layouts (D devices x K/D
replicas) without a second card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from distkeras_tpu_torch.device import resolve_device

WORKER_AXIS = "workers"
MODEL_AXIS = "model"


class Mesh:
    """An ordered list of devices on the ``workers`` axis. ``shape`` maps
    each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a Mesh needs at least one device")
        self.devices = [torch.device(d) for d in devices]

    @property
    def shape(self) -> dict:
        return {WORKER_AXIS: len(self.devices), MODEL_AXIS: 1}

    @property
    def home(self) -> torch.device:
        """The device the center (the parameter server's state) and the
        metrics live on: the first worker's."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def check_single_process(what: str = "a mesh") -> None:
    """Raise NotImplementedError when this process is one of several in
    an initialized ``torch.distributed`` group: collectives across
    processes are not ported."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"{what} over {dist.get_world_size()} processes needs the "
            f"cross-process collectives, which are not ported (ROADMAP.md "
            f"Queue A, item 16, parallel/collectives.py)")


def make_mesh(num_workers: Optional[int] = None,
              model_parallelism: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``workers`` mesh over ``devices`` (default ``[resolve_device(None)]``:
    ``cuda:0``, raising without a card). ``num_workers=None`` uses every
    device; asking for more workers than devices raises ValueError, as
    JAX's does."""
    if int(model_parallelism) != 1:
        raise NotImplementedError(
            f"model_parallelism={model_parallelism}: tensor-sharded meshes "
            f"are not ported (ROADMAP.md Queue A, item 16, "
            f"parallel/tensor.py)")
    check_single_process()
    devices = list(devices) if devices is not None \
        else [resolve_device(None)]
    if num_workers is None:
        num_workers = len(devices)
    if num_workers > len(devices):
        raise ValueError(
            f"Mesh needs {num_workers} devices ({num_workers} workers x "
            f"{model_parallelism} model shards) but only {len(devices)} "
            f"are visible")
    return Mesh([resolve_device(d) for d in devices[:num_workers]])


def local_worker_positions(mesh: Mesh) -> list:
    """Worker-axis positions with a device in this process: all of them
    (a port mesh lives in one process), so host-sharded staging is the
    replicated case."""
    return list(range(len(mesh.devices)))


def put_replicated(tree: dict, mesh: Mesh) -> dict:
    """A copy of ``tree`` (name -> tensor or array) on the mesh's home
    device: the center every worker reads."""
    return {n: torch.as_tensor(x).detach().to(mesh.home, copy=True)
            for n, x in tree.items()}


def worker_device(mesh: Mesh, k: int, factor: int) -> torch.device:
    """The device of logical worker ``k`` when each device holds
    ``factor`` stacked replicas."""
    return mesh.devices[k // factor]
