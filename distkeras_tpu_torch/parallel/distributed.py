"""Multi-process entry points (port of ``distkeras_tpu/parallel/distributed.py``),
the one-process parts.

The JAX package joins jax's coordination service and builds meshes over
every process's devices. The port's counterpart of that service is a
``torch.distributed`` process group:

- :func:`initialize` is a no-op on a plain host (no launcher environment,
  no arguments), so training scripts run unchanged on one card; with a
  launcher's environment (torchrun's ``MASTER_ADDR`` / ``WORLD_SIZE`` /
  ``RANK``) or explicit arguments it joins the group
  (``init_process_group``). Collectives across processes are not ported
  (ROADMAP.md Queue A, item 16): once the group holds more than one
  process, every mesh raises through
  :func:`~distkeras_tpu_torch.parallel.mesh.check_single_process`;
- :func:`multihost_mesh` degrades to
  :func:`~distkeras_tpu_torch.parallel.mesh.make_mesh` in one process;
- :func:`determine_host_address` reads this host's address from its own
  name and never opens a socket to another host (the JAX helper connects
  a UDP socket towards a public address to pick an interface).
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

import torch

from distkeras_tpu_torch.parallel import mesh as mesh_lib


def determine_host_address() -> str:
    """This host's address as its name resolves (``127.0.0.1`` when the
    name does not resolve)."""
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _cluster_env_present() -> bool:
    """True when a launcher's environment is visible: torchrun's (or any
    ``env://`` launcher's) ``MASTER_ADDR``, ``WORLD_SIZE`` and ``RANK``."""
    return all(os.environ.get(k) for k in ("MASTER_ADDR", "WORLD_SIZE",
                                           "RANK"))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Join the process group (the multi-process entry point).

    With no arguments and no launcher environment it is a no-op. Else it
    calls ``torch.distributed.init_process_group``: explicit arguments
    give ``tcp://{coordinator_address}``, ``num_processes`` and
    ``process_id``; a launcher's environment gives ``env://``.
    ``local_device_ids[0]`` selects this process's card. The backend is
    ``nccl`` with a card, else ``gloo``. Joining a group that this
    process already joined is a no-op."""
    dist = torch.distributed
    explicit = any(a is not None for a in
                   (coordinator_address, num_processes, process_id))
    if not explicit and not _cluster_env_present():
        return  # plain single host: nothing to coordinate
    if dist.is_initialized():
        return
    if explicit and None in (coordinator_address, num_processes,
                             process_id):
        raise ValueError(
            "initialize() with explicit arguments needs all of "
            "coordinator_address, num_processes and process_id (or none of "
            "them, with a launcher's MASTER_ADDR/WORLD_SIZE/RANK)")
    if local_device_ids and torch.cuda.is_available():
        torch.cuda.set_device(int(local_device_ids[0]))
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if explicit:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes),
                                rank=int(process_id))
    else:
        dist.init_process_group(backend, init_method="env://")


def multihost_mesh(num_workers: Optional[int] = None,
                   model_parallelism: int = 1,
                   devices: Optional[Sequence] = None) -> mesh_lib.Mesh:
    """The (workers, model) mesh over every process's devices: in one
    process, :func:`~distkeras_tpu_torch.parallel.mesh.make_mesh` over
    ``devices`` (default ``[cuda:0]``); across processes it raises
    (item 16)."""
    mesh_lib.check_single_process("multihost_mesh")
    return mesh_lib.make_mesh(num_workers, model_parallelism=model_parallelism,
                              devices=devices)


def process_info() -> dict:
    """Topology snapshot for logging and debugging."""
    dist = torch.distributed
    joined = dist.is_available() and dist.is_initialized()
    if torch.cuda.is_available():
        local = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        local = ["cpu"]
    count = dist.get_world_size() if joined else 1
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": count,
        "local_devices": local,
        "global_device_count": len(local) * count,
        "host_address": determine_host_address(),
    }
