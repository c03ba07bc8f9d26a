"""Multi-process entry points (port of ``distkeras_tpu/parallel/distributed.py``
and of the two ``jax.experimental.multihost_utils`` helpers the JAX package
uses).

The JAX package joins jax's coordination service and builds meshes over
every process's devices. The port's counterpart of that service is a
``torch.distributed`` process group:

- :func:`initialize` is a no-op on a plain host (no launcher environment,
  no arguments), so training scripts run unchanged on one card; with a
  launcher's environment (torchrun's ``MASTER_ADDR`` / ``WORLD_SIZE`` /
  ``RANK``) or explicit arguments it joins the group with an explicit
  ``timeout`` (a peer that never arrives fails the collective instead of
  hanging the job);
- the default group is ``gloo``: the host-side agreement plane
  (:func:`process_allgather`, :func:`broadcast_one_to_all`,
  :func:`barrier`) and the folds of host tensors. The folds of card
  tensors go over :func:`fold_group`'s group, which the layout chooses:
  when every rank holds a card of its own (told apart by the cards'
  UUIDs) an NCCL group beside the gloo one, made once; when some ranks
  share a card, the gloo group, staged through the host (NCCL refuses
  two ranks of one communicator on one card, the one-card host's case).
  Nothing falls back from NCCL to gloo: a group that fails to form or a
  collective that fails raises on every rank;
- the host helpers move fixed-size numpy payloads as tensors (JAX's
  512-byte address payload is one). Nothing here pickles: no
  ``*_object`` collective is used, so nothing on a wire can execute code;
- :func:`multihost_mesh` is :func:`~distkeras_tpu_torch.parallel.mesh.make_mesh`,
  which spans every process's devices inside a group, model axis
  included (a row inside a process, or across processes);
- :func:`determine_host_address` reads this host's address from its own
  name and never opens a socket to another host (the JAX helper connects
  a UDP socket towards a public address to pick an interface).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch

#: seconds a collective of the group waits for its peers before failing
DEFAULT_TIMEOUT_S = 300.0

#: (world size, card index) -> (group, backend) of the folds of card tensors
_CARDS: dict = {}

#: the timeout the group was joined with (the NCCL group takes the same)
_TIMEOUT = {"s": DEFAULT_TIMEOUT_S}


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


def joined() -> bool:
    """True inside an initialized ``torch.distributed`` group."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The group's world size (1 outside a group)."""
    return torch.distributed.get_world_size() if joined() else 1


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    return torch.distributed.get_rank() if joined() else 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (the multi-process entry point).

    With no arguments and no launcher environment it is a no-op. Else it
    calls ``torch.distributed.init_process_group("gloo", timeout=...)``:
    explicit arguments give ``tcp://{coordinator_address}``,
    ``num_processes`` and ``process_id``; a launcher's environment gives
    ``env://``. ``local_device_ids[0]`` selects this process's card (JAX's
    ``local_device_ids``), else a launcher's ``LOCAL_RANK`` does
    (torchrun's idiom). Joining a group that this process already joined
    is a no-op."""
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
    card = local_device_ids[0] if local_device_ids \
        else os.environ.get("LOCAL_RANK")
    if card is not None and torch.cuda.is_available():
        torch.cuda.set_device(int(card))
    timeout = datetime.timedelta(seconds=float(timeout_s))
    _CARDS.clear()
    _TIMEOUT["s"] = float(timeout_s)
    if explicit:
        dist.init_process_group("gloo",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes),
                                rank=int(process_id), timeout=timeout)
    else:
        dist.init_process_group("gloo", init_method="env://",
                                timeout=timeout)


def _require_gloo() -> None:
    """Raise unless the default group is gloo (as :func:`initialize`
    makes it): the host helpers and the folds run over it."""
    backend = torch.distributed.get_backend()
    if backend != "gloo":
        raise RuntimeError(
            f"the port's process group must be gloo (distributed.initialize "
            f"joins one); this process joined a {backend!r} group")


def process_allgather(value) -> np.ndarray:
    """Every process's ``value`` (a numpy array or scalar of the same
    shape and dtype on every process), stacked in rank order:
    ``[process_count, *shape]``. Outside a group: ``value[None]``. Every
    process must call it (a collective)."""
    arr = np.ascontiguousarray(np.asarray(value))
    if process_count() == 1:
        return arr[None].copy()
    _require_gloo()
    t = torch.from_numpy(arr.reshape(-1).copy())
    out = [torch.empty_like(t) for _ in range(process_count())]
    torch.distributed.all_gather(out, t)
    return np.stack([o.numpy().reshape(arr.shape) for o in out])


def broadcast_one_to_all(value, source: int = 0):
    """Process ``source``'s ``value`` (process 0's by default) on every
    process: a numpy array (same shape and dtype everywhere), or a name
    -> array dict (each leaf broadcast in key order). Outside a group:
    ``value`` unchanged."""
    if isinstance(value, dict):
        return {k: broadcast_one_to_all(value[k], source)
                for k in sorted(value)}
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(value))
    if process_count() == 1:
        return arr
    _require_gloo()
    t = torch.from_numpy(arr.reshape(-1).copy())
    torch.distributed.broadcast(t, src=int(source))
    return t.numpy().reshape(arr.shape)


def barrier() -> None:
    """Every process reaches this point before any leaves it (JAX's
    ``sync_global_devices``). Outside a group: nothing."""
    if process_count() > 1:
        _require_gloo()
        torch.distributed.barrier()


def encode_payload(text: str, size: int = 512) -> np.ndarray:
    """``text`` as a zero-padded ``uint8[size]`` payload (raises when it
    does not fit)."""
    raw = text.encode()
    if len(raw) > size:
        raise ValueError(f"payload {raw!r} longer than {size} bytes")
    payload = np.zeros((size,), np.uint8)
    payload[:len(raw)] = np.frombuffer(raw, np.uint8)
    return payload


def decode_payload(payload) -> str:
    """The text of an :func:`encode_payload` payload."""
    row = np.asarray(payload)
    return bytes(row[row != 0]).decode()


def card_uuid(index: int) -> str:
    """The UUID of card ``index`` (the same card has the same UUID in
    every process, whatever ``CUDA_VISIBLE_DEVICES`` numbers it)."""
    return str(torch.cuda.get_device_properties(int(index)).uuid)


def fold_group(device=None) -> tuple:
    """``(group, backend)`` of the tensor folds across processes of
    tensors on ``device`` (default the CPU). Outside a group: ``(None,
    None)``. Host tensors fold over the gloo default group: ``(None,
    "gloo")``.

    For a card, the first call a (world size, card) is a collective of
    every rank: each rank's card UUID is all-gathered. When every rank
    holds a card of its own, every rank then makes one
    ``torch.distributed.new_group(backend="nccl")`` beside the default
    group, with its timeout, and forms its communicator at once with an
    all-reduce of a scalar on the card, every rank joining (a hop, which
    joins two ranks, may not be a group's first NCCL call): ``(group,
    "nccl")``, the folds on the cards. Both run with the card as the
    current device, which stays what it was for the rest of the process.
    When some ranks share a card, ``(None, "gloo")``: the folds staged
    through the host. Every rank folds tensors on the same kind of
    device and calls this in the same order.
    ``torch.distributed.destroy_process_group()`` ends the NCCL group
    with the default one (newest first)."""
    if process_count() == 1:
        return None, None
    _require_gloo()
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return None, "gloo"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (process_count(), index)
    if key not in _CARDS:
        rows = process_allgather(encode_payload(card_uuid(index)))
        if len({decode_payload(r) for r in rows}) == process_count():
            with torch.cuda.device(index):
                group = torch.distributed.new_group(
                    backend="nccl",
                    timeout=datetime.timedelta(seconds=_TIMEOUT["s"]))
                torch.distributed.all_reduce(
                    torch.zeros((), device=torch.device("cuda", index)),
                    group=group)
            _CARDS[key] = (group, "nccl")
        else:
            _CARDS[key] = (None, "gloo")
    return _CARDS[key]


def multihost_mesh(num_workers: Optional[int] = None,
                   model_parallelism: int = 1,
                   devices: Optional[Sequence] = None):
    """The (workers, model) mesh over every process's devices:
    :func:`~distkeras_tpu_torch.parallel.mesh.make_mesh`, whose ``devices``
    (default this process's card) are this process's, every process passing as
    many, reshaped row-major into (workers, model) as JAX reshapes
    ``jax.devices()``. In one process, the one-process mesh."""
    from distkeras_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(num_workers, model_parallelism=model_parallelism,
                              devices=devices)


def process_info() -> dict:
    """Topology snapshot for logging and debugging."""
    if torch.cuda.is_available():
        local = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        local = ["cpu"]
    count = process_count()
    return {
        "process_index": process_index(),
        "process_count": count,
        "local_devices": local,
        "global_device_count": len(local) * count,
        "host_address": determine_host_address(),
    }
