"""Sequence (context) parallelism (port of
``distkeras_tpu/parallel/sequence.py``): the long-context training step.

The SEQUENCE of a causal LM is cut over the ``seq`` axis of a workers x
``seq`` mesh and the batch over ``workers``. The model is a
``CausalLM(attention="ring")``: each worker runs its row of sequence
blocks through the ring forward (:mod:`~distkeras_tpu_torch.models.gpt`,
:mod:`~distkeras_tpu_torch.ops.ring_attention`), so a shard holds
``[B, H, T/P, T/P]`` logits at a time instead of ``[B, H, T, T]``.

The loss is the exact global token mean: every shard's summed token
NLL, over the global count of valid labels. As in the JAX package the
gradients are those of the summed NLL, folded over every shard (the
psum: autograd sums each worker's shards into the one copy of the
parameters, and the workers' backward passes accumulate), then divided
by the global count. So a workers x seq step equals the single-device
step on the same global batch up to summation order.

In one process, on a mesh that may repeat a device (``["cuda:0"] * 4``
on a one-card host, ``["cpu"] * 8`` in the tests): the parameters live
on the mesh's home and each shard computes on them there. Memory is then
the sum of every shard's folds on one card; the ring changes where the
logits are cut, not how much one card holds. On a mesh over several
cards (the default on a host with several) a shard on another card
computes there through a replica of the weights (gpt's ring forward),
whose gradients are summed back onto the home's parameters: the shards'
folds then spread over the cards.

Over a process group the mesh lays every process's devices end to end
(:func:`make_sp_mesh`, as ``make_mesh`` does) and each process holds a
copy of the parameters on its own home. A worker row inside a process
runs there whole; a row that spans processes gives each process its own
blocks only, the others standing as
:class:`~distkeras_tpu_torch.ops.ring_attention.Remote`, and the ring's
hops cross between them. Each process's summed NLL, token count and
gradients then go through
:func:`~distkeras_tpu_torch.parallel.collectives.cross_process_sum` (JAX's
psum) before the one division by the global count, so every process
applies the same update.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from distkeras_tpu_torch import engine
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.models import gpt
from distkeras_tpu_torch.ops import losses
from distkeras_tpu_torch.ops import ring_attention as ring_lib
from distkeras_tpu_torch.ops.optimizers import OptimizerFactory
from distkeras_tpu_torch.parallel import collectives
from distkeras_tpu_torch.parallel import mesh as mesh_lib
from distkeras_tpu_torch.parallel.mesh import WORKER_AXIS, Mesh

SEQ_AXIS = "seq"


def make_sp_mesh(num_workers: int = 1, seq_parallelism: int = 1,
                 devices=None) -> Mesh:
    """A (workers, seq) mesh: batch parallelism outer, sequence inner,
    over ``devices`` (default
    :func:`~distkeras_tpu_torch.device.visible_devices`: every visible
    card, raising without one), which may repeat a device. Asking for more
    devices than are listed raises ValueError, as JAX's does. Inside a
    process group ``devices`` are this process's, every process passing
    as many, and the mesh lays them end to end in rank order."""
    devices, owners = mesh_lib.global_devices(devices)
    need = int(num_workers) * int(seq_parallelism)
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh([resolve_device(d) for d in devices[:need]],
                model_parallelism=seq_parallelism,
                axis_names=(WORKER_AXIS, SEQ_AXIS), owners=owners[:need])


def shift_labels(input_ids: np.ndarray) -> np.ndarray:
    """Host-side next-token labels: ``labels[t] = ids[t + 1]``, the final
    position ignored (-1). Done on the global sequence BEFORE it is cut,
    so block boundaries need no shift between shards."""
    labels = np.full_like(np.asarray(input_ids), -1)
    labels[:, :-1] = input_ids[:, 1:]
    return labels


def _check_ring(model) -> None:
    if getattr(model, "attention", None) != "ring":
        raise ValueError("sequence parallelism needs a CausalLM built with "
                         "attention='ring'")


def init_sp_state(model, tx: OptimizerFactory, mesh: Mesh,
                  batch_shape: Optional[Tuple[int, int]] = None,
                  seed: int = 0) -> engine.TrainState:
    """Seeded weights (``gpt.init_params``: the ``"full"`` twin's, since
    every attention mode shares them) on the mesh's home, and the
    optimizer over them. ``batch_shape`` (the JAX signature's init
    sample) is not needed: the module knows its shapes."""
    del batch_shape
    _check_ring(model)
    gpt.init_params(model, torch.Generator().manual_seed(int(seed)))
    model.to(mesh.home)
    return engine.TrainState(step=0, model=model,
                             opt_state=tx(model.parameters()))


def build_sp_train_step(model, tx: OptimizerFactory, mesh: Mesh):
    """The sequence-parallel LM train step over ``mesh``.

    Returns ``(step_fn, place_state, place_batch)``:

    - ``place_batch({"input_ids": [B, T], "labels": [B, T]})`` cuts B
      over ``workers`` and T over ``seq``: block ``(w, j)`` on
      ``mesh.device(w, j)``, as nested lists, one a worker row of this
      process's (every row in one process; a block another process
      holds is a ``Remote``); labels < 0 are ignored. Over processes
      every process passes the same global batch;
    - ``place_state(state)`` puts the state's module on the mesh's home;
    - ``step_fn(state, batch) -> (state, metrics)`` (a batch not yet
      placed is placed first) updates the parameters in place with the
      state's optimizer (built from ``tx``, a factory, as in
      ``engine.make_train_step``); metrics are the global mean ``loss``
      and token ``accuracy``, 0-d float32 tensors on the home.

    The model must be built with ``attention="ring"``.
    """
    _check_ring(model)
    workers, seq = mesh.shape[WORKER_AXIS], mesh.shape[SEQ_AXIS]
    home = mesh.home
    spans = mesh.spans_processes
    rows = mesh_lib.local_worker_positions(mesh)

    def place_state(state: engine.TrainState) -> engine.TrainState:
        state.model.to(home)
        return state

    def place_batch(batch) -> dict:
        out = {}
        for key in ("input_ids", "labels"):
            x = torch.as_tensor(np.asarray(batch[key]))
            b, t = x.shape
            if b % workers or t % seq:
                raise ValueError(
                    f"{key} {tuple(x.shape)} does not split over {workers} "
                    f"workers x {seq} sequence shards")
            cut = list(x.chunk(workers, dim=0))
            out[key] = [[c.to(mesh.device(w, j)) if mesh.owns(w, j) else
                         ring_lib.Remote(mesh.device_owners[w][j])
                         for j, c in enumerate(cut[w].chunk(seq, dim=1))]
                        for w in rows]
        return out

    def step_fn(state: engine.TrainState, batch):
        if not isinstance(batch["input_ids"], list):
            batch = place_batch(batch)
        m = state.model
        m.zero_grad(set_to_none=True)
        zero = lambda: torch.zeros((), dtype=torch.float32, device=home)
        nll, hits, count = zero(), zero(), zero()
        for ids, labels in zip(batch["input_ids"], batch["labels"]):
            collectives.new_chain()  # each row's backward is its own
            terms = [losses.masked_lm_terms(lg, lab)
                     for lg, lab in zip(m(ids), labels)
                     if not ring_lib.is_remote(lg)]
            worker_nll = sum(t[0].to(home) for t in terms)
            worker_nll.backward()  # the workers' gradients accumulate
            with torch.no_grad():
                nll += worker_nll.detach()
                hits += sum(t[1].to(home) for t in terms)
                count += sum(t[2].to(home) for t in terms)
        if spans:  # JAX's psum of the terms and gradients
            collectives.flush_hops()
            with torch.no_grad():
                tree = {f"g/{n}": torch.zeros_like(p) if p.grad is None
                        else p.grad for n, p in m.named_parameters()}
                tree.update(nll=nll, hits=hits, count=count)
                tree = collectives.cross_process_sum(tree)
                nll, hits, count = tree["nll"], tree["hits"], tree["count"]
                for n, p in m.named_parameters():
                    p.grad = tree[f"g/{n}"]
        with torch.no_grad():
            count = torch.clamp(count, min=1.0)
            for p in m.parameters():
                if p.grad is not None:
                    p.grad /= count
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        return (engine.TrainState(step=state.step + 1, model=m,
                                  opt_state=state.opt_state),
                {"loss": nll / count, "accuracy": hits / count})

    return step_fn, place_state, place_batch
