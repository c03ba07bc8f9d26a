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
on the mesh's home and each shard computes on them there, so the
shards' devices must be the home device (gpt's ring forward checks).
Memory is therefore the sum of every shard's folds on one card; the
ring changes where the logits are cut, not how much one card holds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from distkeras_tpu_torch import engine
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.models import gpt
from distkeras_tpu_torch.ops import losses
from distkeras_tpu_torch.ops.optimizers import OptimizerFactory
from distkeras_tpu_torch.parallel import mesh as mesh_lib
from distkeras_tpu_torch.parallel.mesh import WORKER_AXIS, Mesh

SEQ_AXIS = "seq"


def make_sp_mesh(num_workers: int = 1, seq_parallelism: int = 1,
                 devices=None) -> Mesh:
    """A (workers, seq) mesh: batch parallelism outer, sequence inner,
    over ``devices`` (default ``[resolve_device(None)]``: ``cuda:0``,
    raising without a card), which may repeat a device. Asking for more
    devices than are listed raises ValueError, as JAX's does."""
    mesh_lib.check_single_process("a sequence-parallel mesh")
    devices = list(devices) if devices is not None \
        else [resolve_device(None)]
    need = int(num_workers) * int(seq_parallelism)
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh([resolve_device(d) for d in devices[:need]],
                model_parallelism=seq_parallelism,
                axis_names=(WORKER_AXIS, SEQ_AXIS))


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
    mesh_lib.check_single_process("a sequence-parallel mesh")
    gpt.init_params(model, torch.Generator().manual_seed(int(seed)))
    model.to(mesh.home)
    return engine.TrainState(step=0, model=model,
                             opt_state=tx(model.parameters()))


def build_sp_train_step(model, tx: OptimizerFactory, mesh: Mesh):
    """The sequence-parallel LM train step over ``mesh``.

    Returns ``(step_fn, place_state, place_batch)``:

    - ``place_batch({"input_ids": [B, T], "labels": [B, T]})`` cuts B
      over ``workers`` and T over ``seq``: block ``(w, j)`` on
      ``mesh.device(w, j)``, as nested lists; labels < 0 are ignored;
    - ``place_state(state)`` puts the state's module on the mesh's home;
    - ``step_fn(state, batch) -> (state, metrics)`` (a batch not yet
      placed is placed first) updates the parameters in place with the
      state's optimizer (built from ``tx``, a factory, as in
      ``engine.make_train_step``); metrics are the global mean ``loss``
      and token ``accuracy``, 0-d float32 tensors on the home.

    The model must be built with ``attention="ring"``.
    """
    mesh_lib.check_single_process("a sequence-parallel mesh")
    _check_ring(model)
    workers, seq = mesh.shape[WORKER_AXIS], mesh.shape[SEQ_AXIS]
    home = mesh.home

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
            out[key] = [[c.to(mesh.device(w, j))
                         for j, c in enumerate(row.chunk(seq, dim=1))]
                        for w, row in enumerate(x.chunk(workers, dim=0))]
        return out

    def step_fn(state: engine.TrainState, batch):
        if not isinstance(batch["input_ids"], list):
            batch = place_batch(batch)
        m = state.model
        m.zero_grad(set_to_none=True)
        zero = lambda: torch.zeros((), dtype=torch.float32, device=home)
        nll, hits, count = zero(), zero(), zero()
        for ids, labels in zip(batch["input_ids"], batch["labels"]):
            terms = [losses.masked_lm_terms(lg, lab)
                     for lg, lab in zip(m(ids), labels)]
            worker_nll = sum(t[0].to(home) for t in terms)
            worker_nll.backward()  # the workers' gradients accumulate
            with torch.no_grad():
                nll += worker_nll.detach()
                hits += sum(t[1].to(home) for t in terms)
                count += sum(t[2].to(home) for t in terms)
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
