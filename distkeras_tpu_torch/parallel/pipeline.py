"""Pipeline parallelism (port of ``distkeras_tpu/parallel/pipeline.py``):
the GPipe microbatch schedule over a ``stages`` mesh axis.

Two pipelines, as in the JAX package:

- :class:`PipelinedLM`, a causal LM whose ``L`` decoder blocks are cut
  into ``P`` stages of ``L / P`` (stage ``s`` holds layers ``s * L/P ...
  (s + 1) * L/P - 1``, the JAX package's stacked ``[P, L/P, ...]``
  layout), with the embedding before stage 0 and the float32 head after
  the last;
- :class:`GenericPipeline` over arbitrary ``nn.Module`` stages, whose
  activations may change shape between stages.

The schedule runs ``M + P - 1`` ticks: at tick ``t`` stage ``s`` works on
microbatch ``t - s`` when that is in range, its output hops to stage
``s + 1``'s device with ``.to()`` (the JAX package's ``ppermute``), and the
last stage folds the loss terms of the microbatch it finishes. Backward
is autograd through the whole schedule: one ``backward``, whose
transposed hops carry the gradients back stage by stage.

A mesh may repeat a device (``["cuda:0"] * 4`` on a one-card host). Where
the parameters live: each stage's modules on its stage device, the LM's
embedding on stage 0's and its head on the last stage's. The JAX package
replicates the embedding and head (and every ``GenericPipeline`` stage)
over the mesh; here each lives once, where it is used, so the gradients
are the same. Bubble ticks (stage ``s`` at ticks ``t < s`` or ``t - s >=
M``) compute on zeros in the JAX package and feed no loss; the port
skips them, which changes no value. The hops do not overlap compute: on
one card the stages run in turn.

Over a process group :func:`make_pp_mesh` lays every process's devices
end to end, and each process holds only its own stages (the embedding
with stage 0, the head with the last; another process's stages are moved
to the ``meta`` device) and builds its optimizer over them. An
activation that crosses to another process's stage goes through
:func:`~distkeras_tpu_torch.parallel.collectives.hop` (send and receive
over the fold group: gloo, or NCCL when every process holds a card of its
own; the gradient carried back by its backward). Messages carry no
tags: both backends match them by their order between two processes, and
the order is the schedule's. Every process posts its hops in tick order
and each hop's anchor is its previous hop's token, so the backward runs
them in reverse tick order on every process. Each process runs its
stages' ticks of the same ``M + P - 1`` schedule and calls one backward (a
process without the head calls it on its hops' tokens); the last stage's
process broadcasts the metrics, so every process returns the same.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from distkeras_tpu_torch import engine
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.models import gpt
from distkeras_tpu_torch.models.transformer import LN_EPS, Embed
from distkeras_tpu_torch.ops import losses as losses_lib
from distkeras_tpu_torch.ops.optimizers import OptimizerFactory
from distkeras_tpu_torch.parallel import collectives, distributed
from distkeras_tpu_torch.parallel import mesh as mesh_lib
from distkeras_tpu_torch.parallel.mesh import WORKER_AXIS, Mesh

STAGE_AXIS = "stages"


def make_pp_mesh(num_stages: int, devices=None) -> Mesh:
    """One row of ``num_stages`` stage devices over ``devices`` (default
    :func:`~distkeras_tpu_torch.device.visible_devices`: every visible
    card, raising without one),
    which may repeat a device; too few raise ValueError, as JAX's does.
    Inside a process group ``devices`` are this process's, every process
    passing as many, laid end to end in rank order (JAX's global device
    list)."""
    devices, owners = mesh_lib.global_devices(devices)
    if num_stages > len(devices):
        raise ValueError(f"need {num_stages} devices, have {len(devices)}")
    return Mesh([resolve_device(d) for d in devices[:num_stages]],
                model_parallelism=num_stages,
                axis_names=(WORKER_AXIS, STAGE_AXIS),
                owners=owners[:num_stages])


class _Stages:
    """Which process holds each stage of a pipeline mesh's row, and the
    moves between stages: ``.to()`` inside a process, a
    :func:`~distkeras_tpu_torch.parallel.collectives.hop` across."""

    def __init__(self, mesh: Mesh, num_stages: int):
        self.devices = _stage_devices(mesh, num_stages)
        self.owners = list(mesh.device_owners[0])
        self.mine = [mesh.owns(0, s) for s in range(num_stages)]
        self.spans = mesh.spans_processes
        self.tokens = []

    def start(self) -> None:
        self.tokens = []
        collectives.new_chain()

    def send(self, out: torch.Tensor, stage: int):
        """Stage ``stage``'s output at this tick towards stage ``stage +
        1``: its input there (this process), or None (sent)."""
        if self.mine[stage + 1]:
            return out.to(self.devices[stage + 1])
        token, _ = collectives.hop([(out, self.owners[stage + 1])])
        self.tokens.append(token)
        return None

    def receive(self, stage: int, shape, dtype) -> torch.Tensor:
        """Stage ``stage``'s input at this tick, sent by another process's
        stage ``stage - 1`` at the tick before."""
        _, (x,) = collectives.hop((), [(
            self.owners[stage - 1], shape, dtype, self.devices[stage])])
        return x

    def backward(self, loss: Optional[torch.Tensor]) -> None:
        """One backward of this process's part of the schedule: the loss
        (the last stage's process) plus the tokens of its sending hops
        (the hops run their backward in reverse tick order: each hop's
        anchor is the previous hop's token)."""
        total = loss
        for token in self.tokens:
            total = token if total is None else total + token
        if total is not None:
            total.backward()
        collectives.flush_hops()

    def metrics(self, values: dict) -> dict:
        """The last stage's metrics on every process (broadcast from its
        process as float32; unchanged in one process)."""
        if not self.spans:
            return values
        names = sorted(values)
        row = np.array([float(values[n]) for n in names], np.float32) \
            if self.mine[-1] else np.zeros(len(names), np.float32)
        got = distributed.broadcast_one_to_all(row, source=self.owners[-1])
        if self.mine[-1]:
            return values
        dev = self.devices[self.mine.index(True)] if any(self.mine) \
            else torch.device("cpu")
        return {n: torch.tensor(got[i], device=dev)
                for i, n in enumerate(names)}


def _stage_devices(mesh: Mesh, num_stages: int) -> list:
    devices = mesh.axis_devices(STAGE_AXIS)
    if len(devices) != num_stages:
        raise ValueError(f"mesh has {len(devices)} stage devices, pipeline "
                         f"has {num_stages} stages")
    return devices


def _microbatches(x: torch.Tensor, m: int, device) -> torch.Tensor:
    """``[B, ...]`` -> ``[M, B / M, ...]`` on ``device``."""
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    return x.to(device).reshape((m, b // m) + tuple(x.shape[1:]))


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


class _Embed(nn.Module):
    """Token embedding in the compute dtype plus the float32 position
    table's first ``T`` rows (flax's ``_Embed``: ``tok_embed``,
    ``pos_embed``)."""

    def __init__(self, vocab: int, width: int, max_len: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.tok_embed = Embed(vocab, width, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, width))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        t = ids.shape[-1]
        return self.tok_embed(ids.long()) + self.pos_embed[:t].to(self.dtype)


class _Head(nn.Module):
    """``ln_final`` and ``lm_head``, both float32 (flax's ``_Head``)."""

    def __init__(self, width: int, vocab: int):
        super().__init__()
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)
        self.lm_head = nn.Linear(width, vocab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.ln_final(x.float()))


class PipelinedLM(nn.Module):
    """A causal LM cut into ``num_stages`` stages of ``num_layers /
    num_stages`` decoder blocks (``attention="full"``).

    Parameters: ``embed.{tok_embed.weight, pos_embed}``,
    ``stages.{s}.{j}.*`` (layer ``s * L/P + j``, a
    :class:`~distkeras_tpu_torch.models.gpt.DecoderBlock`) and
    ``head.{ln_final, lm_head}.*``; ``utils.bridge`` carries the JAX
    package's stacked tree to and from them. Built on ``device`` (default
    ``cuda:0``); :meth:`build_train_step`'s ``place_params`` moves each
    stage to its stage device.
    """

    def __init__(self, vocab_size: int, max_len: int, num_layers: int,
                 num_heads: int, width: int, mlp_dim: int, num_stages: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if num_layers % num_stages != 0:
            raise ValueError(f"num_layers {num_layers} must divide evenly "
                             f"into {num_stages} stages")
        self.vocab_size, self.max_len = vocab_size, max_len
        self.num_layers, self.num_stages = num_layers, num_stages
        self.layers_per_stage = num_layers // num_stages
        self.width, self.dtype = width, dtype
        self.embed = _Embed(vocab_size, width, max_len, dtype)
        self.stages = nn.ModuleList(
            nn.ModuleList(gpt.DecoderBlock(width, num_heads, mlp_dim, dtype,
                                           attention="full")
                          for _ in range(self.layers_per_stage))
            for _ in range(num_stages))
        self.head = _Head(width, vocab_size)
        self.to(resolve_device(device))

    def init(self, seed: int = 0) -> "PipelinedLM":
        """Seeded weights in place (``gpt.init_params``' rules), each of
        the ``L`` layers its own draw, in layer order."""
        gpt.init_params(self, torch.Generator().manual_seed(int(seed)))
        return self

    def _run_stage(self, s: int, x: torch.Tensor) -> torch.Tensor:
        for block in self.stages[s]:
            x = block(x)
        return x

    def reference_apply(self, ids) -> torch.Tensor:
        """The sequential forward with the same weights (the oracle):
        every layer in order, wherever its stage lives, no schedule."""
        ids = _as_tensor(ids)
        x = self.embed(ids.to(self.embed.pos_embed.device))
        for s, stage in enumerate(self.stages):
            x = self._run_stage(s, x.to(next(stage.parameters()).device))
        return self.head(x.to(self.head.lm_head.weight.device))

    def build_train_step(self, tx: OptimizerFactory, mesh: Mesh,
                         num_microbatches: int):
        """``(step_fn, place_params, place_batch)``:

        - ``place_params(params=None)`` loads ``params`` (a state dict)
          when given, puts each stage on its stage device (the embedding
          on stage 0's, the head on the last's) and builds ``tx`` (a
          factory) over the parameters: an ``engine.TrainState``;
        - ``place_batch({"input_ids": [B, T], "labels": [B, T]})`` puts
          the ids on stage 0's device and the labels on the last's;
        - ``step_fn(state, batch) -> (state, metrics)``: the schedule,
          one backward, one optimizer step (in place); ``loss`` (the
          summed token NLL over the global count) and ``accuracy``.

        B must divide into ``num_microbatches``; labels < 0 are ignored.
        """
        route = _Stages(mesh, self.num_stages)
        devices, mine = route.devices, route.mine
        m_count = int(num_microbatches)
        stages = self.num_stages

        def place_params(params=None) -> engine.TrainState:
            if params is not None:
                self.load_state_dict(params)
            self.embed.to(devices[0] if mine[0] else "meta")
            for stage, dev, own in zip(self.stages, devices, mine):
                stage.to(dev if own else "meta")
            self.head.to(devices[-1] if mine[-1] else "meta")
            held = [p for p in self.parameters() if not p.is_meta]
            return engine.TrainState(step=0, model=self, opt_state=tx(held))

        def place_batch(batch) -> dict:
            return {"input_ids": _as_tensor(batch["input_ids"]).to(
                        devices[0] if mine[0] else "cpu"),
                    "labels": _as_tensor(batch["labels"]).to(
                        devices[-1] if mine[-1] else "cpu")}

        def step_fn(state: engine.TrainState, batch):
            ids_mb = _microbatches(_as_tensor(batch["input_ids"]), m_count,
                                   devices[0] if mine[0] else "cpu")
            labels_mb = _microbatches(_as_tensor(batch["labels"]), m_count,
                                      devices[-1] if mine[-1] else "cpu")
            # a microbatch's activation between stages
            act = (ids_mb.shape[1], ids_mb.shape[2], self.width)
            zero = lambda: torch.zeros((), device=devices[-1])
            nll = hits = count = None
            if mine[-1]:
                nll, hits, count = zero(), zero(), zero()
            route.start()
            inbox = [None] * stages  # inbox[s]: stage s's input this tick
            for tick in range(m_count + stages - 1):
                outbox = [None] * stages
                for s in range(stages):
                    mb = tick - s
                    if not mine[s] or not 0 <= mb < m_count:
                        continue  # another process's, or a bubble tick
                    if s == 0:
                        x = self.embed(ids_mb[mb])
                    elif mine[s - 1]:
                        x = inbox[s]
                    else:
                        x = route.receive(s, act, self.dtype)
                    out = self._run_stage(s, x)
                    if s < stages - 1:
                        outbox[s + 1] = route.send(out, s)
                        continue
                    terms = losses_lib.masked_lm_terms(self.head(out),
                                                       labels_mb[mb])
                    nll, hits, count = (nll + terms[0], hits + terms[1],
                                        count + terms[2])
                inbox = outbox
            loss = None
            if mine[-1]:
                count = torch.clamp(count, min=1.0)
                loss = nll / count
            state.model.zero_grad(set_to_none=True)
            route.backward(loss)
            state.opt_state.step()
            state.opt_state.zero_grad(set_to_none=True)
            ms = route.metrics({"loss": loss.detach(),
                                "accuracy": hits / count}
                               if mine[-1] else {"loss": 0.0,
                                                 "accuracy": 0.0})
            return (engine.TrainState(step=state.step + 1, model=state.model,
                                      opt_state=state.opt_state), ms)

        return step_fn, place_params, place_batch


class GenericPipeline:
    """GPipe over arbitrary stage modules, applied in order
    (``stages[k](x)``); they may differ in class, width and activation
    shape. Stage ``k`` runs on the mesh's stage device ``k``, where its
    parameters live. Activations hop through one flat buffer in
    ``dtype``, padded to the largest hop (the JAX package's layout, so a
    bf16 hop rounds as JAX's does); :meth:`init` records each stage's
    output shape for one microbatch.

    ``loss`` is a name of :mod:`~distkeras_tpu_torch.ops.losses` or a
    callable ``(logits, labels) -> scalar``, applied to the last stage's
    float32 output a microbatch; the step's loss is their mean.
    """

    def __init__(self, stages: Sequence[nn.Module], num_microbatches: int,
                 loss: Union[str, Callable] = "categorical_crossentropy",
                 dtype: torch.dtype = torch.float32, device=None):
        if len(stages) < 2:
            raise ValueError("a pipeline needs >= 2 stages")
        home = resolve_device(device)
        self.stages = nn.ModuleList(stages).to(home)
        self.num_stages = len(stages)
        #: each stage's device (place_params moves them)
        self.devices = [home] * self.num_stages
        self.M = int(num_microbatches)
        self.dtype = dtype
        self.loss_fn = losses_lib.get(loss)
        self._shapes: Optional[list] = None  # per-stage output shapes

    def init(self, sample_features) -> tuple:
        """Record each stage's output shape for one microbatch shaped as
        ``sample_features``; returns the stages' parameters, a tuple of
        state dicts (copies), in stage order."""
        x = _as_tensor(sample_features).to(self.dtype)
        shapes = []
        with torch.no_grad():
            for stage, dev in zip(self.stages, self.devices):
                x = stage(x.to(dev))
                shapes.append(tuple(x.shape))
        self._shapes = shapes
        return tuple({n: t.detach().clone()
                      for n, t in stage.state_dict().items()}
                     for stage in self.stages)

    def reference_apply(self, features) -> torch.Tensor:
        """The sequential forward with the same weights (the oracle)."""
        x = _as_tensor(features).to(self.dtype)
        for stage, dev in zip(self.stages, self.devices):
            x = stage(x.to(dev))
        return x

    def build_train_step(self, tx: OptimizerFactory, mesh: Mesh):
        """``(step_fn, place_params, place_batch)``:

        - ``place_params(params=None)`` loads ``params`` (a tuple of
          state dicts, :meth:`init`'s) when given, puts stage ``k`` on
          stage device ``k`` and builds ``tx`` (a factory) over every
          stage's parameters: an ``engine.TrainState`` over
          ``self.stages``;
        - ``place_batch({"features": [B, ...], "labels": [B, ...]})``
          puts the features on stage 0's device, the labels on the
          last's;
        - ``step_fn(state, batch) -> (state, {"loss"})``; B must divide
          into ``num_microbatches``.
        """
        if self._shapes is None:
            raise RuntimeError("call init() before build_train_step()")
        stages_n, m_count, shapes = self.num_stages, self.M, self._shapes
        route = _Stages(mesh, stages_n)
        devices, mine = route.devices, route.mine
        # hop buffer: outputs of stages 0 .. P-2 travel, padded to the
        # largest
        hop_sizes = [math.prod(s) for s in shapes[:-1]]
        buf_n = max(hop_sizes)

        def place_params(params=None) -> engine.TrainState:
            if params is not None:
                for stage, sd in zip(self.stages, params):
                    stage.load_state_dict(sd)
            for stage, dev, own in zip(self.stages, devices, mine):
                stage.to(dev if own else "meta")
            self.devices = list(devices)
            held = [p for p in self.stages.parameters() if not p.is_meta]
            return engine.TrainState(step=0, model=self.stages,
                                     opt_state=tx(held))

        def place_batch(batch) -> dict:
            return {"features": _as_tensor(batch["features"]).to(
                        devices[0] if mine[0] else "cpu"),
                    "labels": _as_tensor(batch["labels"]).to(
                        devices[-1] if mine[-1] else "cpu")}

        def hop(k: int, out: torch.Tensor) -> torch.Tensor:
            if out.numel() != hop_sizes[k]:
                raise ValueError(
                    f"stage {k} gave {tuple(out.shape)}, init recorded "
                    f"{shapes[k]}: init with one microbatch of the batch's "
                    f"shape")
            return F.pad(out.reshape(-1).to(self.dtype),
                         (0, buf_n - hop_sizes[k]))

        def step_fn(state: engine.TrainState, batch):
            feats = _microbatches(_as_tensor(batch["features"]), m_count,
                                  devices[0] if mine[0] else "cpu")
            labels = _microbatches(_as_tensor(batch["labels"]), m_count,
                                   devices[-1] if mine[-1] else "cpu")
            loss_sum = torch.zeros((), device=devices[-1]) \
                if mine[-1] else None
            route.start()
            inbox = [None] * stages_n
            for tick in range(m_count + stages_n - 1):
                outbox = [None] * stages_n
                for k in range(stages_n):
                    mb = tick - k
                    if not mine[k] or not 0 <= mb < m_count:
                        continue  # another process's, or a bubble tick
                    if k == 0:
                        x = feats[mb].to(self.dtype)
                    else:
                        flat = inbox[k] if mine[k - 1] else route.receive(
                            k, (buf_n,), self.dtype)
                        x = flat[:hop_sizes[k - 1]].reshape(shapes[k - 1])
                    out = self.stages[k](x)
                    if k < stages_n - 1:
                        outbox[k + 1] = route.send(hop(k, out), k)
                    else:
                        loss_sum = loss_sum + self.loss_fn(out.float(),
                                                           labels[mb])
                inbox = outbox
            loss = loss_sum / m_count if mine[-1] else None
            state.model.zero_grad(set_to_none=True)
            route.backward(loss)
            state.opt_state.step()
            state.opt_state.zero_grad(set_to_none=True)
            ms = route.metrics({"loss": loss.detach()} if mine[-1]
                               else {"loss": 0.0})
            return (engine.TrainState(step=state.step + 1, model=state.model,
                                      opt_state=state.opt_state), ms)

        return step_fn, place_params, place_batch
