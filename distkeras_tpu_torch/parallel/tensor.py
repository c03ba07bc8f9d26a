"""Tensor parallelism (port of ``distkeras_tpu/parallel/tensor.py``):
parameter partition rules and the synchronous data (x tensor) parallel
step of :class:`~distkeras_tpu_torch.trainers.PjitTrainer`.

The JAX package picks a workers x model mesh, annotates each parameter's
sharding by PATH RULES (regex -> PartitionSpec, first match wins), shards
the batch over ``workers`` and lets GSPMD insert the collectives. The
port keeps the rules, the specs and the arithmetic, and runs the mesh in
one process (a mesh may repeat a device, as ``["cuda:0"] * 4`` does on a
one-card host):

- **Rules on flax paths.** A rule is matched against the parameter's
  path in the flax tree (``layer_0/attn/qkv/kernel``), which
  :func:`~distkeras_tpu_torch.utils.bridge.flax_layout` derives from the
  port's name (``layers.0.attn.qkv.weight``), and its spec, written for
  flax's ``[in, out]`` kernels, is mapped onto the port's layout
  (``[out, in]``; stacked experts ``[E, out, in]``): ``qkv``'s column
  split ``P(None, "model")`` is ``P("model", None)`` on its weight. A spec
  whose named axes do not divide the dimension replicates, as in JAX.
- **Storage is sharded.** A parameter a rule shards is held at rest as
  M shard tensors (:class:`Sharded`), shard ``m`` on the device at
  (worker 0, model ``m``); a replicated one as one tensor on the mesh's
  home. The optimizer is built over the shards, so its state (adam's
  moments) is per shard, leaf for leaf (the JAX package's ``place_state``):
  it takes the shards' memory, not full copies'. Each parameter's shards
  are one param group (:func:`param_groups`), so LAMB's trust ratio, the
  one per-tensor reduction among the optimizers, spans the whole tensor
  and each element counts once.
- **Compute is replicated.** Each step gathers (``torch.cat``) every
  sharded parameter onto the mesh's home and takes the loss over the
  global batch through ``torch.func.functional_call``: GSPMD's
  arithmetic, in which the batch's sharding over ``workers`` changes no
  value (a capacity-routed MoE routes the global batch's tokens, a
  masked-token mean divides by the global batch's count). The gradient
  is split back into the shards' slices: what the backward of the
  gather computes, which in one process is the reduce-scatter. The
  gathered parameters are the unsharded ones, so the mesh's shape
  changes no bit of a step.

Divergence by design (ROADMAP.md Queue C): GSPMD may split a matmul's
activations over the model axis; the port gathers the parameters, so only
storage is sharded. Splitting the activations waits for a host with
several cards.

On a mesh that spans a process group the shards live at rest where
their devices live (:func:`shard_params`): when rows lie inside a
process, each process holds its first row's shards (the parameters are
replicated over the workers axis, as in JAX); when a row spans processes,
shard ``m`` is held only by the process that owns the row's device ``m``,
its optimizer state with it, and the step's gather is an all-gather over
the row's processes, staged through the host for a card
(:func:`~distkeras_tpu_torch.parallel.collectives.all_gather_flat`).
Every process that holds a device of a row takes the loss over that
row's rows of the global batch (JAX replicates a row's batch over the
model axis) and keeps its own shards' slices of the gradient.

When several row groups lie on different processes, the processes' terms
are summed (:func:`~distkeras_tpu_torch.parallel.collectives.cross_process_sum`),
each row counted once by its lead (the process of its first device; the
others add zeros), before anything is divided by the global batch's
count, so the update is the global batch's and every process applies the
same bits:

- a loss that is a mean over rows (every named loss but ``masked_lm``;
  a callable loss is taken to be one) weights each process's gradient
  and loss by its share of the global batch;
- ``masked_lm`` sums each process's gradient and loss times its valid
  token count, and the count, and divides the sums by the global count
  once;
- metrics sum their ``(numerator, denominator)`` terms.

Three objectives are coupled across the batch and cannot be assembled
from the rows' terms: a capacity-routed MoE (its routing and load-balance
term are the global batch's tokens'), ``masked_lm`` under ``accum_steps >
1`` (a microbatch is a slice of the global batch that spans processes)
and a quantizing precision (``int8``, ``fp8-sim``: an activation's
per-tensor scale is the global batch's ``amax``).
For them every process all-gathers each step's global batch at staging
and takes the one-process step on it with the one-process dropout
stream: the update is the one-process step's bits, with no fold, at P
times the compute (a divergence by design, ROADMAP.md Queue C). Else
dropout folds the rows' lead process index into each step's stream.

``bucket_bytes`` is the JAX package's explicit shard_map step: each
worker runs its slice of the batch on its device with its own dropout
stream, and the workers' gradients fold as their mean, bucket by bucket
(:func:`~distkeras_tpu_torch.parallel.collectives.bucketed_psum`,
bitwise the whole-tree fold); it needs a model axis of 1, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from distkeras_tpu_torch import engine
from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.ops import losses as losses_lib
from distkeras_tpu_torch.parallel import collectives, distributed
from distkeras_tpu_torch.parallel import mesh as mesh_lib
from distkeras_tpu_torch.parallel.mesh import MODEL_AXIS, WORKER_AXIS, Mesh
from distkeras_tpu_torch.utils import bridge
from distkeras_tpu_torch.utils import rng


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s role: one mesh axis name (or
    None) a tensor dimension, ``P(None, "model")``; ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}" if len(self) != 1 \
            else f"PartitionSpec({self[0]!r})"


P = PartitionSpec
Rules = Sequence[Tuple[str, PartitionSpec]]

# Default rules for the model zoo, on flax paths and flax's [in, out]
# kernels. First match wins; unmatched params replicate. Megatron-style
# pairing: column-parallel into the nonlinearity, row-parallel out of it.
DEFAULT_RULES: Rules = (
    (r"attn/qkv/kernel$", P(None, MODEL_AXIS)),
    (r"attn/out/kernel$", P(MODEL_AXIS, None)),
    (r"mlp/fc1/kernel$", P(None, MODEL_AXIS)),
    (r"mlp/fc2/kernel$", P(MODEL_AXIS, None)),
    (r"tok_embed/embedding$", P(MODEL_AXIS, None)),  # vocab-sharded
    (r"mlm_head/kernel$", P(None, MODEL_AXIS)),
    (r"head/kernel$", P(None, MODEL_AXIS)),
    (r"dense.*/kernel$", P(None, MODEL_AXIS)),
)


def path_str(path) -> str:
    """A tree path (a sequence of keys or indices) -> ``"a/b/c"`` for
    rule matching."""
    return "/".join(str(p) for p in path)


def _spec_fits(spec: Sequence, shape: Sequence[int],
               axis_sizes: dict) -> bool:
    """True when every named axis of ``spec`` divides the matching dim."""
    if len(spec) > len(shape):
        return False
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size = axis_sizes.get(axis)
        if size and shape[dim] % size != 0:
            return False
    return True


def _compiled(rules: Optional[Rules]):
    rules = DEFAULT_RULES if rules is None else tuple(rules)
    return [(re.compile(pat), P(*spec)) for pat, spec in rules]


def _first_match(compiled, path: str) -> Optional[PartitionSpec]:
    for pat, spec in compiled:
        if pat.search(path):
            return spec
    return None


def to_port_spec(spec: Sequence, axes: Sequence[int]) -> PartitionSpec:
    """A spec written for the flax array ``port.permute(axes)`` as a spec
    of the port tensor (flax dim ``j`` is port dim ``axes[j]``)."""
    if not spec:
        return P()
    out = [None] * len(axes)
    for j, axis in enumerate(spec):
        out[axes[j]] = axis
    return P(*out)


def to_flax_spec(spec: Sequence, axes: Sequence[int]) -> PartitionSpec:
    """Inverse of :func:`to_port_spec`."""
    if not spec:
        return P()
    return P(*(spec[axes[j]] for j in range(len(axes))))


def partition_specs(params: Mapping, rules: Optional[Rules] = None,
                    mesh: Optional[Mesh] = None) -> dict:
    """PartitionSpecs for ``params`` by first-match path rules.

    ``params`` is a port ``state_dict``-like dict (name -> tensor or
    array): each rule is matched on the name's flax path and the result
    is a name -> spec dict in the PORT's layout. A nested dict (a flax
    tree of arrays) is matched on its own paths and gets a nested dict of
    specs in its own layout, as the JAX function returns. A matched spec
    is kept only if every named axis divides the corresponding dimension
    (tiny test models replicate rather than fail)."""
    compiled = _compiled(rules)
    axis_sizes = dict(mesh.shape) if mesh is not None else {}
    if any(isinstance(v, Mapping) for v in params.values()):
        def walk(tree, prefix):
            out = {}
            for key, value in tree.items():
                path = prefix + (key,)
                if isinstance(value, Mapping):
                    out[key] = walk(value, path)
                    continue
                spec = _first_match(compiled, path_str(path))
                shape = tuple(np.shape(value))
                out[key] = spec if spec is not None and _spec_fits(
                    spec, shape, axis_sizes) else P()
            return out

        return walk(params, ())
    specs = {}
    for name, value in params.items():
        shape = tuple(np.shape(value))
        path, axes = bridge.flax_layout(name, len(shape))
        spec = _first_match(compiled, path_str(path))
        if spec is None:
            specs[name] = P()
            continue
        flax_shape = tuple(shape[a] for a in axes)
        specs[name] = to_port_spec(spec, axes) if _spec_fits(
            spec, flax_shape, axis_sizes) else P()
    return specs


def _model_dim(spec: PartitionSpec, name: str) -> Optional[int]:
    """The dimension a spec shards over ``model`` (None: replicated)."""
    named = [(d, a) for d, a in enumerate(spec) if a is not None]
    if not named:
        return None
    if len(named) > 1 or named[0][1] != MODEL_AXIS:
        raise ValueError(
            f"{name}: spec {spec!r} shards over {[a for _, a in named]}; "
            f"the port shards parameters over one dimension of the "
            f"{MODEL_AXIS!r} axis only")
    return named[0][0]


@dataclasses.dataclass
class Sharded:
    """One parameter held as shards: slice ``m`` of ``dim`` (equal
    slices, in order) is shard ``m``. ``shards`` are the ones this
    process holds, in order, on the devices of its first row (row, model
    ``m``). When the row spans processes, ``owners[m]`` is the process
    that holds shard ``m`` (None: this one holds every shard) and
    :meth:`gather` is a collective of them."""

    shards: list
    dim: int
    spec: PartitionSpec
    owners: Optional[list] = None

    @property
    def count(self) -> int:
        """The number of shards (the model axis' size)."""
        return len(self.shards) if self.owners is None else len(self.owners)

    @property
    def held(self) -> list:
        """The model positions of :attr:`shards`."""
        if self.owners is None:
            return list(range(len(self.shards)))
        me = distributed.process_index()
        return [m for m, o in enumerate(self.owners) if o == me]

    @property
    def shape(self) -> tuple:
        shape = list(self.shards[0].shape)
        shape[self.dim] *= self.count
        return tuple(shape)

    def split(self, whole: torch.Tensor) -> list:
        """This process's slices of ``whole`` (a tensor of :attr:`shape`),
        in :attr:`shards`' order."""
        chunks = whole.chunk(self.count, dim=self.dim)
        return [chunks[m] for m in self.held]

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device`` (a collective of every process
        when another one holds shards: every process calls it)."""
        return gather_params({"p": self}, device)["p"]


def _join(items: Sequence[Sharded], device) -> list:
    """The whole tensors of ``items`` on ``device`` (None: each one's
    first shard's): the local ones by
    concatenation, those whose row spans processes by one all-gather of
    every process's shards (:func:`collectives.all_gather_flat
    <distkeras_tpu_torch.parallel.collectives.all_gather_flat>`)."""
    remote = [p for p in items if p.owners is not None]
    got = collectives.all_gather_flat(
        [s for p in remote for s in p.shards]) if remote else None
    out, at = [], 0
    for p in items:
        dev = p.shards[0].device if device is None else device
        if p.owners is None:
            out.append(torch.cat([s.to(dev) for s in p.shards], dim=p.dim))
            continue
        k = len(p.shards)
        pieces = []
        for m, owner in enumerate(p.owners):
            row = got[owner]
            pieces.append(row[at + p.owners[:m].count(owner)].to(dev))
        at += k
        out.append(torch.cat(pieces, dim=p.dim))
    return out


def shard_params(params: Mapping, mesh: Mesh,
                 rules: Optional[Rules] = None) -> dict:
    """Place ``params`` (name -> tensor) on the mesh by the rules: a
    :class:`Sharded` for each parameter a spec shards (shard ``m`` a copy
    of its slice on ``mesh.device(w, m)`` for this process's first row
    ``w``, held only by the process that owns that device when the row
    spans processes), a copy on the mesh's home for the rest."""
    specs = partition_specs(params, rules, mesh)
    m_size = mesh.shape[MODEL_AXIS]
    row = mesh_lib.local_worker_positions(mesh)[0]
    owners = mesh.device_owners[row]
    spans_row = len(set(owners)) > 1
    held = [m for m in range(m_size) if mesh.owns(row, m)]
    out = {}
    with torch.no_grad():
        for name, value in params.items():
            x = torch.as_tensor(value).detach()
            dim = _model_dim(specs[name], name) if m_size > 1 else None
            if dim is None:
                out[name] = x.to(mesh.home, copy=True)
                continue
            chunks = x.chunk(m_size, dim=dim)
            out[name] = Sharded(
                [chunks[m].to(mesh.device(row, m), copy=True).contiguous()
                 for m in held], dim, specs[name],
                owners=list(owners) if spans_row else None)
    return out


def gather_params(placed: Mapping, device) -> dict:
    """Whole tensors of :func:`shard_params`' output, on ``device`` (a
    collective of every process when a row spans processes)."""
    names = [n for n, p in placed.items() if isinstance(p, Sharded)]
    whole = dict(zip(names, _join([placed[n] for n in names], device)))
    return {n: whole[n] if n in whole else p.to(device)
            for n, p in placed.items()}


def param_groups(placed: Mapping) -> list:
    """The optimizer's param groups over ``placed``'s tensors, in order:
    each :class:`Sharded` parameter's shards one group whose
    ``shard_dim`` names the dim they split (LAMB's trust ratio spans the
    group), each run of replicated tensors one group."""
    groups, run = [], []
    for p in placed.values():
        if not isinstance(p, Sharded):
            run.append(p)
            continue
        if run:
            groups.append({"params": run})
            run = []
        group = {"params": list(p.shards), "shard_dim": p.dim}
        if p.owners is not None:  # the whole tensor is a collective
            group["shard_join"] = functools.partial(_join_like, p)
        groups.append(group)
    if run:
        groups.append({"params": run})
    return groups


def _join_like(p: Sharded, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The whole tensor whose shards this process holds as ``tensors``
    (laid out as ``p``'s shards), on the first one's device."""
    return gather_params({"t": dataclasses.replace(p, shards=list(tensors))},
                         tensors[0].device)["t"]


@dataclasses.dataclass
class PjitState:
    """The train state on the mesh: ``step`` (optimizer steps taken),
    ``params`` (name -> replicated tensor or :class:`Sharded`) and the
    optimizer over their leaves, in ``params``' order."""

    step: int
    params: dict
    opt_state: Any

    def gathered(self, device) -> dict:
        return gather_params(self.params, device)


def _inner(opt):
    return opt.inner if isinstance(opt, precision_lib.OverflowGuardState) \
        else opt


def _batch_coupled(model, masked: bool, accum_steps: int,
                   precision) -> bool:
    """True when the step's objective couples the rows of the global
    batch so that no process can take its rows' terms alone: a
    capacity-routed MoE (its routing and load-balance term are the global
    batch's tokens'), ``masked_lm`` under ``accum_steps > 1`` (a
    microbatch is a slice of the global batch) and a quantizing precision
    (an activation's per-tensor scale is the global batch's ``amax``)."""
    from distkeras_tpu_torch.models.moe import SwitchMoE

    def quantizes(name) -> bool:
        policy = precision_lib.get_policy(name) if isinstance(
            name, (str, precision_lib.PrecisionPolicy)) else None
        return policy is not None and policy.quant is not None

    return (any(isinstance(m, SwitchMoE) for m in model.modules())
            or (masked and accum_steps > 1) or quantizes(precision)
            or any(quantizes(getattr(m, "precision", None))
                   for m in model.modules()))


def build_pjit_epoch_fn(model, loss, tx, mesh: Mesh,
                        metrics: Sequence[str] = (),
                        rules: Optional[Rules] = None,
                        dropout_seed: int = 0, accum_steps: int = 1,
                        precision: Optional[str] = None,
                        bucket_bytes: Optional[int] = None):
    """Sync data-parallel (x tensor-parallel) epoch over staged steps.

    Returns ``(epoch_fn, place_state, place_data)``:

    - ``place_state(params)`` shards ``params`` (name -> tensor, the
      model's float32 masters) by the rules and builds the optimizer
      ``tx`` (a factory) over :func:`param_groups`: a :class:`PjitState`;
    - ``place_data(data)`` checks that ``[steps, batch, ...]`` leaves
      split over the workers and puts them on the mesh's home (under
      ``bucket_bytes``: each worker's equal row slice on its device);
    - ``epoch_fn(state, data, step_offset) -> (state, metrics)`` runs the
      steps (the state's tensors updated in place), metrics ``[steps]``
      float32 tensors on the mesh's home: ``loss`` and each name of
      ``metrics``.

    ``accum_steps > 1`` runs each step's batch as that many microbatches
    (``engine.make_accum_grad_fn``; under ``bucket_bytes`` each worker's
    rows): the fold stays once a step.
    ``precision`` scales the loss of the grad function as the model's
    policy asks; a guard-wrapped optimizer's live scale is read a step.

    Dropout: on the GSPMD path one stream a step, seeded from
    ``(dropout_seed, step)``; under ``bucket_bytes`` one stream a (step,
    worker), as the JAX package's shard_map step folds the worker index
    into the key. The streams are torch's, not threefry's.
    """
    spans = mesh.spans_processes
    decorrelate = bucket_bytes is not None
    masked = losses_lib.get(loss) is losses_lib.masked_lm
    local = mesh_lib.local_worker_positions(mesh)
    pid = distributed.process_index()
    if spans:
        mesh.row_processes  # a layout the fold can count raises here
    # several row groups over processes: the data-parallel fold runs, and
    # each row counts once, by its lead (the process of its first device)
    fold = spans and len(set(mesh.owners)) > 1
    lead = all(mesh.owners[w] == pid for w in local)
    # an objective coupled across the batch's rows: every process gathers
    # the global batch and takes the one-process step on it
    coupled = fold and not decorrelate and _batch_coupled(
        model, masked, int(accum_steps), precision)
    metric_names = tuple(metrics)
    accum_steps = int(accum_steps)
    if accum_steps > 1:
        grad_fn = engine.make_accum_grad_fn(model, loss, accum_steps,
                                            metric_names, precision=precision,
                                            functional=True)
    else:
        grad_fn = engine.make_grad_fn(model, loss, precision=precision,
                                      functional=True)
    num_workers = mesh.shape[WORKER_AXIS]
    if bucket_bytes is not None and mesh.shape.get(MODEL_AXIS, 1) > 1:
        raise ValueError(
            f"bucket_bytes={bucket_bytes} requests explicit bucketed grad "
            f"all-reduce, which requires a pure data-parallel mesh; this "
            f"mesh shards the model axis over "
            f"{mesh.shape[MODEL_AXIS]} devices (GSPMD's implicit "
            f"model-parallel collectives do not compose with explicit "
            f"shard_map psums — drop bucket_bytes or use model=1)")
    if bucket_bytes is not None and int(bucket_bytes) <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    home = mesh.home
    # this process's share of the global batch (1 in one process; 0 where
    # another process leads the rows)
    share = len(local) / num_workers if lead else 0.0
    # the dropout stream's process index: the rows' lead (a row's
    # processes draw the same stream); none when a process takes the
    # global batch's step
    stream = mesh.owners[local[0]] if fold and not coupled else None

    def across(out: dict, grads: dict, weight, count=None):
        """The sum over processes of ``weight`` times the gradients and
        the loss, and of the metrics' ``(num, den)`` terms, each row
        counted once (a process that does not lead its rows adds zeros);
        under ``count`` (this process's denominator of the loss, a tensor)
        the sums of the gradients and the loss are divided once by the
        processes' summed count. No fold: unchanged."""
        if not fold or coupled:
            return grads, out
        with torch.no_grad():
            tree = {f"g/{n}": g * weight for n, g in grads.items()}
            for name, v in out.items():
                if isinstance(v, tuple):  # (num, den) terms
                    tree[f"m/{name}/0"], tree[f"m/{name}/1"] = v
                else:
                    tree[f"m/{name}"] = v.float() * weight
            if count is not None:
                tree["count"] = count
            if not lead:
                tree = {k: torch.zeros_like(v) for k, v in tree.items()}
            tree = collectives.cross_process_sum(tree, bucket_bytes)
            if count is not None:
                total = torch.clamp(tree.pop("count"), min=1.0)
                tree = {k: v if k.startswith("m/") and k != "m/loss"
                        else v / total for k, v in tree.items()}
        grads = {n: tree[f"g/{n}"] for n in grads}
        out = {name: (tree[f"m/{name}/0"], tree[f"m/{name}/1"])
               if isinstance(v, tuple) else tree[f"m/{name}"]
               for name, v in out.items()}
        return grads, out

    def place_state(params: Mapping) -> PjitState:
        placed = shard_params(params, mesh, rules)
        return PjitState(step=0, params=placed,
                         opt_state=tx(param_groups(placed)))

    def global_rows(arr: np.ndarray) -> np.ndarray:
        """``[steps, local rows, ...]`` -> ``[steps, global batch, ...]``:
        every process's rows all-gathered, each worker row's slice taken
        from its lead, in worker order."""
        raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        every = distributed.process_allgather(raw).view(arr.dtype).reshape(
            (-1,) + arr.shape)  # as bytes: gloo has no int16
        per = arr.shape[1] // len(local)
        parts = []
        for w in range(num_workers):
            owner = mesh.owners[w]
            at = [v for v, o in enumerate(mesh.device_owners)
                  if owner in o].index(w)
            parts.append(every[owner][:, at * per:(at + 1) * per])
        return np.concatenate(parts, axis=1)

    def place_data(data: Mapping) -> dict:
        out = {}
        for key, value in data.items():
            arr = np.asarray(value)
            if coupled:
                arr = global_rows(arr)
            x = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
            b = x.shape[1]
            if not coupled and b % len(local):
                raise ValueError(
                    f"the global batch {b} does not split over "
                    f"{len(local)} workers")
            out[key] = [c.to(mesh.devices[w]) for w, c in
                        zip(local, x.chunk(len(local), dim=1))] \
                if decorrelate else x.to(home)
        return out

    def global_step(params: dict, batch: dict, step: int, scale):
        """GSPMD's arithmetic: the loss over the global batch (a
        capacity-routed MoE and a masked-token mean are the global
        batch's), one dropout stream a step."""
        seed = rng.fold_in(dropout_seed, step) if stream is None \
            else rng.fold_in(dropout_seed, step, stream)
        gen = rng.generator(seed, home)
        (loss_val, aux), grads = grad_fn(params, batch, gen,
                                         loss_scale=scale)
        out = {"loss": loss_val.detach()}
        for name in metric_names:
            out[name] = aux[name] if accum_steps > 1 else \
                engine.compute_metric_terms(name, aux, batch["labels"])
        if fold and masked:  # the global token mean: sum, then divide
            count = (batch["labels"] >= 0).sum().float()
            grads, out = across(out, grads, count, count)
        else:
            grads, out = across(out, grads, share)
        for name in metric_names:
            out[name] = engine.finalize_metric(out[name])
        return grads, out

    def bucketed_step(state: PjitState, batches: list, step: int, scale):
        """The shard_map step: each worker's slice on its device with its
        own dropout stream; the gradients, loss and metrics are the mean
        over the workers, the gradients summed bucket by bucket."""
        grads, losses, metric_terms = [], [], []
        for w, batch in zip(local, batches):
            dev = mesh.devices[w]
            with torch.no_grad():
                full = {n: t.detach().requires_grad_()
                        for n, t in state.gathered(dev).items()}
            gen = rng.generator(rng.fold_in(dropout_seed, step, w), dev)
            (loss_w, aux), g = grad_fn(full, batch, gen, loss_scale=scale)
            del full
            grads.append(g)
            losses.append(loss_w.detach().to(home))
            metric_terms.append({
                name: tuple(t.to(home) for t in aux[name])
                if accum_steps > 1 else
                engine.compute_metric(name, aux, batch["labels"]).to(home)
                for name in metric_names})
        with torch.no_grad():
            folded = collectives.bucketed_psum(grads, bucket_bytes)
            out = {"loss": sum(losses)}
            for name in metric_names:
                terms = [m[name] for m in metric_terms]
                out[name] = (sum(t[0] for t in terms),
                             sum(t[1] for t in terms)) \
                    if accum_steps > 1 else sum(terms)
            folded, out = across(out, folded, 1.0)
            if num_workers > 1:  # x / 1 is x: skip the launches
                folded = {n: g / num_workers for n, g in folded.items()}
            for name, v in out.items():  # (num, den) sum exactly
                out[name] = engine.finalize_metric(v) \
                    if isinstance(v, tuple) else v / num_workers
        return folded, out

    # a row over processes: each holds some shards of the whole gradient
    split = spans and mesh.row_processes > 1

    def one_step(state: PjitState, batch, step: int) -> dict:
        scale = precision_lib.current_scale(state.opt_state)
        if decorrelate:
            grads, out = bucketed_step(state, batch, step, scale)
        else:
            with torch.no_grad():
                full = {n: t.detach().requires_grad_()
                        for n, t in state.gathered(home).items()}
            grads, out = global_step(full, batch, step, scale)
            del full
        with torch.no_grad():
            finite = None  # a guard reads the whole gradient's finiteness
            if split and isinstance(state.opt_state,
                                    precision_lib.OverflowGuardState):
                finite = bool(torch.stack([torch.isfinite(g).all()
                                           for g in grads.values()]).all())
            for name, p in state.params.items():
                g = grads[name]
                if isinstance(p, Sharded):
                    for s, c in zip(p.shards, p.split(g)):
                        s.grad = c.to(s.device).contiguous()
                else:
                    p.grad = g.to(p.device)
            del grads
            if finite is None:
                state.opt_state.step()
            else:
                state.opt_state.step(finite=finite)
            state.opt_state.zero_grad(set_to_none=True)
        return out

    def epoch_fn(state: PjitState, data: Mapping, step_offset: int):
        first = data["features"][0] if decorrelate else data["features"]
        outs = []
        for i in range(first.shape[0]):
            batch = [{"features": data["features"][w][i],
                      "labels": data["labels"][w][i]}
                     for w in range(len(local))] if decorrelate else \
                {"features": data["features"][i],
                 "labels": data["labels"][i]}
            outs.append(one_step(state, batch, int(step_offset) + i))
            state.step += 1
        return state, {name: torch.stack([o[name].float() for o in outs])
                       for name in outs[0]}

    return epoch_fn, place_state, place_data


# -- optimizer state over shards: whole tensors in, whole tensors out ---------

def _encode(value):
    if isinstance(value, torch.Tensor):
        return "", value
    if isinstance(value, bool):
        return "@bool", np.asarray(value)
    if isinstance(value, int):
        return "@int", np.asarray(value, np.int64)
    if isinstance(value, float):
        return "@float", np.asarray(value, np.float64)
    raise TypeError(f"optimizer state holds a {type(value).__name__}, not "
                    f"a tensor or a number")


def optimizer_state_tree(state: PjitState) -> dict:
    """The optimizer's per-parameter state as whole tensors (shards'
    state concatenated along their parameter's dim, all-gathered where a
    row spans processes: then a collective of every process), keyed by
    parameter name, plus a guard's ``[scale, good_steps]``: a checkpoint
    that restores onto any model-axis size."""
    opt = state.opt_state
    inner = _inner(opt)
    out, joins = {}, []
    for name, p in state.params.items():
        parts = p.shards if isinstance(p, Sharded) else [p]
        states = [inner.state.get(t, {}) for t in parts]
        if not states[0]:
            continue
        entry = {}
        for key, v0 in states[0].items():
            if v0 is None:
                continue
            if isinstance(p, Sharded) and isinstance(v0, torch.Tensor) \
                    and tuple(v0.shape) == tuple(parts[0].shape):
                joins.append((entry, key, dataclasses.replace(
                    p, shards=[s[key] for s in states])))
                continue
            tag, value = _encode(v0)
            entry[key + tag] = value
        out[name] = entry
    whole = _join([j[2] for j in joins], None) if joins else []
    for (entry, key, _), value in zip(joins, whole):
        entry[key] = value
    tree = {"state": out}
    if isinstance(opt, precision_lib.OverflowGuardState):
        tree["guard"] = np.array([opt.scale, opt.good_steps], np.float64)
    return tree


def load_optimizer_state_tree(state: PjitState, tree: Mapping) -> None:
    """Put :func:`optimizer_state_tree`'s output back into ``state``'s
    optimizer, splitting whole tensors into the shards this process
    holds, through ``load_state_dict`` (which places each tensor as
    torch's own resume does)."""
    opt = state.opt_state
    inner = _inner(opt)
    index, restored = 0, {}
    saved = tree.get("state", {})
    for name, p in state.params.items():
        parts = p.shards if isinstance(p, Sharded) else [p]
        entry = saved.get(name)
        for m, t in enumerate(parts):
            if entry is not None:
                values = {}
                for key, value in entry.items():
                    base, _, kind = key.partition("@")
                    if kind == "int":
                        values[base] = int(value)
                    elif kind == "float":
                        values[base] = float(value)
                    elif kind == "bool":
                        values[base] = bool(value)
                    else:
                        v = value if isinstance(value, torch.Tensor) \
                            else torch.from_numpy(np.array(value))
                        if isinstance(p, Sharded) and \
                                tuple(v.shape) == tuple(p.shape):
                            v = p.split(v)[m]
                        values[base] = v.clone()
                restored[index] = values
            index += 1
    sd = inner.state_dict()
    inner.load_state_dict({"state": restored,
                           "param_groups": sd["param_groups"]})
    if isinstance(opt, precision_lib.OverflowGuardState) and "guard" in tree:
        guard = np.asarray(tree["guard"])
        opt.scale, opt.good_steps = float(guard[0]), int(guard[1])


@torch.no_grad()
def load_params(state: PjitState, params: Mapping) -> None:
    """Copy whole tensors (name -> tensor or array) into ``state``'s
    replicated tensors and the shards this process holds, in place."""
    for name, p in state.params.items():
        x = params[name] if isinstance(params[name], torch.Tensor) \
            else torch.from_numpy(np.array(params[name]))
        if isinstance(p, Sharded):
            for s, c in zip(p.shards, p.split(x)):
                s.copy_(c)
        else:
            p.copy_(x)


# -- staging (numpy; the workers' slices are placed by place_data) -----------

def stage_steps(dataset, features_col: str, label_col: str, batch_size: int,
                max_steps: Optional[int] = None) -> tuple:
    """``[steps, batch, ...]`` arrays from a Dataset (the global batch;
    ``place_data`` splits the batch over the workers). Whole-epoch
    resident; see :func:`stage_step_chunks` for O(chunk) staging."""
    n = len(dataset)
    steps = n // batch_size
    if max_steps is not None:
        steps = min(steps, max_steps)
    if steps == 0:
        raise ValueError(f"{n} rows cannot form one batch of {batch_size}")
    cut = steps * batch_size

    def stack(col):
        arr = np.asarray(dataset[col][:cut])
        return arr.reshape((steps, batch_size) + arr.shape[1:])

    return {"features": stack(features_col),
            "labels": stack(label_col)}, steps


def stage_step_chunks(dataset, features_col: str, label_col: str,
                      batch_size: int, chunk_steps: Optional[int] = None,
                      max_steps: Optional[int] = None):
    """Yield ``(host_data, steps)`` chunks of at most ``chunk_steps``
    steps, keeping staging memory O(chunk) instead of O(epoch); the
    caller places each chunk with the epoch fn's ``place_data``. The
    final chunk may be ragged."""
    n = len(dataset)
    steps = n // batch_size
    if max_steps is not None:
        steps = min(steps, max_steps)
    if steps == 0:
        raise ValueError(f"{n} rows cannot form one batch of {batch_size}")
    if chunk_steps is None:
        chunk_steps = steps
    # columns stay lazy (views/memmaps/ShardedColumns); materialized per
    # chunk so file-backed datasets stream from disk in O(chunk) pieces
    arrs = {"features": dataset[features_col],
            "labels": dataset[label_col]}
    for start in range(0, steps, chunk_steps):
        cnt = min(chunk_steps, steps - start)
        lo = start * batch_size
        hi = lo + cnt * batch_size
        yield {key: np.asarray(a[lo:hi]).reshape(
                   (cnt, batch_size) + tuple(a.shape[1:]))
               for key, a in arrs.items()}, cnt
