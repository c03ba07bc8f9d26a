"""The trainer API (port of ``distkeras_tpu/trainers.py``): ``Trainer``
and its zoo, ``SingleTrainer``, ``AveragingTrainer``, ``EnsembleTrainer``
and the exchanging family ``DOWNPOUR``, ``ADAG``, ``DynSGD``, ``AEASGD``,
``EAMSGD``, with the JAX package's constructor kwargs and validation
messages.

Execution: a worker is one of K logical replicas on a
:class:`~distkeras_tpu_torch.parallel.mesh.Mesh` of this process's
devices (every visible card by default, as JAX's ``jax.devices()``;
``parallelism_factor=K`` stacks K replicas on each), run by :mod:`~distkeras_tpu_torch.parallel.substrate`;
the center is a tensor dict on the mesh's first device.

Where the port differs from the JAX package, by design:

- ``train()`` starts from the weights the module holds (load flax
  params with :mod:`~distkeras_tpu_torch.utils.bridge` to start where
  JAX starts); the JAX trainer initializes from ``jax.random.key(seed)``.
  ``EnsembleTrainer`` gives member ``k`` a fresh init from ``(seed,
  k)``. ``train()`` returns the trained parameters as a name -> tensor
  dict and loads them into ``trainer.model``;
- placement: the mesh comes from ``make_mesh`` over
  :func:`~distkeras_tpu_torch.device.visible_devices` (every visible card
  in one process, this process's card in a group; raising without a
  card) unless the caller passes ``mesh=`` or ``device=`` (the one added
  kwarg; ``device="cpu"`` runs on the host);
- checkpoints (``checkpoint_dir=``, ``resume=True``) are DKTP2 steps
  of :mod:`~distkeras_tpu_torch.checkpoint`, not Orbax's: a carry's
  ``torch.optim`` state and the counters come back with the weights, so
  a resumed run continues the uninterrupted one bit for bit;
- ``mode="host_async"`` runs ``num_workers`` threads against a live
  parameter server (:mod:`~distkeras_tpu_torch.parallel.host_async`);
  worker ``k`` runs on ``devices[k % D]`` (default ``visible_devices()``,
  JAX's ``jax.local_devices()``, or ``[device]``). In one process ``ps_shards``, ``ps_placement`` and
  ``ps_standby`` are validated and one in-process server runs, as in the
  JAX package; over several processes they build the service fleet of
  ``run_cross_process``; snapshots ``{"center", "clock"}`` are DKTP2 steps every
  ``checkpoint_folds`` commits, and ``resume=True`` continues the clock;
- ``precision=`` on a built model re-stamps it
  (:func:`~distkeras_tpu_torch.precision.apply_to_model`: the model
  rebuilt from its constructor kwargs, holding its weights);
- ``PjitTrainer`` runs a workers x model mesh
  (:mod:`~distkeras_tpu_torch.parallel.tensor`), over several processes
  at model axis 1;
- the data plane: a ``GlobalShards`` pool under
  ``data_layout="host_sharded"`` is re-dealt each epoch (sync and
  ``host_async``), and ``data_service=`` (a
  :class:`~distkeras_tpu_torch.data.service.DataCoordinator` or its
  address) feeds ``host_async`` workers lease-driven rounds; with the
  coordinator object in hand its ``[epoch, watermark]`` cursor rides
  every snapshot as ``data_cursor`` and is restored on ``resume``;
- over several processes (a ``torch.distributed`` group,
  :mod:`~distkeras_tpu_torch.parallel.distributed`) the JAX package's
  contracts hold: a sync mesh spans the processes, each runs its own
  worker rows and the folds are summed across them; ``"host_sharded"``
  data holds this process's workers' rows only, ``"replicated"`` data
  is the full dataset that each process cuts its workers' shards from;
  ``mode="host_async"`` splits ``num_workers`` near-evenly over the
  processes against process 0's live center
  (:func:`~distkeras_tpu_torch.parallel.host_async.run_cross_process`);
  history, staleness and the final parameters are the same on every
  process, and process 0 alone writes checkpoints; ``PjitTrainer``'s
  model axis spans processes too (a row inside a process, or over
  several, its shards held by their owners,
  :mod:`~distkeras_tpu_torch.parallel.tensor`);
- what is not ported raises NotImplementedError naming its ROADMAP.md
  Queue A item: a fold of card tensors across processes that each hold
  a card of their own (NCCL's, item 16 part 4).
"""

from __future__ import annotations

import copy
import os
import sys
import time
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from distkeras_tpu_torch import device as device_lib
from distkeras_tpu_torch import engine, telemetry
from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.ops import losses as losses_lib
from distkeras_tpu_torch.ops import optimizers as opt_lib
from distkeras_tpu_torch.parallel import distributed
from distkeras_tpu_torch.parallel import mesh as mesh_lib
from distkeras_tpu_torch.parallel.elastic import PLACEMENT_POLICIES
from distkeras_tpu_torch.telemetry import span
from distkeras_tpu_torch.utils import rng
from distkeras_tpu_torch.utils.trees import tree_add, tree_mean, tree_scale


def _params_of(model: torch.nn.Module) -> dict:
    return {n: p.detach() for n, p in model.named_parameters()}


@torch.no_grad()
def _load(model: torch.nn.Module, params: dict) -> None:
    for n, p in model.named_parameters():
        p.copy_(params[n])


def _tensor(value) -> torch.Tensor:
    """A restored leaf as a tensor (numpy leaves copied: they are views
    of the container's bytes)."""
    return value if isinstance(value, torch.Tensor) \
        else torch.from_numpy(np.array(value))


def _leaves(tree, prefix=()):
    """``[(path, leaf)]`` of a nested dict."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _leaves(tree[key], prefix + (key,))
        return out
    return [(prefix, tree)]


def _carry_tree(carry) -> dict:
    """A strategy carry as a checkpoint tree: its parameters, its
    optimizer's state and its strategy tensors (EAMSGD's velocity)."""
    from distkeras_tpu_torch.checkpoint import optimizer_tree

    tree = {"params": {n: p.detach() for n, p in carry.params.items()},
            "opt": optimizer_tree(carry.opt_state)}
    if isinstance(carry.extra, dict):
        tree["extra"] = dict(carry.extra)
    return tree


@torch.no_grad()
def _load_carry(carry, tree: dict) -> None:
    """Put a :func:`_carry_tree` back into ``carry``, in place (its
    optimizer stays bound to its tensors)."""
    from distkeras_tpu_torch.checkpoint import load_optimizer_tree

    for n, p in carry.params.items():
        p.copy_(_tensor(tree["params"][n]))
    load_optimizer_tree(carry.opt_state, tree.get("opt", {}))
    if isinstance(carry.extra, dict):
        for n, v in carry.extra.items():
            carry.extra[n] = _tensor(tree["extra"][n]).to(v.device, v.dtype)


def _train_state_tree(state) -> dict:
    """A :class:`~distkeras_tpu_torch.engine.TrainState` as a tree."""
    from distkeras_tpu_torch.checkpoint import optimizer_tree

    return {"params": _params_of(state.model),
            "opt": optimizer_tree(state.opt_state),
            "step": np.asarray(state.step, np.int64)}


def _load_train_state(state, tree: dict):
    from distkeras_tpu_torch.checkpoint import load_optimizer_tree

    _load(state.model, {n: _tensor(v) for n, v in tree["params"].items()})
    load_optimizer_tree(state.opt_state, tree.get("opt", {}))
    return engine.TrainState(step=int(tree["step"]), model=state.model,
                             opt_state=state.opt_state)


class Trainer:
    """Base trainer: the model, loss, worker optimizer, and the
    training-time and history bookkeeping."""

    def __init__(self, model, loss: Union[str, object] =
                 "categorical_crossentropy",
                 worker_optimizer: Union[str, object] = "sgd",
                 learning_rate: float = 0.01,
                 metrics: Sequence[str] = ("accuracy",),
                 features_col: str = "features", label_col: str = "label",
                 batch_size: int = 32, num_epoch: int = 1, seed: int = 0,
                 loss_weights=None,
                 checkpoint_dir: Optional[str] = None,
                 telemetry_path: Optional[str] = None,
                 precision: Optional[str] = None,
                 weight_publisher=None, device=None):
        self.model = model
        #: optional serving/rollout.py WeightPublisher: trained snapshots
        #: are published per sync epoch and at the end of training
        self.weight_publisher = weight_publisher
        self.loss = loss
        base_loss = losses_lib.get(loss)  # fail fast on unknown names
        # one scalar weight scaling the (single-output) loss; anything
        # else is rejected rather than silently dropped
        if loss_weights is not None:
            ws = list(np.ravel(loss_weights)) \
                if isinstance(loss_weights, (list, tuple, np.ndarray)) \
                else [loss_weights]
            if len(ws) != 1 or isinstance(ws[0], bool) or \
                    not isinstance(ws[0], (int, float, np.number)):
                raise ValueError(
                    f"loss_weights={loss_weights!r}: models here are "
                    f"single-output, so exactly ONE numeric weight is "
                    f"meaningful (a scalar or one-element list)")
            w = float(ws[0])
            self.loss = lambda logits, labels: w * base_loss(logits, labels)
        self.loss_weights = loss_weights
        self.worker_optimizer = worker_optimizer
        self.learning_rate = learning_rate
        self.metrics = tuple(metrics)
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        self.seed = int(seed)
        self.checkpoint_dir = checkpoint_dir
        self.telemetry_path = telemetry_path
        if telemetry_path is not None:
            telemetry.flush_at_exit(telemetry_path)
        self.tx = opt_lib.get(worker_optimizer, learning_rate)
        # mixed precision: validate early and re-stamp the model with the
        # policy; the optimizer is guard-wrapped only when the policy
        # scales the loss
        self.precision = precision_lib.validate_precision(precision)
        if self.precision is not None:
            self.model = precision_lib.apply_to_model(self.model,
                                                      self.precision)
            policy = precision_lib.get_policy(self.precision)
            if policy.loss_scale != 1.0:
                self.tx = precision_lib.overflow_guard(self.tx, policy)
        self.device = device
        self.params = None
        self.history: list[dict] = []
        self.training_time: float = 0.0

    # -- checkpointing (per epoch; the reference had none) -------------------
    def _checkpointer(self, items=None):
        if self.checkpoint_dir is None:
            return None
        from distkeras_tpu_torch.checkpoint import Checkpointer

        return Checkpointer(self.checkpoint_dir, items=items)

    @staticmethod
    def _check_fresh_dir(ckpt) -> None:
        """A checkpoint directory that holds steps with ``resume=False``
        is an error: keeping them would let a crash retry resume the
        stale run, and deleting them would destroy that run's
        checkpoints."""
        if ckpt.latest_step() is not None:
            raise ValueError(
                f"checkpoint_dir {ckpt.directory!r} already contains "
                f"steps {ckpt.all_steps()} but resume=False. Pass "
                "resume=True to continue that run, point checkpoint_dir "
                "at a fresh directory, or clear it explicitly "
                "(distkeras_tpu_torch.checkpoint.Checkpointer(dir).clear())")

    @staticmethod
    def _maybe_resume(ckpt, resume: bool):
        """``(saved tree or None, start_epoch)``: the latest epoch
        checkpoint if asked and present. History is not checkpointed: a
        resumed trainer's history covers the epochs it ran."""
        if ckpt is None:
            return None, 0
        if not resume:
            Trainer._check_fresh_dir(ckpt)
            return None, 0
        step = ckpt.latest_step()
        if step is None:
            return None, 0
        return ckpt.restore(step=step), step + 1

    # -- bookkeeping (record_training_time parity) -------------------------
    def _start(self):
        telemetry.set_process_index(distributed.process_index())
        from distkeras_tpu_torch.health import recorder as flight_recorder

        # crash bundles land where the crash checkpoint does
        dump_dir = self.checkpoint_dir
        if dump_dir is None and self.telemetry_path is not None:
            dump_dir = os.path.dirname(self.telemetry_path) or "."
        flight_recorder.configure(
            dump_dir=dump_dir,
            trainer=type(self).__name__,
            precision=self.precision,
            worker_optimizer=str(self.worker_optimizer),
            batch_size=self.batch_size,
            codec=str(getattr(self, "codec", None)),
            num_workers=getattr(self, "num_workers", 1))
        self.model.train()
        self._t0 = time.perf_counter()

    def _stop(self, device):
        self.training_time = time.perf_counter() - self._t0
        telemetry.gauge("trainer.training_time_s").set(self.training_time)
        if self.weight_publisher is not None and self.params is not None:
            self.weight_publisher.publish(self.params)
        from distkeras_tpu_torch import observability

        observability.hbm_stats(device)
        if self.telemetry_path is not None:
            self.dump_telemetry(self.telemetry_path)

    # -- telemetry ----------------------------------------------------------
    def get_telemetry(self) -> dict:
        """Snapshot of the process registry (empty when uninstalled)."""
        reg = telemetry.get_registry()
        return reg.snapshot() if reg is not None else {}

    def dump_telemetry(self, path: str) -> Optional[str]:
        reg = telemetry.get_registry()
        return reg.dump_jsonl(path) if reg is not None else None

    def get_training_time(self) -> float:
        return self.training_time

    def get_history(self) -> list[dict]:
        return self.history

    def get_averaged_history(self) -> dict:
        """Mean of each metric over the recorded steps."""
        if not self.history:
            return {}
        keys = self.history[0].keys()
        return {k: float(np.mean([h[k] for h in self.history])) for k in keys}

    # -- shared plumbing ----------------------------------------------------
    @staticmethod
    def _reject_global_shards(dataset, trainer_name: str):
        """Clear error instead of an opaque AttributeError when a
        GlobalShards pool reaches a trainer whose data path cannot re-deal
        files (Single/Pjit consume row streams, not per-worker shards)."""
        from distkeras_tpu_torch.data.global_shards import GlobalShards

        if isinstance(dataset, GlobalShards):
            raise ValueError(
                f"{trainer_name} does not support GlobalShards (cross-host "
                f"shard re-dealing maps to the async zoo's host_sharded "
                f"per-worker shards); pass a Dataset — e.g. "
                f"Dataset.from_files — or use a DistributedTrainer with "
                f"data_layout='host_sharded'")

    def _check_trainable(self, dataset: Dataset, effective_batch: int):
        if len(dataset) < effective_batch:
            raise ValueError(
                f"Dataset has {len(dataset)} rows but one step needs "
                f"{effective_batch}; no full batch can be formed "
                f"(static-shape batching drops the ragged tail)")

    #: whole-epoch-resident staging above this estimate warns to use the
    #: chunked knob (staging_rounds / staging_steps) instead
    _RESIDENT_WARN_BYTES = 4 << 30

    def _resident_bytes(self, dataset: Dataset) -> int:
        try:
            return sum(
                np.dtype(dataset[c].dtype).itemsize *
                int(np.prod(dataset[c].shape))
                for c in (self.features_col, self.label_col))
        except Exception:
            return 0

    def _warn_if_large_resident(self, dataset: Dataset, knob: str):
        total = self._resident_bytes(dataset)
        if total > self._RESIDENT_WARN_BYTES:
            warnings.warn(
                f"Staging the whole epoch device-resident "
                f"(~{total / 2**30:.1f} GiB). Pass {knob}= to bound device "
                f"data memory to O(chunk) with background prefetch.",
                RuntimeWarning, stacklevel=3)

    @staticmethod
    def _epoch_chunk_stream(staged, make_gen, resident: bool):
        """``(chunks, staged)``: ``resident=True`` materializes the
        generator once and reuses it every epoch; otherwise chunks stream
        through a depth-1 background prefetch (double buffering)."""
        if staged is not None:
            return staged, staged
        gen = make_gen()
        if resident:
            staged = list(gen)
            return staged, staged
        from distkeras_tpu_torch.data.prefetch import prefetch

        return prefetch(gen, depth=1), None

    def train(self, dataset: Dataset, shuffle: bool = False,
              resume: bool = False):
        raise NotImplementedError


class DistributedTrainer(Trainer):
    """Base of every multi-replica trainer: the JAX package's kwargs
    (``master_port`` accepted and ignored, as there), ``mode="sync"``
    only. ``strategy_name`` selects the update algebra
    (:mod:`~distkeras_tpu_torch.parallel.strategies`)."""

    strategy_name: str = "downpour"

    def __init__(self, model, loss="categorical_crossentropy",
                 worker_optimizer="sgd", learning_rate: float = 0.01,
                 metrics=("accuracy",), features_col="features",
                 label_col="label", batch_size: int = 32, num_epoch: int = 1,
                 num_workers: Optional[int] = None,
                 communication_window: int = 5,
                 parallelism_factor: int = 1,
                 master_port: Optional[int] = None,  # parity no-op
                 mesh=None, seed: int = 0, mode: str = "sync",
                 loss_weights=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_folds: Optional[int] = None,
                 staging_rounds: Optional[int] = None,
                 data_layout: str = "replicated",
                 devices=None,
                 telemetry_path: Optional[str] = None,
                 codec: str = "raw",
                 comms_overlap: bool = False,
                 health=None,
                 accum_steps: int = 1,
                 precision: Optional[str] = None,
                 bucket_bytes: Optional[int] = None,
                 ps_shards: int = 1,
                 ps_placement: str = "process0",
                 ps_standby: bool = False,
                 weight_publisher=None,
                 data_service=None,
                 device=None,
                 **strategy_kwargs):
        super().__init__(model, loss, worker_optimizer, learning_rate,
                         metrics, features_col, label_col, batch_size,
                         num_epoch, seed, loss_weights=loss_weights,
                         checkpoint_dir=checkpoint_dir,
                         telemetry_path=telemetry_path,
                         precision=precision,
                         weight_publisher=weight_publisher, device=device)
        if mode not in ("sync", "host_async"):
            raise ValueError(f"mode must be 'sync' or 'host_async', "
                             f"got {mode!r}")
        self.mode = mode
        self.parallelism_factor = int(parallelism_factor)
        if self.parallelism_factor < 1:
            raise ValueError("parallelism_factor must be >= 1")
        if mode == "host_async":
            # thread-per-worker against a live PS; no mesh involved
            if mesh is not None:
                raise ValueError(
                    "mesh and mode='host_async' are contradictory: async "
                    "workers are host threads, not mesh replicas")
            self.mesh = None
            if num_workers is None:
                raise ValueError("host_async mode needs explicit num_workers")
            # host threads oversubscribe a device natively; the factor
            # multiplies the thread count (reference: partitions per worker)
            self.num_workers = int(num_workers) * self.parallelism_factor
            # worker k runs on devices[k % D]
            if devices:
                self.devices = [resolve_device(d) for d in devices]
            elif device is not None:
                self.devices = [resolve_device(device)]
            else:  # JAX's jax.local_devices()
                self.devices = device_lib.visible_devices()
        else:
            if devices is not None:
                raise ValueError(
                    "devices= is a host_async knob; sync mode places "
                    "workers via the mesh")
            if mesh is None:
                mesh = mesh_lib.make_mesh(
                    num_workers, devices=None if device is None
                    else [resolve_device(device)])
            self.mesh = mesh
            self.devices = None
            # K logical workers = factor x mesh devices; each device runs
            # `factor` stacked replicas (see substrate.build_epoch_fn)
            self.num_workers = (self.mesh.shape[mesh_lib.WORKER_AXIS]
                                * self.parallelism_factor)
        if checkpoint_folds is not None and mode != "host_async":
            raise ValueError(
                "checkpoint_folds is the host_async snapshot cadence; sync "
                "mode checkpoints at epoch boundaries (checkpoint_dir alone)")
        if checkpoint_folds is not None and checkpoint_dir is None:
            raise ValueError(
                "checkpoint_folds sets the snapshot cadence but "
                "checkpoint_dir is None — there is nowhere to save; pass "
                "checkpoint_dir too (silently taking no snapshots would "
                "defeat the fault tolerance you asked for)")
        # host_async snapshot cadence (commits between snapshots); one
        # full round of folds (num_workers) when left None
        self.checkpoint_folds = checkpoint_folds
        if data_layout not in ("replicated", "host_sharded"):
            raise ValueError(
                f"data_layout must be 'replicated' (every process holds the "
                f"full dataset) or 'host_sharded' (each process's dataset "
                f"holds ONLY its own workers' rows), got {data_layout!r}")
        # in one process host_sharded is the replicated case
        self.data_layout = data_layout
        if data_service is not None:
            if mode != "host_async":
                raise ValueError(
                    "data_service= streams lease-driven rounds to "
                    "host_async worker threads; sync mode stages from a "
                    "local Dataset — use mode='host_async'")
            if data_layout != "replicated":
                raise ValueError(
                    "data_service replaces the data_layout contracts (the "
                    "coordinator leases ranges to every worker wherever "
                    "it runs); leave data_layout='replicated'")
        # a DataCoordinator (its cursor then rides every snapshot) or the
        # "host:port" of one
        self.data_service = data_service
        self.communication_window = int(communication_window)
        # None: stage the whole epoch device-resident; an int bounds
        # staging memory to O(staging_rounds), prefetched on a thread
        self.staging_rounds = staging_rounds
        self.strategy = self._make_strategy(**strategy_kwargs)
        if mode == "host_async" and not self.strategy.exchanges:
            raise ValueError(
                "host_async mode requires an exchanging strategy "
                "(DOWNPOUR/ADAG/DynSGD/AEASGD/EAMSGD)")
        from distkeras_tpu_torch import comms as comms_lib

        comms_lib.get_codec(codec)  # validate the name at construction
        if mode != "host_async" and (codec != "raw" or comms_overlap):
            raise ValueError(
                "codec/comms_overlap tune the host_async parameter-server "
                "exchange; sync mode folds commits in-graph (no wire)")
        self.codec = codec
        self.comms_overlap = bool(comms_overlap)
        # the sharded parameter-server fleet and its failover: in one
        # process the JAX package validates these and runs one
        # in-process server; so does the port
        self.ps_shards = int(ps_shards)
        if self.ps_shards < 1:
            raise ValueError(f"ps_shards must be >= 1, got {ps_shards}")
        if self.ps_shards > 1 and mode != "host_async":
            raise ValueError(
                "ps_shards shards the host_async parameter service; sync "
                "mode has no parameter server to shard")
        if ps_placement not in PLACEMENT_POLICIES:
            raise ValueError(f"ps_placement must be one of "
                             f"{PLACEMENT_POLICIES}, got {ps_placement!r}")
        if mode != "host_async" and (ps_placement != "process0"
                                     or ps_standby):
            raise ValueError(
                "ps_placement/ps_standby configure the host_async "
                "parameter-service fleet; sync mode has no parameter "
                "server to place or fail over")
        self.ps_placement = ps_placement
        self.ps_standby = bool(ps_standby)
        from distkeras_tpu_torch import health as health_lib

        self.health = health_lib.resolve(health)
        self.accum_steps = int(accum_steps)
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if self.batch_size % self.accum_steps != 0:
            raise ValueError(
                f"accum_steps={self.accum_steps} must divide "
                f"batch_size={self.batch_size}: each step is a scan over "
                f"accum_steps equal microbatches (unequal microbatches would "
                f"break the mean-loss equivalence — see NUMERICS.md)")
        if bucket_bytes is not None:
            bucket_bytes = int(bucket_bytes)
            if bucket_bytes <= 0:
                raise ValueError(
                    f"bucket_bytes must be positive, got {bucket_bytes}")
        self.bucket_bytes = bucket_bytes
        self.num_updates = 0
        self.staleness_history: list[float] = []

    def _make_strategy(self, **kw):
        from distkeras_tpu_torch.parallel import strategies

        return strategies.get(self.strategy_name,
                              learning_rate=self.learning_rate, **kw)

    def _init_carries(self, center_params: dict):
        from distkeras_tpu_torch.parallel import substrate

        return substrate.init_center_and_carries(
            center_params, self.tx, self.strategy, self.mesh,
            self.num_workers)

    def _record(self, ms: dict, rounds: int):
        """Flatten (workers, rounds, window) metrics into worker-averaged
        per-step history plus the staleness bookkeeping."""
        stal = ms.pop("staleness")  # (workers, rounds)
        self.staleness_history.extend(
            float(s) for s in stal.mean(axis=0).reshape(-1))
        w, r, win = ms["loss"].shape
        wd = getattr(self, "_watchdog", None)  # sync-path health checks:
        for ri in range(r):                    # post-epoch, on the worker-
            for si in range(win):              # mean loss stream
                step = {k: float(v[:, ri, si].mean()) for k, v in ms.items()}
                self.history.append(step)
                if wd is not None:
                    wd.observe_loss(step["loss"])
        if wd is not None:
            wd.notify_progress()
        if self.strategy.exchanges:  # PS clock: only real commits count
            self.num_updates += rounds * self.num_workers

    def _setup_state(self, dataset: Dataset):
        """(center, carries), all replicas starting from the module's
        weights."""
        return self._init_carries(_params_of(self.model))

    def _resume_elastic(self, ckpt, center, carries, resume: bool):
        """Topology-aware resume: ``(center, carries, counters,
        start_epoch)``, counters = [round_offset, num_updates,
        saved_num_workers].

        The same worker count (read from the step's manifests, no array
        data): a full restore of the center, every carry's parameters,
        optimizer state and strategy tensors, and the counters, so the
        run continues bit for bit. A different worker count: the center
        and counters only, every replica re-initialized from it, with a
        warning (worker-local state is discarded). Strategies that never
        exchange (Averaging, Ensemble) refuse: their training lives in
        the replicas."""
        zero = np.zeros((3,), np.int64)
        if ckpt is None:
            return center, carries, zero, 0
        if not resume:
            self._check_fresh_dir(ckpt)
            return center, carries, zero, 0
        step = ckpt.latest_step()
        if step is None:
            return center, carries, zero, 0
        names = ckpt.step_items(step)
        if "state" not in names or "carries" not in names:
            raise ValueError(
                f"checkpoint step {step} in {ckpt.directory!r} has items "
                f"{names}, not the state+carries pair this trainer writes; "
                f"it was written by a different mode/trainer (a "
                f"SingleTrainer saves one 'default' item). Resume it with "
                f"the trainer it was written by.")
        saved = ckpt.metadata(step, item="carries")
        saved_workers = len(saved)

        def parse_counters(raw) -> np.ndarray:
            out = zero.copy()
            got = np.asarray(raw).ravel()
            out[:min(3, len(got))] = got[:3]
            if len(got) < 3:
                out[2] = saved_workers
            return out

        if saved_workers == self.num_workers:
            # a strategy change is a clear error before any data is read
            def shapes(tree):
                return sorted(tuple(m.shape) for _, m in _leaves(
                    {k: tree.get(k, {}) for k in ("params", "extra")}))

            ids = self._local_worker_ids()
            current = [_carry_tree(c) for c in carries]
            if [shapes(saved[str(k)]) for k in ids] != [
                    shapes(c) for c in current]:
                raise ValueError(
                    f"checkpoint step {step} matches "
                    f"num_workers={saved_workers} but its carry structure "
                    f"does not match this trainer's strategy "
                    f"({self.strategy.name!r}); resuming needs the strategy "
                    f"the checkpoint was written with")
            snap = ckpt.restore(step=step)
            center = {n: _tensor(x).to(self.mesh.home)
                      for n, x in snap["state"]["center"].items()}
            for k, carry in zip(ids, carries):
                _load_carry(carry, snap["carries"][str(k)])
            return (center, carries,
                    parse_counters(snap["state"]["counters"]), step + 1)
        if not self.strategy.exchanges:
            raise ValueError(
                f"Cannot elastically resume {type(self).__name__} across a "
                f"topology change (checkpoint: {saved_workers} workers, "
                f"trainer: {self.num_workers}): with the "
                f"{self.strategy.name!r} strategy the training state lives "
                f"in the per-worker replicas (the center never moves), so "
                f"a center-only restore would discard the training. Resume "
                f"with num_workers={saved_workers}.")
        warnings.warn(
            f"ELASTIC RESUME: checkpoint step {step} was written by a "
            f"{saved_workers}-worker run; this trainer has "
            f"{self.num_workers}. Restoring the CENTER + counters only "
            f"and re-initializing every worker replica from the restored "
            f"center — worker-local state (elastic replicas, momenta, "
            f"optimizer slots) is discarded, so the continuation is a "
            f"documented trajectory break from the uninterrupted run.",
            RuntimeWarning, stacklevel=3)
        state = ckpt.restore(step=step, items=("state",))["state"]
        new_center = {n: _tensor(x) for n, x in state["center"].items()}
        new_center, new_carries = self._init_carries(new_center)
        return (new_center, new_carries, parse_counters(state["counters"]),
                step + 1)

    def _local_worker_ids(self) -> list:
        """The global ids of this process's workers (all K in one
        process)."""
        from distkeras_tpu_torch.parallel import substrate

        return substrate.local_workers(self.mesh, self.num_workers)

    def _all_trees(self, trees: list) -> list:
        """Every worker's tree (a nested dict of tensors or arrays), in
        worker order, from this process's workers' ``trees``. Over
        processes (each with as many workers, process 0's first) each
        leaf is all-gathered into numpy: a collective every process
        calls."""
        if not self.mesh.spans_processes:
            return trees
        count = distributed.process_count()
        if self._local_worker_ids() != list(range(
                distributed.process_index() * len(trees),
                (distributed.process_index() + 1) * len(trees))) \
                or len(trees) * count != self.num_workers:
            raise ValueError(
                f"mesh owners {self.mesh.owners}: gathering every worker "
                f"needs as many workers on every process, in rank order")
        gathered = [[(path, distributed.process_allgather(
            leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf))) for path, leaf in _leaves(tree)]
            for tree in trees]
        out = []
        for p in range(count):
            for pairs in gathered:
                tree: dict = {}
                for path, stacked in pairs:
                    node = tree
                    for key in path[:-1]:
                        node = node.setdefault(key, {})
                    node[path[-1]] = stacked[p]
                out.append(tree)
        return out

    def train(self, dataset: Dataset, shuffle: bool = False,
              resume: bool = False):
        """Train on ``dataset``: a :class:`Dataset`, or a
        :class:`~distkeras_tpu_torch.data.global_shards.GlobalShards` pool
        under ``data_layout="host_sharded"`` (re-dealt each epoch; the
        dataset is epoch 0's view until the epoch loop re-resolves it).
        With ``data_service=`` the coordinator holds the rows and
        ``dataset`` may be None."""
        from distkeras_tpu_torch.data.global_shards import GlobalShards
        from distkeras_tpu_torch.parallel import substrate

        provider = dataset if isinstance(dataset, GlobalShards) else None
        if provider is not None:
            if self.data_layout != "host_sharded":
                raise ValueError(
                    "GlobalShards is the cross-host mixing source for "
                    "data_layout='host_sharded'; with 'replicated' every "
                    "host already sees the full dataset — pass a Dataset "
                    "(e.g. Dataset.from_files) instead")
            dataset = provider.epoch_dataset(0)
        if self.mode == "host_async":
            return self._train_host_async(dataset, shuffle, resume,
                                          provider=provider)
        self._start()
        multi = self.mesh.spans_processes
        if self.data_layout == "host_sharded":
            # this process stages its own mesh positions' shards only
            positions = mesh_lib.local_worker_positions(self.mesh)
            n_shards = len(positions) * self.parallelism_factor
        else:
            positions, n_shards = None, self.num_workers
        if positions is None or not multi:
            self._check_trainable(
                dataset,
                self.batch_size * self.communication_window * n_shards)
        # else: a short process is found by the round negotiation in
        # stage_epoch_chunks, where every process raises
        if self.staging_rounds is None:
            self._warn_if_large_resident(dataset, "staging_rounds")
        # the one module skeleton the replicas' tensors run through
        self.model.to(self.mesh.home)
        with span("trainer.init"):
            center, carries = self._setup_state(dataset)
        # the carries are their own item: a topology-change resume reads
        # the small state item alone
        ckpt = self._checkpointer(items=("state", "carries"))
        center, carries, counters, start_epoch = self._resume_elastic(
            ckpt, center, carries, resume)
        # built once per trainer: every argument is fixed at construction
        if getattr(self, "_epoch_fn", None) is None:
            with span("trainer.compile"):
                self._epoch_fn = substrate.build_epoch_fn(
                    self.model, self.loss, self.tx, self.strategy, self.mesh,
                    self.num_workers, self.communication_window, self.metrics,
                    dropout_seed=self.seed, accum_steps=self.accum_steps,
                    precision=self.precision,
                    bucket_bytes=self.bucket_bytes)
        epoch_fn = self._epoch_fn
        self.history = []
        self.staleness_history = []
        # fresh watchdog per train(); sync mode sees post-epoch means only
        self._watchdog = self.health.make_watchdog() \
            if self.health is not None else None
        round_offset = int(counters[0])
        self.num_updates = int(counters[1])
        staged = None  # shuffle=False + whole-epoch staging: stage once
        for epoch in range(start_epoch, self.num_epoch):
            # a pool is re-dealt each epoch: its epoch's view is staged anew
            ds_epoch = provider.epoch_dataset(epoch) if provider is not None \
                else dataset
            with span("trainer.stage"):
                chunks, staged = self._epoch_chunk_stream(
                    staged,
                    lambda: substrate.stage_epoch_chunks(
                        (ds_epoch.shuffle(self.seed + epoch)
                         if shuffle else ds_epoch).repartition(n_shards),
                        self.features_col, self.label_col, self.batch_size,
                        self.communication_window, self.mesh,
                        chunk_rounds=self.staging_rounds,
                        local_positions=positions),
                    resident=(not shuffle and self.staging_rounds is None
                              and provider is None))
            with span("trainer.epoch"):
                pending = []
                for data, rounds in chunks:
                    center, carries, ms = epoch_fn(center, carries, data,
                                                   round_offset)
                    round_offset += rounds
                    pending.append((ms, rounds))
                for ms, rounds in pending:
                    self._record({k: v.cpu().numpy() for k, v in ms.items()},
                                 rounds)
            if ckpt is not None:
                # counters[2] records the topology, so a later resume sees
                # a worker-count change before it reads any carry; over
                # processes every carry is gathered and process 0 writes
                trees = self._all_trees([_carry_tree(c) for c in carries])
                if distributed.process_index() == 0:
                    ckpt.save(epoch, {
                        "state": {"center": center,
                                  "counters": np.array(
                                      [round_offset, self.num_updates,
                                       self.num_workers], np.int64)},
                        "carries": trees})
                # every process reads the directory on resume: none goes
                # on before the step is on disk
                distributed.barrier()
            if self.weight_publisher is not None:
                self.weight_publisher.publish(dict(center),
                                              clock=round_offset)
        self._center, self._carries = center, carries
        with span("trainer.finalize"):
            self.params = self._finalize(center, carries)
            _load(self.model, self._model_params())
        self._stop(self.mesh.home)
        return self.params

    def _train_host_async(self, dataset: Dataset, shuffle: bool,
                          resume: bool = False, provider=None):
        """True wall-clock asynchrony: a thread per worker against a live
        parameter server (:mod:`~distkeras_tpu_torch.parallel.host_async`);
        staleness is real scheduling, not the substrate's rotation.

        There is no epoch barrier: the center and the server clock are
        snapshot every ``checkpoint_folds`` commits (default one round,
        ``num_workers`` folds). ``resume=True`` restores the latest
        snapshot: workers restart their data passes from the beginning,
        pull the restored center and continue its clock.

        The rounds come from ``dataset`` (staged once, or once an epoch
        when shuffling), from a ``GlobalShards`` ``provider`` (one
        epoch's re-dealt view staged per epoch), or with
        ``data_service=`` from one lease-driven
        :func:`~distkeras_tpu_torch.parallel.host_async.stream_worker_rounds`
        source a worker: the coordinator then owns the epochs and the
        shuffle (its ``seed``/``num_epochs``), and the rows."""
        from distkeras_tpu_torch.health import recorder as flight_recorder
        from distkeras_tpu_torch.parallel import host_async

        svc = self.data_service
        if svc is not None and shuffle:
            raise ValueError(
                "shuffle=True with data_service=: the coordinator "
                "already owns the global shuffle (its seed= argument); "
                "a second trainer-side shuffle would be dead code")
        self._start()
        nproc, pid = distributed.process_count(), distributed.process_index()
        multi = nproc > 1
        if multi:
            if self.num_workers < nproc:
                # known to every process: every process raises
                raise ValueError(
                    f"num_workers={self.num_workers} < process_count="
                    f"{nproc}: some process would own no workers")
            counts = [self.num_workers // nproc
                      + (1 if i < self.num_workers % nproc else 0)
                      for i in range(nproc)]
            worker_offset, local_workers = sum(counts[:pid]), counts[pid]
        else:
            worker_offset, local_workers = 0, self.num_workers
        per_round = self.batch_size * self.communication_window
        if svc is None and self.data_layout == "host_sharded" and multi:
            # the local dataset holds this process's workers' rows only:
            # sufficiency is per process, so it is agreed before any
            # other collective and every process raises
            oks = distributed.process_allgather(np.int64(
                len(dataset) // local_workers // per_round)).ravel()
            if oks.min() == 0:
                short = np.flatnonzero(oks == 0).tolist()
                raise ValueError(
                    f"Process(es) {short} cannot form one round of "
                    f"window={self.communication_window} x "
                    f"batch={self.batch_size} per local worker (this host "
                    f"is process {pid} with {len(dataset)} rows over "
                    f"{local_workers} workers)")

            def shards_of(ds):
                return ds.repartition(local_workers)
        else:
            if svc is None:
                self._check_trainable(dataset,
                                      per_round * self.num_workers)

            def shards_of(ds):
                return ds.repartition(self.num_workers)[
                    worker_offset:worker_offset + local_workers]
        home = self.devices[0]
        self.model.to(home)

        def stage(ds):
            return host_async.stage_worker_shards(
                shards_of(ds), self.features_col, self.label_col,
                self.batch_size, self.communication_window)

        with span("trainer.init"):
            init_params = _params_of(self.model)
        start_clock = 0
        # with the coordinator object in hand (not just its address) the
        # shuffle cursor rides every snapshot and is restored on resume:
        # the torn-coordinator recovery path (DESIGN.md §20)
        coord = svc if svc is not None and not isinstance(svc, str) \
            else None
        snapshot_extra = None
        if coord is not None:
            def snapshot_extra():
                return {"data_cursor": coord.cursor_carry()}
        # process 0 alone owns the live center's snapshots
        ckpt, ckpt_error = None, None
        if pid == 0:
            try:
                ckpt = self._checkpointer()
                if ckpt is not None:
                    snap, _ = self._maybe_resume(ckpt, resume)
                    if snap is not None:
                        init_params = {n: _tensor(x).to(home)
                                       for n, x in snap["center"].items()}
                        start_clock = int(
                            np.asarray(snap["clock"]).ravel()[0])
                        if coord is not None and "data_cursor" in snap:
                            coord.restore_cursor(snap["data_cursor"])
            except BaseException as e:
                if not multi:
                    raise
                ckpt_error = e  # the peers must hear first
        if multi:
            # process 0's checkpoint state is private: a one-sided raise
            # would leave the peers blocked in the address broadcast, so
            # every process agrees on go/no-go first
            flags = distributed.process_allgather(
                np.int64(0 if ckpt_error is None else 1)).ravel()
            if flags.any():
                if ckpt_error is not None:
                    raise ckpt_error
                raise ValueError(
                    f"checkpoint setup failed on process(es) "
                    f"{np.flatnonzero(flags).tolist()}; see their logs")

        def ds_for(e):
            ds = provider.epoch_dataset(e) if provider is not None \
                else dataset
            return ds.shuffle(self.seed + e) if shuffle else ds

        if svc is not None:
            # one epoch_shards entry: the coordinator streams all its
            # epochs through each worker's source until it reports the
            # stream exhausted; nothing is staged up front
            address = svc if isinstance(svc, str) else svc.address
            token = None if isinstance(svc, str) else svc.token
            with span("trainer.stage"):
                epoch_shards = [[host_async.stream_worker_rounds(
                    address, worker_offset + k, self.features_col,
                    self.label_col, self.batch_size,
                    self.communication_window, token=token)
                    for k in range(local_workers)]]
        elif shuffle or provider is not None:
            # workers cross epoch boundaries without barriers, so every
            # epoch's shards are staged host-resident up front
            per_epoch = self._resident_bytes(dataset)
            if per_epoch * self.num_epoch > self._RESIDENT_WARN_BYTES:
                warnings.warn(
                    f"host_async with per-epoch re-staging holds every "
                    f"epoch's shards host-resident "
                    f"(~{per_epoch * self.num_epoch / 2**30:.1f} GiB for "
                    f"{self.num_epoch} epochs). For large datasets use "
                    f"mode='sync' with staging_rounds= (O(chunk) memory).",
                    RuntimeWarning, stacklevel=3)
            with span("trainer.stage"):
                epoch_shards = [stage(ds_for(e))
                                for e in range(self.num_epoch)]
        else:
            with span("trainer.stage"):
                epoch_shards = [stage(dataset)] * self.num_epoch
        if getattr(self, "_async_runner", None) is None:
            with span("trainer.compile"):
                self._async_runner = host_async.HostAsyncRunner(
                    self.model, self.loss, self.tx, self.strategy,
                    self.communication_window, self.metrics, self.seed,
                    devices=self.devices, codec=self.codec,
                    overlap=self.comms_overlap,
                    accum_steps=self.accum_steps, precision=self.precision)
        runner = self._async_runner
        watchdog = None
        if self.health is not None:
            # fresh per train(): trip state must not leak across runs
            watchdog = self.health.make_watchdog()
            runner.straggler = self.health.make_straggler_detector()
        folds = (self.checkpoint_folds or self.num_workers) \
            if ckpt is not None else 0
        try:
            with span("trainer.epoch"):  # workers cross epoch boundaries
                if multi:
                    params, history, staleness, num_updates = \
                        host_async.run_cross_process(
                            runner, init_params, epoch_shards,
                            worker_offset=worker_offset, checkpointer=ckpt,
                            checkpoint_folds=folds, start_clock=start_clock,
                            watchdog=watchdog, ps_shards=self.ps_shards,
                            ps_placement=self.ps_placement,
                            ps_standby=self.ps_standby,
                            snapshot_extra=snapshot_extra)
                else:
                    params, history, staleness, num_updates = runner.run(
                        init_params, epoch_shards, checkpointer=ckpt,
                        checkpoint_folds=folds, start_clock=start_clock,
                        watchdog=watchdog, snapshot_extra=snapshot_extra)
        except BaseException:
            flight_recorder.auto_dump("trainer_exception")
            raise
        with span("trainer.finalize"):
            if ckpt is not None and \
                    num_updates > (ckpt.latest_step() or 0):
                final = {"center": params,
                         "clock": np.array([num_updates], np.int64)}
                if snapshot_extra is not None:
                    final.update(snapshot_extra())
                ckpt.save(num_updates, final)
            self.history = history
            self.staleness_history = staleness
            self.num_updates = num_updates
            self.params = {n: _tensor(x).to(home)
                           for n, x in params.items()}
            _load(self.model, self.params)
        self._stop(home)
        return self.params

    def _model_params(self) -> dict:
        """What ``trainer.model`` holds after training."""
        return self.params

    def _finalize(self, center: dict, carries: list):
        """The exchanging trainers return the center variable."""
        return {n: x.detach() for n, x in center.items()}


class DOWNPOUR(DistributedTrainer):
    """Async data-parallel SGD with windowed delta push/pull."""

    strategy_name = "downpour"


class ADAG(DistributedTrainer):
    """DOWNPOUR with accumulated-gradient normalization, the reference's
    flagship algorithm."""

    strategy_name = "adag"


class DynSGD(DistributedTrainer):
    """Staleness-aware async SGD: commits scaled by 1/(staleness+1)."""

    strategy_name = "dynsgd"


class AEASGD(DistributedTrainer):
    """Async elastic-averaging SGD. Extra kwargs: rho (elastic
    coefficient)."""

    strategy_name = "aeasgd"

    def __init__(self, model, rho: float = 5.0, **kw):
        super().__init__(model, rho=rho, **kw)


class EAMSGD(DistributedTrainer):
    """Elastic averaging with Nesterov momentum on the local replicas.
    Extra kwargs: rho, momentum. The local step is the explicit Nesterov
    rule, so a non-default ``worker_optimizer`` is rejected rather than
    silently ignored."""

    strategy_name = "eamsgd"

    def __init__(self, model, rho: float = 5.0, momentum: float = 0.9, **kw):
        opt = kw.get("worker_optimizer", "sgd")
        if opt != "sgd":
            raise ValueError(
                f"EAMSGD ignores worker_optimizer (its local step is the "
                f"explicit Nesterov rule v ← μv − η∇f(w + μv); see "
                f"NUMERICS.md), so worker_optimizer={opt!r} would silently "
                f"not be what you asked for. Leave it at the default, or "
                f"use AEASGD if you want an optax worker optimizer.")
        super().__init__(model, rho=rho, momentum=momentum, **kw)


class AveragingTrainer(DistributedTrainer):
    """Train K isolated replicas on K shards and return the arithmetic
    mean of their weights (summed in worker order, then scaled by
    1/K)."""

    strategy_name = "independent"

    @torch.no_grad()
    def _finalize(self, center: dict, carries: list):
        trees = [{n: x.detach().to(self.mesh.home)
                  for n, x in c.params.items()} for c in carries]
        if not self.mesh.spans_processes:
            return tree_mean(trees)
        # this process's replicas summed in worker order, the partial
        # sums summed across processes, then scaled as tree_mean scales
        from distkeras_tpu_torch.parallel.collectives import \
            cross_process_sum

        part = trees[0]
        for t in trees[1:]:
            part = tree_add(part, t)
        return tree_scale(cross_process_sum(part), 1.0 / self.num_workers)


class EnsembleTrainer(DistributedTrainer):
    """Train K isolated models and return all K parameter dicts (a list);
    ``trainer.model`` holds the first. Member ``k`` starts from a fresh
    init drawn from ``(seed, k)`` (the model module's ``init_params`` if
    it has one, else each layer's ``reset_parameters``) and trains on its
    own shard."""

    strategy_name = "independent"

    def _member_params(self) -> list:
        init = getattr(sys.modules[type(self.model).__module__],
                       "init_params", None)
        members = []
        for k in range(self.num_workers):
            clone = copy.deepcopy(self.model).to("cpu")
            seed = rng.fold_in(self.seed, k)
            if init is not None:
                init(clone, rng.generator(seed))
            else:
                with torch.random.fork_rng(devices=[]):
                    torch.manual_seed(seed)
                    for m in clone.modules():
                        if hasattr(m, "reset_parameters"):
                            m.reset_parameters()
            members.append(_params_of(clone))
        return members

    def _setup_state(self, dataset: Dataset):
        from distkeras_tpu_torch.parallel import substrate

        members = self._member_params()
        factor = self.num_workers // self.mesh.shape[mesh_lib.WORKER_AXIS]
        carries = [self.strategy.init_carry(
            members[k], self.tx,
            device=mesh_lib.worker_device(self.mesh, k, factor))
            for k in substrate.local_workers(self.mesh, self.num_workers)]
        center = mesh_lib.put_replicated(members[0], self.mesh)
        return center, carries

    def _finalize(self, center: dict, carries: list):
        local = [{n: x.detach() for n, x in c.params.items()}
                 for c in carries]
        if not self.mesh.spans_processes:
            return local
        # every process returns all K members, gathered
        return [{n: _tensor(x).to(self.mesh.home) for n, x in m.items()}
                for m in self._all_trees(local)]

    def _model_params(self) -> dict:
        return self.params[0]


class PjitTrainer(Trainer):
    """Sync data-parallel (x tensor-parallel) trainer: the JAX package's
    GSPMD trainer (BASELINE config 5, "pjit-sharded data-parallel").

    The global batch is split over the ``workers`` mesh axis and the
    parameters optionally over ``model`` by partition rules
    (:mod:`~distkeras_tpu_torch.parallel.tensor`: flax-path rules mapped
    onto the port's layout, shards at rest, the optimizer state per
    shard, parameters gathered for the step, the loss taken over the
    global batch as GSPMD takes it, its gradient split back into the
    shards). No parameter server: every step is one synchronous update.

    Placement: ``mesh=`` as given; else ``make_mesh(num_workers,
    model_parallelism)`` over every visible card (this process's in a
    group; raising without a card), or,
    with ``device=``, over that device repeated ``num_workers x
    model_parallelism`` times (``device="cpu"`` runs on the host; over
    several processes that count is split among them: a row lies inside
    a process, or spans processes when each holds fewer devices than
    ``model_parallelism``). In one process ``data_layout="host_sharded"``
    is the replicated case; over several each process holds its worker
    positions' rows of every global batch (a row that spans processes:
    the same rows on each of them).
    Checkpoints (``checkpoint_dir=``) hold whole tensors (parameters and
    optimizer state) and re-shard on restore, onto any model-axis size.

    Dropout: one stream a step on the GSPMD path, one stream a (step,
    worker) under ``bucket_bytes`` (each worker's slice a step of its own)
    (:func:`~distkeras_tpu_torch.parallel.tensor.build_pjit_epoch_fn`).
    """

    def __init__(self, model, loss="categorical_crossentropy",
                 worker_optimizer="sgd", learning_rate: float = 0.01,
                 metrics=("accuracy",), features_col="features",
                 label_col="label", batch_size: int = 32, num_epoch: int = 1,
                 num_workers: Optional[int] = None,
                 model_parallelism: int = 1, partition_rules=None,
                 mesh=None, seed: int = 0, loss_weights=None,
                 checkpoint_dir: Optional[str] = None,
                 staging_steps: Optional[int] = None,
                 data_layout: str = "replicated",
                 telemetry_path: Optional[str] = None,
                 accum_steps: int = 1,
                 precision: Optional[str] = None,
                 bucket_bytes: Optional[int] = None,
                 device=None):
        super().__init__(model, loss, worker_optimizer, learning_rate,
                         metrics, features_col, label_col, batch_size,
                         num_epoch, seed, loss_weights=loss_weights,
                         checkpoint_dir=checkpoint_dir,
                         telemetry_path=telemetry_path,
                         precision=precision, device=device)
        if mesh is None:
            devices = None
            if device is not None:
                need = (1 if num_workers is None else int(num_workers)) \
                    * int(model_parallelism)
                # this process's part of the mesh (make_mesh lays every
                # process's devices end to end)
                count = distributed.process_count()
                devices = [resolve_device(device)] * max(1, -(-need // count))
            mesh = mesh_lib.make_mesh(num_workers,
                                      model_parallelism=model_parallelism,
                                      devices=devices)
        for row in mesh.grid:  # a card the host lacks raises here
            for d in row:
                resolve_device(d)
        self.mesh = mesh
        self.num_workers = self.mesh.shape[mesh_lib.WORKER_AXIS]
        self.partition_rules = partition_rules
        # None: whole epoch resident; int: O(staging_steps) chunks
        # prefetched on a thread
        self.staging_steps = staging_steps
        if data_layout not in ("replicated", "host_sharded"):
            raise ValueError(
                f"data_layout must be 'replicated' or 'host_sharded', "
                f"got {data_layout!r}")
        self.data_layout = data_layout
        if self.batch_size % self.num_workers != 0:
            raise ValueError(
                f"batch_size {self.batch_size} must be divisible by "
                f"num_workers {self.num_workers} (the batch is the GLOBAL "
                f"batch, sharded over the workers axis)")
        # each microbatch must still shard evenly over the workers axis,
        # so the PER-WORKER batch is what accum_steps has to divide
        self.accum_steps = int(accum_steps)
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if (self.batch_size // self.num_workers) % self.accum_steps != 0:
            raise ValueError(
                f"accum_steps={self.accum_steps} must divide the per-device "
                f"batch {self.batch_size // self.num_workers} "
                f"(global batch_size {self.batch_size} / num_workers "
                f"{self.num_workers}) so each microbatch shards evenly over "
                f"the workers axis")
        if bucket_bytes is not None:
            bucket_bytes = int(bucket_bytes)
            if bucket_bytes <= 0:
                raise ValueError(
                    f"bucket_bytes must be positive, got {bucket_bytes}")
            if self.mesh.shape.get(mesh_lib.MODEL_AXIS, 1) > 1:
                raise ValueError(
                    f"bucket_bytes={bucket_bytes} (explicit bucketed grad "
                    f"all-reduce) requires a pure data-parallel mesh, but "
                    f"model_parallelism="
                    f"{self.mesh.shape[mesh_lib.MODEL_AXIS]} shards params "
                    f"over the model axis — GSPMD's implicit model-parallel "
                    f"collectives do not compose with explicit shard_map "
                    f"psums")
        self.bucket_bytes = bucket_bytes
        #: the train state on the mesh after ``train()`` (shards and the
        #: optimizer over them)
        self.state = None

    def train(self, dataset: Dataset, shuffle: bool = False,
              resume: bool = False):
        from distkeras_tpu_torch.parallel import tensor

        self._reject_global_shards(dataset, "PjitTrainer")
        self._start()
        multi = self.mesh.spans_processes
        positions = mesh_lib.local_worker_positions(self.mesh)
        per_worker = self.batch_size // self.num_workers
        # this process's rows of each global batch (all of them in one
        # process): host_sharded data holds them only; replicated data is
        # the full batch, cut to them after staging
        cut = None
        if self.data_layout == "host_sharded":
            local_batch = per_worker * len(positions)
        else:
            local_batch = self.batch_size
            if multi:
                cut = (positions[0] * per_worker,
                       (positions[-1] + 1) * per_worker)
        max_steps = None
        if multi and self.data_layout == "host_sharded":
            # the common step count, agreed by every process (a one-sided
            # raise would leave the peers blocked in the step's folds)
            counts = distributed.process_allgather(
                np.int64(len(dataset) // local_batch)).ravel()
            max_steps = int(counts.min())
            if max_steps == 0:
                short = np.flatnonzero(counts == 0).tolist()
                raise ValueError(
                    f"Process(es) {short} cannot form one local batch "
                    f"(per-process step counts {counts.tolist()}; this "
                    f"host is process {distributed.process_index()} with "
                    f"{len(dataset)} rows, local batch {local_batch})")
        else:
            self._check_trainable(dataset, local_batch)
        if self.staging_steps is None:
            self._warn_if_large_resident(dataset, "staging_steps")
        # the one module skeleton every worker's gathered tensors run
        # through
        self.model.to(self.mesh.home)
        if getattr(self, "_pjit_fns", None) is None:
            with span("trainer.compile"):
                self._pjit_fns = tensor.build_pjit_epoch_fn(
                    self.model, self.loss, self.tx, self.mesh, self.metrics,
                    self.partition_rules, dropout_seed=self.seed,
                    accum_steps=self.accum_steps, precision=self.precision,
                    bucket_bytes=self.bucket_bytes)
        epoch_fn, place_state, place_data = self._pjit_fns
        with span("trainer.init"):
            state = place_state(_params_of(self.model))
        ckpt = self._checkpointer()
        snap, start_epoch = self._maybe_resume(ckpt, resume)
        step_offset = 0
        if snap is not None:
            tensor.load_params(state, snap["state"]["params"])
            tensor.load_optimizer_state_tree(state,
                                             snap["state"].get("opt", {}))
            state.step = int(np.asarray(snap["state"]["step"]))
            step_offset = int(np.asarray(snap["counters"]).ravel()[0])
        self.state = state
        self.history = []
        staged = None  # shuffle=False + whole-epoch staging: place once
        for epoch in range(start_epoch, self.num_epoch):
            with span("trainer.stage"):
                chunks, staged = self._epoch_chunk_stream(
                    staged,
                    lambda: ((place_data(data if cut is None else {
                        k: v[:, cut[0]:cut[1]] for k, v in data.items()}),
                        steps)
                        for data, steps in tensor.stage_step_chunks(
                            dataset.shuffle(self.seed + epoch)
                            if shuffle else dataset,
                            self.features_col, self.label_col,
                            local_batch, chunk_steps=self.staging_steps,
                            max_steps=max_steps)),
                    resident=not shuffle and self.staging_steps is None)
            with span("trainer.epoch"):
                pending = []
                for data, steps in chunks:
                    state, ms = epoch_fn(state, data, step_offset)
                    step_offset += steps
                    pending.append((ms, steps))
                for ms, steps in pending:
                    host = {k: v.cpu().numpy() for k, v in ms.items()}
                    self.history.extend(
                        {k: float(v[i]) for k, v in host.items()}
                        for i in range(steps))
            if ckpt is not None:
                # whole tensors, gathered on every process (a row over
                # processes holds its shards on their owners): process 0
                # writes, and none goes on before the step is on disk
                tree = {"state": {"params": state.gathered("cpu"),
                                  "opt": tensor.optimizer_state_tree(state),
                                  "step": np.asarray(state.step, np.int64)},
                        "counters": np.array([step_offset], np.int64)}
                if distributed.process_index() == 0:
                    ckpt.save(epoch, tree)
                del tree
                distributed.barrier()
        with span("trainer.finalize"):
            self.params = state.gathered(self.mesh.home)
            _load(self.model, self.params)
        self._stop(self.mesh.home)
        return self.params


class SingleTrainer(Trainer):
    """One replica, plain minibatch SGD (the reference's SingleTrainer),
    through ``engine.make_epoch_fn``. ``staging_steps=None`` stages the
    whole epoch on the device once and reuses it every epoch; an int
    bounds device data memory to O(staging_steps) chunks prefetched on a
    thread."""

    def __init__(self, *args, staging_steps: Optional[int] = None,
                 accum_steps: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.staging_steps = staging_steps
        self.accum_steps = int(accum_steps)
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if self.batch_size % self.accum_steps != 0:
            raise ValueError(
                f"accum_steps={self.accum_steps} must divide "
                f"batch_size={self.batch_size}: each step is a scan over "
                f"accum_steps equal microbatches")
        self._device = resolve_device(self.device)

    def train(self, dataset: Dataset, shuffle: bool = False,
              resume: bool = False):
        from distkeras_tpu_torch.parallel import substrate

        self._reject_global_shards(dataset, "SingleTrainer")
        self._start()
        if shuffle:
            dataset = dataset.shuffle(self.seed)
        self._check_trainable(dataset, self.batch_size)
        if self.staging_steps is None:
            self._warn_if_large_resident(dataset, "staging_steps")
        with span("trainer.init"):
            state = engine.create_train_state(self.model, self.tx,
                                              device=self._device)
        ckpt = self._checkpointer()
        snap, start_epoch = self._maybe_resume(ckpt, resume)
        if snap is not None:
            state = _load_train_state(state, snap)
        if getattr(self, "_epoch_fn", None) is None:
            with span("trainer.compile"):
                self._epoch_fn = engine.make_epoch_fn(
                    self.model, self.loss, self.tx, metrics=self.metrics,
                    dropout_seed=self.seed, accum_steps=self.accum_steps,
                    precision=self.precision)
        epoch_fn = self._epoch_fn
        staged = None
        device_history = []  # device tensors; read once at the end
        for epoch in range(start_epoch, self.num_epoch):
            with span("trainer.stage"):
                # one shard at window 1 on a one-device mesh: each chunk
                # is (steps, 1, 1, batch, ...), viewed as (steps, batch, ...)
                chunks, staged = self._epoch_chunk_stream(
                    staged,
                    lambda: (data for data, _ in
                             substrate.stage_epoch_chunks(
                                 [dataset], self.features_col,
                                 self.label_col, self.batch_size, 1,
                                 mesh_lib.Mesh([self._device]),
                                 chunk_rounds=self.staging_steps)),
                    resident=self.staging_steps is None)
            with span("trainer.epoch"):
                for data in chunks:
                    data.wait()
                    state, ms = epoch_fn(state, {
                        key: cols[0][:, 0, 0] for key, cols in data.items()})
                    device_history.append(ms)
            if ckpt is not None:
                ckpt.save(epoch, _train_state_tree(state))
        with span("trainer.finalize"):
            self.history = []
            for ms in device_history:
                host = {k: v.cpu().numpy() for k, v in ms.items()}
                steps = len(next(iter(host.values())))
                self.history.extend({k: float(v[i]) for k, v in host.items()}
                                    for i in range(steps))
            self.params = {n: p.clone() for n, p in
                           _params_of(state.model).items()}
        self._stop(self._device)
        return self.params
