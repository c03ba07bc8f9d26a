"""Host-driven true async: wall-clock asynchrony against a live center
(port of ``distkeras_tpu/parallel/host_async.py``).

The substrate (:mod:`~distkeras_tpu_torch.parallel.substrate`) emulates
asynchrony deterministically: a fixed rotation of commit positions. This
module is the other half of the reference's story: like dist-keras's
socket parameter server, workers here run CONCURRENTLY (host threads
standing in for Spark executors), each looping pull -> local window ->
commit against a parameter server whose center moves between any two of
a worker's steps. Staleness is real thread scheduling.

Worker ``k`` runs on ``devices[k % D]`` (default ``[cuda:0]``): its
carry, its staged batches and its copy of the module live there; it
pulls the center, runs its window of local steps, and commits back to
the center's device (the first device). Where the port differs from the
JAX package, by design:

- a window is ``window`` eager local steps, not one jitted scan, and
  each worker gets its OWN module instance (``copy.deepcopy`` of the
  model, built once a worker): the strategies' grads run the module
  through ``torch.func.functional_call``, which swaps its parameters in
  place for the call, so two threads sharing one module would read each
  other's weights. The copy costs one set of parameters a worker;
- every thread queues on the device's default stream, the one queue the
  JAX package's threads share: a fold enqueued by one thread is ordered
  before a pull read by another, and a staged batch's non-blocking copy
  (pinned memory) before the window that reads it;
- a window's metrics come to the host in one copy (the window's one
  synchronization); the dropout stream of step ``i`` of a window is a
  ``torch.Generator`` seeded from ``(seed, fold_key, i)``, not threefry.

A worker's rounds come staged (:func:`stage_worker_shards`, a list a
worker and epoch) or lease-driven (:func:`stream_worker_rounds`, a
zero-argument callable against a
:class:`~distkeras_tpu_torch.data.service.DataCoordinator`); the worker
loop cannot tell them apart. :func:`run_cross_process` runs the
workers of several processes (a ``torch.distributed`` group) against
one live center that process 0 owns.
"""

from __future__ import annotations

import contextlib
import copy
import queue as queue_lib
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch import comms, engine, observability, telemetry
from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.data.prefetch import prefetch
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.health import recorder as flight_recorder
from distkeras_tpu_torch.health.heartbeat import (HeartbeatPublisher,
                                                  StragglerDetector)
from distkeras_tpu_torch.parallel.remote_ps import PSUnavailable
from distkeras_tpu_torch.parallel.strategies import Strategy
from distkeras_tpu_torch.parameter_servers import (
    DeltaParameterServer,
    DynSGDParameterServer,
    ParameterServer,
)
from distkeras_tpu_torch.utils import fault, rng
from distkeras_tpu_torch.utils.transfer import to_device, to_host
from distkeras_tpu_torch.utils.trees import tree_add


@contextlib.contextmanager
def _window_trace(enabled: bool, wid: int, fold: int):
    """Root one trace per worker window: the trace.window span parents
    the pull/compute/commit spans below it, and the commit's traceparent
    rides the wire so transport retries and shard folds chain under the
    same trace_id."""
    if not enabled or telemetry.get_registry() is None:
        yield None
        return
    ctx = telemetry.TraceContext.new_root(worker=str(wid), window=str(fold))
    with telemetry.use_trace(ctx):
        with telemetry.span("trace.window", worker=wid) as child:
            yield child


def server_for(strategy: Strategy, params) -> ParameterServer:
    """The reference's trainer -> server pairing."""
    if strategy.name == "dynsgd":
        return DynSGDParameterServer(params)
    return DeltaParameterServer(params)


class CadenceTrigger:
    """Checkpoint cadence on a globally counted clock.

    ``clock_at_fold`` counts commits from every worker, but a worker
    observes it only at its own commits, so ``(clock + 1) % folds == 0``
    would fire only about 1/P of the time with P committers. Firing on a
    crossing instead (the observed clock entered a later ``folds``-sized
    bucket than the last trigger) keeps about one snapshot per ``folds``
    commits for any observation stride. Thread-safe: concurrent workers
    observing the same crossing fire once."""

    def __init__(self, folds: int, start_clock: int = 0):
        if folds < 1:
            raise ValueError(f"checkpoint_folds must be >= 1, got {folds}")
        self.folds = int(folds)
        # commits [0, start_clock) predate this run (resume): their
        # intervals must not retrigger
        self._bucket = int(start_clock) // self.folds
        self._lock = threading.Lock()

    def crossed(self, clock_at_fold: int) -> bool:
        bucket = (int(clock_at_fold) + 1) // self.folds
        if bucket <= self._bucket:  # unlocked fast path: no crossing
            return False
        with self._lock:
            if bucket <= self._bucket:
                return False  # a sibling claimed this crossing first
            self._bucket = bucket
            return True


def make_window_fn(model, loss, tx, strategy: Strategy, window: int,
                   metric_names: Sequence[str], seed: int,
                   accum_steps: int = 1, precision: Optional[str] = None):
    """One worker's round: ``window`` local steps and the commit.

    ``window_fn(carry, center, batches, fold_key) -> (carry, commit,
    metrics)``: ``batches`` leaves are ``[window, batch, ...]`` tensors on
    the carry's device, ``center`` a name -> tensor dict there; the carry
    is updated in place and returned, ``commit`` is a new dict and
    ``metrics`` maps ``loss`` and each metric name to a ``[window]``
    float32 tensor on the device (nothing is read to the host). The
    steps run through ``model`` (functionally, over the carry's
    tensors): a thread of its own needs a module of its own.

    ``accum_steps > 1`` microbatches each local step; a window is still
    ``window`` optimizer steps and one commit. ``precision`` threads a
    policy's static loss scale into the grad function, as in the JAX
    package."""
    accum_steps = int(accum_steps)
    metric_names = tuple(metric_names)
    if accum_steps > 1:
        grad_fn = engine.make_accum_grad_fn(model, loss, accum_steps,
                                            metric_names,
                                            precision=precision,
                                            functional=True)
    else:
        grad_fn = engine.make_grad_fn(model, loss, precision=precision,
                                      functional=True)

    def window_fn(carry, center, batches, fold_key):
        carry = strategy.round_start(carry, center)
        device = next(iter(carry.params.values())).device
        rows = {"loss": []}
        rows.update({name: [] for name in metric_names})
        for i in range(window):
            batch = {key: value[i] for key, value in batches.items()}
            gen = rng.generator(rng.fold_in(seed, int(fold_key), i), device)
            carry, out = strategy.local_step(grad_fn, carry, batch, gen)
            rows["loss"].append(out["loss"])
            for name in metric_names:
                if accum_steps > 1:
                    rows[name].append(
                        engine.finalize_metric(out["logits"][name]))
                else:
                    rows[name].append(engine.compute_metric(
                        name, out["logits"], batch["labels"]))
        commit = strategy.commit(carry, center, window)
        if not strategy.resets_to_center:
            # local side of the elastic update (EASGD family); the
            # DOWNPOUR family re-pulls the live center at its next
            # round_start instead
            carry = strategy.post_commit(carry, commit, None)
        return carry, commit, {n: torch.stack(v).float()
                               for n, v in rows.items()}

    window_fn.grad_fn = grad_fn
    return window_fn


def _host_metrics(ms: dict) -> dict:
    """A window's metrics on the host in one copy (one synchronization)."""
    names = list(ms)
    host = torch.stack([ms[n] for n in names]).cpu().numpy()
    return {n: host[i] for i, n in enumerate(names)}


class HostAsyncRunner:
    """Run N concurrent workers against a live parameter server.

    ``epoch_shards[epoch][worker]`` lists a worker's staged rounds: batch
    dicts of numpy (or tensor) leaves ``[window, batch, ...]``
    (:func:`stage_worker_shards`). Each window's metrics are tagged with
    the server clock at its commit; the returned history and staleness
    are the windows sorted by that clock (true commit order).

    ``devices`` (worker ``k`` on ``devices[k % D]``) defaults to
    ``[resolve_device(device)]``: ``cuda:0``, raising without a card,
    unless ``device="cpu"`` is asked for."""

    def __init__(self, model, loss, tx, strategy: Strategy, window: int,
                 metrics: Sequence[str] = (), seed: int = 0,
                 devices: Optional[Sequence] = None,
                 codec: Optional[str] = None, overlap: bool = False,
                 accum_steps: int = 1, precision: Optional[str] = None,
                 max_degraded_windows: int = 16, trace: bool = True,
                 device=None):
        self.strategy = strategy
        self.window = int(window)
        # distributed tracing: each worker window becomes one trace whose
        # spans follow the commit through the transport and shard folds;
        # trace=False keeps the plain span events
        self.trace = bool(trace)
        # degradation ladder budget: consecutive compute-only windows a
        # worker rides out against an unreachable fleet before the outage
        # surfaces as the underlying PSUnavailable
        self.max_degraded_windows = int(max_degraded_windows)
        self.accum_steps = int(accum_steps)
        self.model, self.loss, self.tx = model, loss, tx
        self.metrics = tuple(metrics)
        self.seed = int(seed)
        self.precision = precision
        self.devices = [resolve_device(d) for d in devices] if devices \
            else [resolve_device(device)]
        # the window function over the caller's module: worker 0's; the
        # others get a module copy each (see _window_fn_for)
        self.window_fn = make_window_fn(model, loss, tx, strategy, window,
                                        self.metrics, self.seed,
                                        accum_steps=self.accum_steps,
                                        precision=precision)
        self._window_fns = {}
        # wire codec of the exchange: with a runner-created (local) PS a
        # non-raw codec wraps it in EncodedParameterServer so commits and
        # pulls see exactly the wire numerics; with an injected ps= the
        # caller owns the codec
        self.codec = None if codec is None else comms.get_codec(codec)
        # overlap=True double-buffers each worker: the previous window's
        # commit and the next window's pull run on a per-worker comms
        # thread while the current window computes
        self.overlap = bool(overlap)
        # health plane: every worker window publishes a heartbeat and
        # feeds the straggler detector; the watchdog is opt-in
        self.heartbeat = HeartbeatPublisher()
        self.straggler = StragglerDetector()
        # live per-window MFU series: one local step's FLOPs counted once
        # (on the first round a worker trains) and only when a peak is
        # known; on the CPU device_peak_flops is None and the path stays
        # cold
        policy = precision_lib.get_policy(precision)
        self.mfu_dtype = policy.mfu_dtype if policy is not None else "bf16"
        self.mfu_peak_flops: Optional[float] = None  # bench/test override
        self._mfu_peak: Optional[float] = None
        self._mfu_peak_resolved = False
        self._window_flops: Optional[float] = None
        self._flops_lock = threading.Lock()
        self.worker_devices: list = []  # actual placement, for tests/logs
        self.window_clocks: list = []   # merged commit clocks, last run
        self.merged_windows: list = []  # (clock, staleness, steps) tuples
        # merged fleet telemetry rows of the last run_cross_process (set
        # on process 0)
        self.fleet_telemetry: list = []

    def _window_fn_for(self, k: int, device: torch.device):
        """Worker ``k``'s window function over its own module on
        ``device`` (built once; worker 0 keeps the caller's module)."""
        if k == 0 and next(self.model.parameters()).device == device:
            return self.window_fn
        fn = self._window_fns.get(k)
        if fn is None or fn.device != device:
            module = copy.deepcopy(self.model).to(device)
            fn = make_window_fn(module, self.loss, self.tx, self.strategy,
                                self.window, self.metrics, self.seed,
                                accum_steps=self.accum_steps,
                                precision=self.precision)
            fn.device = device
            self._window_fns[k] = fn
        return fn

    def run(self, init_params, epoch_shards: Sequence[Sequence[Sequence[dict]]],
            checkpointer=None, checkpoint_folds: int = 0,
            start_clock: int = 0, ps=None, worker_offset: int = 0,
            fetch_final: bool = True, watchdog=None,
            snapshot_extra=None) -> tuple:
        """Train; returns ``(center, history, staleness, num_updates)``
        with ``center`` a name -> tensor dict on the center's device.

        ``epoch_shards[epoch][worker]`` is that worker's list of staged
        rounds for that epoch; workers cross epoch boundaries without
        barriers. ``checkpointer``/``checkpoint_folds``: snapshot
        ``{"center", "clock"}`` every ``checkpoint_folds`` commits from a
        dedicated saver thread (committing workers only set an event).
        ``start_clock`` seeds the server clock when resuming. ``ps``:
        inject a live parameter server (a
        :class:`~distkeras_tpu_torch.parallel.remote_ps.
        RemoteParameterServer`, a shard fleet's client) instead of
        creating one; ``worker_offset`` is this runner's first global
        worker id. ``watchdog``: an optional
        :class:`~distkeras_tpu_torch.health.watchdog.TrainingWatchdog`
        fed every window's loss; the runner binds its crash-time
        ``checkpoint_fn`` and its ``on_trip`` abort when unset.
        ``snapshot_extra``: a zero-arg callable of extra leaves for every
        snapshot."""
        num_workers = len(epoch_shards[0])
        home = self.devices[0]
        if ps is None:
            # the center (and its folds) live on the first device
            ps = server_for(self.strategy, {
                n: torch.as_tensor(x).detach().to(home, copy=True)
                for n, x in init_params.items()})
            ps.num_updates = int(start_clock)
            if self.codec is not None and self.codec.name != "raw":
                # single-process codec run: every pull/commit crosses the
                # codec exactly as it would on the wire
                ps = comms.EncodedParameterServer(ps, self.codec)
        # snapshots and the final fetch read the center EXACTLY: a lossy
        # codec rounds only the worker exchange
        base_ps = ps.ps if isinstance(ps, comms.EncodedParameterServer) \
            else ps
        # per-window records: (commit_clock, staleness, [per-step metrics])
        windows: list = [[] for _ in range(num_workers)]
        errors: list = []
        self.worker_devices = [self.devices[k % len(self.devices)]
                               for k in range(num_workers)]
        fns = [self._window_fn_for(k, self.worker_devices[k])
               for k in range(num_workers)]
        save_trigger = threading.Event()
        stop_saving = threading.Event()

        def snapshot():
            center, clock = base_ps.pull()
            snap = {"center": to_host(center),
                    "clock": np.array([clock], np.int64)}
            if snapshot_extra is not None:
                snap.update(snapshot_extra())
            return snap, clock

        def saver():
            """Best-effort periodic snapshots in one thread; crossings
            that arrive while a save runs coalesce into the next."""
            last_saved = int(start_clock)
            try:
                while True:
                    fired = save_trigger.wait(timeout=0.05)
                    if fired:
                        save_trigger.clear()
                    elif stop_saving.is_set():
                        return
                    else:
                        continue
                    t0 = time.perf_counter()
                    snap, clock = snapshot()  # consistent under the PS lock
                    if clock > last_saved:
                        checkpointer.save(clock, snap)
                        # the stall an in-commit-path save would have cost
                        telemetry.histogram("host_async.save_s").record(
                            time.perf_counter() - t0)
                        telemetry.counter("host_async.save.count").inc()
                        last_saved = clock
            except Exception as e:  # surface save failures to the caller
                errors.append(e)

        abort = threading.Event()
        checkpointing = checkpointer is not None and checkpoint_folds > 0
        cadence = (CadenceTrigger(checkpoint_folds, start_clock)
                   if checkpointing else None)

        def worker(k: int):
            try:
                dev = self.worker_devices[k]
                wid = worker_offset + k  # global worker id (telemetry label)
                pull_h = telemetry.histogram("host_async.pull_s", worker=wid)
                win_h = telemetry.histogram("host_async.window_s", worker=wid)
                commit_h = telemetry.histogram("host_async.commit_s",
                                               worker=wid)
                lag_h = telemetry.histogram("host_async.commit_clock_lag",
                                            worker=wid)
                carry = self.strategy.init_carry(init_params, self.tx,
                                                 device=dev)

                def staged_rounds():
                    # the copy to the device runs on the prefetch thread
                    # one round ahead (pinned memory, non-blocking)
                    for shards in epoch_shards:
                        rounds = shards[k]
                        if callable(rounds):  # a lazily made round source
                            rounds = rounds()
                        for batches in rounds:
                            yield to_device(batches, dev)

                def bookkeep(clock_at_fold: int, pull_clock: int, ms: dict,
                             win_s: float):
                    # commits the center absorbed between this worker's
                    # pull and its own fold: real scheduling staleness
                    staleness = clock_at_fold - pull_clock
                    lag_h.record(staleness)
                    n = len(ms["loss"])
                    windows[k].append((
                        clock_at_fold, staleness,
                        [{key: float(v[i]) for key, v in ms.items()}
                         for i in range(n)]))
                    # heartbeat and straggler verdict before the watchdog
                    # may raise, so introspection sees the tripping window
                    self.heartbeat.publish(wid, clock_at_fold, staleness,
                                           win_s)
                    self.straggler.observe(wid, win_s)
                    self._publish_window_mfu(win_s)
                    if checkpointing and cadence.crossed(clock_at_fold):
                        save_trigger.set()  # non-blocking hand-off
                    if watchdog is not None:
                        watchdog.observe_loss(fault.apply(
                            "host_async.window_loss",
                            float(np.mean(ms["loss"]))))
                        watchdog.notify_progress()

                elastic = getattr(ps, "elastic", False)
                if elastic:
                    try:
                        # join the fleet (a lease on the coordinator);
                        # best-effort: a commit is also an implicit join
                        ps.register(wid)
                    except Exception:
                        pass
                if self.overlap:
                    self._overlapped_rounds(
                        wid, dev, fns[k], carry, ps, staged_rounds(), abort,
                        bookkeep, pull_h, win_h, commit_h)
                else:
                    self._serial_rounds(
                        wid, dev, fns[k], carry, ps, elastic,
                        staged_rounds(), abort, bookkeep, pull_h, win_h,
                        commit_h)
                if elastic:
                    try:
                        # clean leave; a crashed worker never gets here and
                        # the lease sweep evicts it instead
                        ps.deregister(wid)
                    except Exception:
                        pass
            except Exception as e:  # surface thread failures to the caller
                if e not in errors:  # a watchdog on_trip may have filed it
                    errors.append(e)
                telemetry.record_event(
                    "worker_error", worker=worker_offset + k,
                    error=type(e).__name__, message=str(e)[:200])
                flight_recorder.auto_dump(
                    "ps_unavailable" if isinstance(e, PSUnavailable)
                    else "worker_exception")
                abort.set()  # fail fast: siblings stop at their next round

        if watchdog is not None:
            if watchdog.checkpoint_fn is None and checkpointer is not None:
                def crash_checkpoint():
                    snap, clock = snapshot()
                    checkpointer.save(clock, snap)
                    checkpointer.wait()
                watchdog.checkpoint_fn = crash_checkpoint
            if watchdog.on_trip is None:
                def on_trip(err):
                    if err not in errors:
                        errors.append(err)
                    abort.set()
                watchdog.on_trip = on_trip
            watchdog.start_stall_monitor()
        saver_thread = None
        if checkpointing:
            saver_thread = threading.Thread(target=saver, daemon=True)
            saver_thread.start()
        threads = [threading.Thread(target=worker, args=(k,), daemon=True,
                                    name=f"host-async-worker-{k}")
                   for k in range(num_workers)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            if watchdog is not None:
                watchdog.stop_stall_monitor()
            if saver_thread is not None:
                stop_saving.set()
                saver_thread.join()
        if errors:
            raise errors[0]
        # merge worker windows by the server clock at their commit: the
        # order the center actually absorbed them in
        merged = sorted((w for ws in windows for w in ws), key=lambda w: w[0])
        self.window_clocks = [w[0] for w in merged]
        self.merged_windows = merged
        history = [step for _, _, steps in merged for step in steps]
        stal = [float(s) for _, s, _ in merged]
        if not fetch_final:
            return None, history, stal, -1
        center, _ = base_ps.pull()
        if not isinstance(next(iter(center.values())), torch.Tensor):
            center = to_device(center, home)
        return dict(center), history, stal, ps.num_updates

    # -- per-window MFU ---------------------------------------------------
    def _mfu_ceiling(self) -> Optional[float]:
        """Peak FLOP/s the per-window MFU series measures against: the
        ``mfu_peak_flops`` override or the device's table entry; None
        (the CPU) disables the series."""
        if self.mfu_peak_flops is not None:
            return self.mfu_peak_flops
        if not self._mfu_peak_resolved:
            self._mfu_peak_resolved = True
            try:
                self._mfu_peak = observability.device_peak_flops(
                    self.devices[0], dtype=self.mfu_dtype)
            except Exception:
                self._mfu_peak = None
        return self._mfu_peak

    def _note_window_flops(self, window_fn, params: dict,
                           batches: dict) -> None:
        """Count one window's model FLOPs once, on the first round a
        worker is about to train (``batches``, on the device of the
        worker's ``params``), as the JAX package counts on the first
        batches a worker trains: a round taken from the source for the
        count alone would, from a lease-driven source, lease ranges and
        ack them untrained. One local step's gradient on
        ``accum_steps`` rows (the fewest the step takes), scaled to the
        batch (matmul and convolution FLOPs are linear in the rows) and
        by ``window`` (the optimizer update is elementwise, which MFU
        does not count). The JAX package counts a trace instead; torch
        has none without running, so this runs a forward and backward of
        a few rows in the calling worker's thread. The first worker to
        get here counts while its siblings wait at the lock before their
        first window: the kernels' reports reach every listener of the
        process (a backward's launches on a card come from autograd's
        device thread), so no sibling may launch during the count.
        Skipped while no peak is known, so the CPU path never pays it."""
        if self._window_flops is not None or self._mfu_ceiling() is None:
            return
        with self._flops_lock:
            if self._window_flops is not None:
                return  # a sibling counted while this worker waited
            try:
                rows = self.accum_steps
                batch = {key: value[0][:rows]
                         for key, value in batches.items()}
                per_row = next(iter(batches.values()))[0].shape[0] / rows
                leaves = {n: x.detach().clone().requires_grad_(True)
                          for n, x in params.items()}
                step = observability.count_flops(window_fn.grad_fn, leaves,
                                                 batch, None)
                self._window_flops = step * per_row * self.window
            except Exception:
                self._window_flops = 0.0  # cannot count: stay silent

    def _publish_window_mfu(self, win_s: float) -> None:
        if not self._window_flops or win_s <= 0:
            return
        peak = self._mfu_ceiling()
        if peak is None:
            return
        value = observability.mfu(self._window_flops, win_s,
                                  peak_per_chip=peak, dtype=self.mfu_dtype)
        if value is not None:
            telemetry.histogram("observability.mfu_window",
                                dtype=self.mfu_dtype).record(value)

    # -- the worker loops -------------------------------------------------
    def _serial_rounds(self, wid, dev, window_fn, carry, ps, elastic,
                       rounds, abort, bookkeep, pull_h, win_h, commit_h):
        """The serialized pull -> window -> commit loop, with the elastic
        degradation ladder: when the fleet is unreachable (a typed
        PSUnavailable after the transport's own retries) the worker
        keeps training against its last good center and accumulates the
        unfolded commits, then folds the backlog in one commit when the
        fleet returns. ``last_update`` of that fold is the OLDEST backlog
        window's pull clock, so the server charges the honest staleness.
        Bounded by ``max_degraded_windows``; a run that ends degraded
        gets one last flush attempt before the error surfaces."""
        fold = 0
        degraded = 0        # consecutive windows without a landed commit
        backlog = None      # accumulated unfolded commit deltas
        backlog_clock = 0   # pull clock of the OLDEST unfolded window
        deferred: list = []  # (pull_clock, ms, win_s) awaiting a fold clock
        last_center = None  # last successfully pulled (center, clock)
        # step-time decomposition: data_wait/pull/h2d/compute/commit/
        # bookkeep partition each window; encode/decode/fold land nested
        prof = {name: telemetry.histogram(f"profile.phase.{name}_s",
                                          worker=wid)
                for name in ("data_wait", "pull", "h2d", "compute",
                             "commit", "bookkeep", "window")}
        it = iter(prefetch(rounds, depth=1))
        while True:
            t_start = time.perf_counter()
            try:
                batches = next(it)
            except StopIteration:
                break
            if abort.is_set():
                return  # a sibling died: stop wasting windows
            phases = {"data_wait": time.perf_counter() - t_start}
            prof["data_wait"].record(phases["data_wait"])
            self._note_window_flops(window_fn, carry.params, batches)
            with _window_trace(self.trace, wid, fold):
                t0 = time.perf_counter()
                try:
                    with telemetry.span("trace.pull", worker=wid):
                        center, clock = ps.pull()
                    last_center = (center, clock)
                except PSUnavailable:
                    if last_center is None:
                        raise  # never reached the fleet at all
                    center, clock = last_center  # compute-only: stale
                t1 = time.perf_counter()
                pull_h.record(t1 - t0)
                prof["pull"].record(t1 - t0)
                phases["pull"] = t1 - t0
                center_dev = to_device(center, dev)
                t_h2d = time.perf_counter()
                prof["h2d"].record(t_h2d - t1)
                phases["h2d"] = t_h2d - t1
                with telemetry.span("trace.compute", worker=wid):
                    carry, commit, ms = window_fn(
                        carry, center_dev, batches, wid * 1_000_003 + fold)
                    ms = _host_metrics(ms)  # the window's one sync
                t2 = time.perf_counter()
                win_s = t2 - t1  # h2d + compute
                win_h.record(win_s)
                prof["compute"].record(t2 - t_h2d)
                phases["compute"] = t2 - t_h2d
                to_send, last_up = commit, clock
                if backlog is not None:
                    to_send = tree_add(backlog, commit)
                    last_up = backlog_clock
                landed = True
                try:
                    with telemetry.span("trace.commit", worker=wid):
                        if elastic:
                            clock_at_fold = ps.commit(
                                to_send, last_update=last_up,
                                worker=wid, window_s=win_s)
                        else:
                            clock_at_fold = ps.commit(to_send,
                                                      last_update=last_up)
                except PSUnavailable as e:
                    degraded += 1
                    telemetry.counter("host_async.degraded_windows",
                                      worker=wid).inc()
                    telemetry.record_event("degraded_window", worker=wid,
                                           window=fold, degraded=degraded)
                    if degraded > self.max_degraded_windows:
                        telemetry.record_event(
                            "ps_unavailable", worker=wid,
                            degraded=degraded, message=str(e)[:200])
                        flight_recorder.auto_dump("ps_unavailable")
                        raise
                    backlog, backlog_clock = to_send, last_up
                    deferred.append((clock, ms, win_s))
                    landed = False
                if landed:
                    t3 = time.perf_counter()
                    commit_h.record(t3 - t2)
                    prof["commit"].record(t3 - t2)
                    phases["commit"] = t3 - t2
                    degraded = 0
                    backlog = None
                    for d_clock, d_ms, d_win_s in deferred:
                        bookkeep(clock_at_fold, d_clock, d_ms, d_win_s)
                    deferred.clear()
                    bookkeep(clock_at_fold, clock, ms, win_s)
                    phases["bookkeep"] = time.perf_counter() - t3
                    prof["bookkeep"].record(phases["bookkeep"])
            phases["window"] = time.perf_counter() - t_start
            prof["window"].record(phases["window"])
            telemetry.record_event(
                "window_profile", worker=wid, window=fold,
                degraded=degraded > 0,
                phases={k: round(v, 6) for k, v in phases.items()})
            fold += 1
        if backlog is not None:
            # the run ended degraded: one last flush so the backlogged
            # windows are not silently dropped from the center/history
            clock_at_fold = ps.commit(backlog, last_update=backlog_clock)
            for d_clock, d_ms, d_win_s in deferred:
                bookkeep(clock_at_fold, d_clock, d_ms, d_win_s)

    def _overlapped_rounds(self, wid, dev, window_fn, carry, ps, rounds,
                           abort, bookkeep, pull_h, win_h, commit_h):
        """Double-buffered worker loop: while window n computes, a
        per-worker comms thread commits window n-1 and pulls the center
        for window n+1, hiding commit + pull behind compute.

        The center a window consumes is one window OLDER with respect to
        the worker's own commits than in the serialized loop. Clocks stay
        exact: staleness is measured from the actual pull/commit clock
        pair. This loop gets the transport's reconnect/retry and stamps
        worker identity but not the compute-only degradation ladder: an
        outage longer than the retry budget surfaces as PSUnavailable."""
        elastic = getattr(ps, "elastic", False)
        _STOP = object()
        req: queue_lib.Queue = queue_lib.Queue(maxsize=1)
        resp: queue_lib.Queue = queue_lib.Queue(maxsize=1)

        def comms_loop():
            # one request in flight: commit the finished window (if any),
            # then pull the next center; errors travel back through resp
            try:
                while True:
                    item = req.get()
                    if item is _STOP:
                        return
                    commit, pull_clock = item
                    clock_at_fold = -1
                    if commit is not None:
                        t0 = time.perf_counter()
                        if elastic:
                            clock_at_fold = ps.commit(
                                commit, last_update=pull_clock, worker=wid)
                        else:
                            clock_at_fold = ps.commit(commit,
                                                      last_update=pull_clock)
                        dt = time.perf_counter() - t0
                        commit_h.record(dt)
                        telemetry.histogram("profile.phase.commit_s",
                                            worker=wid).record(dt)
                    t0 = time.perf_counter()
                    center, clock = ps.pull()
                    dt = time.perf_counter() - t0
                    pull_h.record(dt)
                    telemetry.histogram("profile.phase.pull_s",
                                        worker=wid).record(dt)
                    resp.put((center, clock, clock_at_fold))
            except Exception as e:
                resp.put(e)

        ct = threading.Thread(target=comms_loop, daemon=True,
                              name=f"host-async-comms-{wid}")
        ct.start()
        try:
            req.put((None, 0))  # prime: pull window 0's center
            fold = 0
            pending = None  # (pull_clock, ms, win_s) awaiting its fold clock
            for batches in prefetch(rounds, depth=1):
                if abort.is_set():
                    return  # a sibling died: stop wasting windows
                got = resp.get()
                if isinstance(got, Exception):
                    raise got
                center, clock, clock_at_fold = got
                if pending is not None:
                    # the previous window's commit has folded; its clock
                    # arrived with this response
                    bookkeep(clock_at_fold, *pending)
                self._note_window_flops(window_fn, carry.params, batches)
                t1 = time.perf_counter()
                center_dev = to_device(center, dev)
                carry, commit, ms = window_fn(
                    carry, center_dev, batches, wid * 1_000_003 + fold)
                ms = _host_metrics(ms)
                win_s = time.perf_counter() - t1
                win_h.record(win_s)
                pending = (clock, ms, win_s)
                req.put((commit, clock))
                fold += 1
            if pending is not None:
                got = resp.get()  # drain the final window's commit
                if isinstance(got, Exception):
                    raise got
                bookkeep(got[2], *pending)
        finally:
            req.put(_STOP)
            ct.join()


def run_cross_process(runner: HostAsyncRunner, init_params, epoch_shards,
                      *, worker_offset: int, checkpointer=None,
                      checkpoint_folds: int = 0, start_clock: int = 0,
                      service_port: int = 0,
                      history_timeout: float = 600.0,
                      watchdog=None, ps_shards: int = 1,
                      ps_placement: str = "process0",
                      ps_standby: bool = False,
                      snapshot_extra=None) -> tuple:
    """This process's worker threads against ONE live center owned by
    process 0 of the ``torch.distributed`` group (the reference's
    workers-on-separate-machines deployment).

    Process 0 hosts the parameter server behind a
    :class:`~distkeras_tpu_torch.parallel.remote_ps.ParameterServerService`;
    its own workers hit the server directly, every other process's go
    through a :class:`~distkeras_tpu_torch.parallel.remote_ps.RemoteParameterServer`.
    Staleness is real cross-process interleaving on the server clock.

    End of run: every process uploads its clock-tagged windows, and
    ``history_get`` is the completion barrier (it blocks until every
    process uploaded) and returns the clock-merged history and the final
    center, so every process returns IDENTICAL ``(params, history,
    staleness, num_updates)``, ``params`` a name -> numpy dict.
    Checkpoints are taken on process 0 only.

    ``ps_shards > 1`` (or ``ps_standby``) replaces the single service
    with a shard fleet (:mod:`~distkeras_tpu_torch.parallel.elastic`) and
    every process's workers, process 0's too, go through a
    :class:`~distkeras_tpu_torch.parallel.elastic.ShardedRemoteParameterServer`.
    ``ps_placement="spread"`` deals the shard services over processes:
    the token travels first, each process binds its shards, and the
    address map is all-gathered. ``ps_standby=True`` adds a dark standby
    service (on shard 1's process under spread placement).

    Every collective here is symmetric: when process 0 cannot start its
    service it broadcasts the failure sentinel of
    :func:`~distkeras_tpu_torch.parallel.remote_ps.share_service_address`,
    so its peers raise instead of blocking."""
    import secrets

    from distkeras_tpu_torch.health.collector import TelemetryCollector
    from distkeras_tpu_torch.parallel import distributed
    from distkeras_tpu_torch.parallel import elastic as elastic_mod
    from distkeras_tpu_torch.parallel import remote_ps as rps

    ps_shards = int(ps_shards)
    if ps_shards < 1:
        raise ValueError(f"ps_shards must be >= 1, got {ps_shards}")
    nproc = distributed.process_count()
    placement = elastic_mod.shard_placement(ps_shards, nproc, ps_placement)
    spread = any(p != 0 for p in placement)
    pid = distributed.process_index()
    home = runner.devices[0]
    codec_name = "raw" if runner.codec is None else runner.codec.name
    service = client = None
    services: list = []
    init_params = to_host(init_params)

    def _make_ps(part):
        ps = server_for(runner.strategy, to_device(part, home))
        ps.num_updates = int(start_clock)
        return ps

    try:
        if spread:
            if pid == 0:
                _, token = rps.share_service_address(
                    [], token=secrets.token_hex(16))
            else:
                _, token = rps.share_service_address(None)
            # the authoritative start state (restored on process 0 on
            # resume) seeds every hosting process's shards
            init_params = distributed.broadcast_one_to_all(init_params)
            mine = [s for s in range(ps_shards) if placement[s] == pid]
            standby_here = ps_standby and \
                pid == elastic_mod.standby_process(placement)
            services = elastic_mod.make_ps_fleet(
                _make_ps, init_params, ps_shards,
                expected_processes=nproc, token=token,
                straggler=(StragglerDetector()
                           if 0 in mine or standby_here else None),
                advertise_host=distributed.determine_host_address(),
                local_shards=mine, standby=standby_here)
            for svc in services:
                if svc.shard == 0 and not svc.is_standby:
                    svc.collector = TelemetryCollector()
            addresses, standby_addr = elastic_mod.gather_fleet_addresses(
                services, ps_shards)
            elastic_mod.connect_fleet(
                services, addresses, standby_address=standby_addr,
                token=token)
            client = elastic_mod.ShardedRemoteParameterServer(
                addresses, init_params, timeout=history_timeout + 60.0,
                token=token, codec=codec_name, standby=standby_addr)
            local_ps = client
        elif pid == 0:
            try:
                token = secrets.token_hex(16)
                if ps_shards == 1 and not ps_standby:
                    ps = _make_ps(init_params)
                    service = rps.ParameterServerService(
                        ps, init_params, expected_processes=nproc,
                        port=service_port, token=token,
                        collector=TelemetryCollector())
                    service.start()
                    ports = service.port
                else:
                    services = elastic_mod.make_ps_fleet(
                        _make_ps, init_params, ps_shards,
                        expected_processes=nproc, token=token,
                        straggler=StragglerDetector(),
                        advertise_host=distributed.determine_host_address(),
                        standby=ps_standby)
                    services[0].collector = TelemetryCollector()
                    ports = [svc.advertised for svc in services
                             if not svc.is_standby]
                    ports += ["~" + svc.advertised for svc in services
                              if svc.is_standby]
            except Exception:
                rps.share_service_address(None, error=True)
                raise
            rps.share_service_address(ports, token=token)
            if ps_shards == 1 and not ps_standby:
                local_ps = ps
                if runner.codec is not None and runner.codec.name != "raw":
                    # process 0's workers skip the socket but see the
                    # wire's numerics, as remote peers do
                    local_ps = comms.EncodedParameterServer(ps, runner.codec)
            else:
                client = elastic_mod.ShardedRemoteParameterServer(
                    [svc.advertised for svc in services
                     if not svc.is_standby], init_params,
                    timeout=history_timeout + 60.0, token=token,
                    codec=codec_name,
                    standby=next((svc.advertised for svc in services
                                  if svc.is_standby), None))
                local_ps = client
        else:
            addr, token = rps.share_service_address(None)
            entries = addr.split(",")
            standby_addr = next(
                (e[1:] for e in entries if e.startswith("~")), None)
            addresses = [e for e in entries if not e.startswith("~")]
            # the socket timeout outlives the history barrier
            if len(addresses) == 1 and standby_addr is None:
                client = rps.RemoteParameterServer(
                    addresses[0], init_params,
                    timeout=history_timeout + 60.0, token=token,
                    codec=codec_name)
            else:
                client = elastic_mod.ShardedRemoteParameterServer(
                    addresses, init_params, timeout=history_timeout + 60.0,
                    token=token, codec=codec_name, standby=standby_addr)
            local_ps = client
            # the authoritative start state lives at the center (process
            # 0 restored it on resume)
            init_params, _ = client.pull()
        runner.run(to_device(init_params, home), epoch_shards,
                   checkpointer=checkpointer if pid == 0 else None,
                   checkpoint_folds=checkpoint_folds if pid == 0 else 0,
                   start_clock=start_clock, ps=local_ps,
                   worker_offset=worker_offset, fetch_final=False,
                   watchdog=watchdog,
                   snapshot_extra=snapshot_extra if pid == 0 else None)
        if pid == 0 and client is None:
            service.put_history(0, runner.merged_windows)
            merged, center, clock = service.get_history_blocking(
                timeout=history_timeout)
        else:
            client.put_history(pid, runner.merged_windows)
            merged, center, clock = client.get_history(
                timeout=history_timeout)
        # every process that does not host the coordinator pushes its
        # registry rows to the coordinator's collector (best effort)
        reg = telemetry.get_registry()
        hosts_coord = service is not None or any(
            svc.shard == 0 and not svc.is_standby for svc in services)
        if reg is not None and client is not None and (
                pid != 0 or not hosts_coord):
            client.put_telemetry(pid, list(reg.rows()))
        # everyone holds the final state before process 0 stops the
        # service; the barrier also orders the pushes before the merge
        distributed.barrier()
        if pid == 0:
            collector = service.collector if service is not None else None
            promoted = [svc for svc in services
                        if svc.standby is not None and svc.standby.promoted]
            if promoted:
                collector = promoted[-1].collector
            elif collector is None:
                for svc in services:
                    if svc.shard == 0 and not svc.is_standby:
                        collector = svc.collector
            if collector is not None:
                runner.fleet_telemetry = collector.merged_rows(local_pid=0)
            elif client is not None:
                runner.fleet_telemetry = client.get_merged_telemetry()
    finally:
        if client is not None:
            client.close()
        if service is not None:
            service.stop()
        for svc in services:
            if svc.replicator is not None:
                svc.replicator.close(timeout=1.0)
            svc.stop()
    history = [step for _, _, steps in merged for step in steps]
    stal = [float(s) for _, s, _ in merged]
    return to_host(center), history, stal, int(clock)


def _round(feats: np.ndarray, labs: np.ndarray, batch_size: int,
           window: int) -> dict:
    """One round: ``batch_size * window`` rows as ``[window, batch, ...]``
    feature and label arrays."""
    return {"features": feats.reshape((window, batch_size)
                                      + feats.shape[1:]),
            "labels": labs.reshape((window, batch_size) + labs.shape[1:])}


def stage_worker_shards(shards, features_col: str, label_col: str,
                        batch_size: int, window: int) -> list:
    """Host-side staging for the async runner: per-worker lists of
    ``[window, batch, ...]`` batch dicts (rounds of ``window``
    minibatches) of numpy arrays; the runner copies each to its worker's
    device one round ahead."""
    out = []
    per_round = batch_size * window
    for s in shards:
        rounds = len(s) // per_round
        rs = []
        for r in range(rounds):
            lo = r * per_round
            rs.append(_round(np.asarray(s[features_col][lo:lo + per_round]),
                             np.asarray(s[label_col][lo:lo + per_round]),
                             batch_size, window))
        out.append(rs)
    return out


def stream_worker_rounds(address: str, worker: int, features_col: str,
                         label_col: str, batch_size: int, window: int,
                         token: Optional[str] = None, dataset=None,
                         max_ranges: int = 2):
    """A lease-driven round source for one worker: returns the ZERO-ARG
    CALLABLE :meth:`HostAsyncRunner.run` accepts as an ``epoch_shards``
    worker entry (streaming admission, DESIGN.md §20).

    Each call opens a fresh :class:`~distkeras_tpu_torch.data.service.
    DataServiceClient` (the client is not thread-safe; one per worker
    thread) and drives lease -> materialize -> ack against the
    coordinator at ``address``, reshaping leased row ranges into the
    exact ``[window, batch, ...]`` numpy round dicts
    :func:`stage_worker_shards` produces: the worker loop cannot tell
    staged and streamed rounds apart. Rows come from ``dataset`` locally
    when given, else over the wire. Epoch advancement is
    coordinator-side; the generator ends when the coordinator reports the
    stream exhausted.

    A range is acked once the consumer advances past it, which can
    precede the emission of the round holding its final rows: rows
    buffered toward an incomplete round when a worker dies are bounded
    by ``batch_size * window + max_ranges * range_size``, the
    drop-remainder loss :func:`stage_worker_shards` has at every shard
    tail."""
    def rounds():
        from distkeras_tpu_torch.data.service import (DataServiceClient,
                                                      stream_ranges)
        per_round = batch_size * window
        client = DataServiceClient(address, worker=worker, token=token)
        client.register()
        cols = [features_col, label_col]
        feats = labs = None  # row backlog pending reshape into rounds
        try:
            for _e, _pos, _start, _stop, rows in stream_ranges(
                    client, dataset=dataset, cols=cols,
                    max_ranges=max_ranges):
                f, l = np.asarray(rows[features_col]), \
                    np.asarray(rows[label_col])
                feats = f if feats is None else np.concatenate([feats, f])
                labs = l if labs is None else np.concatenate([labs, l])
                while len(feats) >= per_round:
                    tf, feats = feats[:per_round], feats[per_round:]
                    tl, labs = labs[:per_round], labs[per_round:]
                    yield _round(tf, tl, batch_size, window)
        finally:
            try:
                client.deregister()
            except Exception:
                pass
            client.close()
    return rounds
