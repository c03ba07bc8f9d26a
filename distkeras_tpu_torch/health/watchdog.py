"""Training watchdog: NaN/Inf, divergence, and stall detection with policies
(port of ``distkeras_tpu/health/watchdog.py``).

An async-PS run fails in ways the post-run JSONL can never show: one NaN'd
replica poisons the center variable within a few folds, a diverging loss
burns the rest of the budget, and a deadlocked worker stalls the run
silently (no epoch barrier means nothing ever times out). The watchdog
watches the loss/update-norm streams the trainers already produce and
reacts *while the run is alive*, per a configurable policy:

==================== =======================================================
policy               on trip
==================== =======================================================
``warn``             ``warnings.warn`` + telemetry, training continues
``raise``            raise the typed error (aborts the run)
``checkpoint_and_raise``  call ``checkpoint_fn`` (snapshot the live center),
                     then raise the typed error
==================== =======================================================

Typed errors: :class:`NaNLoss`, :class:`Divergence`, :class:`Stall` — all
subclasses of :class:`WatchdogError` with a ``.kind`` tag, so supervisors
(``utils/fault.run_with_retries``) can route them. A watchdog trips at most
once; after the trip every observation is a no-op.

No framework import (telemetry.py's rule): observing a loss can never sync a
device. Clocks are injectable for deterministic stall tests.
"""

from __future__ import annotations

import math
import threading
import time
import warnings
from typing import Callable, Optional

from distkeras_tpu_torch import telemetry

POLICIES = ("warn", "raise", "checkpoint_and_raise")


class WatchdogError(RuntimeError):
    """Base typed error for watchdog trips; ``kind`` routes supervisors."""

    kind = "watchdog"


class NaNLoss(WatchdogError):
    """A monitored loss/update-norm went NaN or Inf."""

    kind = "nan"


class Divergence(WatchdogError):
    """The smoothed loss rose past ``divergence_factor ×`` its best value."""

    kind = "divergence"


class Stall(WatchdogError):
    """No training progress for longer than ``stall_timeout_s``."""

    kind = "stall"


class SloBreach(WatchdogError):
    """An SLO engine breach routed through the policy ladder
    (``health/slo.watchdog_on_breach`` is the adapter)."""

    kind = "slo"


class TrainingWatchdog:
    """Monitors loss / update-norm streams; trips per the configured policy.

    Args:
      policy: one of :data:`POLICIES`.
      nan: check every observed value for NaN/Inf (default on).
      divergence_factor: trip :class:`Divergence` when the EMA-smoothed
        loss exceeds ``factor ×`` the best (lowest) smoothed loss seen, after
        ``min_observations``. For losses that can reach zero or below, the
        comparison floor is ``max(best, divergence_floor)``. ``None`` = off.
      stall_timeout_s: trip :class:`Stall` when ``check_stall`` finds no
        ``notify_progress`` within this many seconds. ``None`` = off.
      checkpoint_fn: called (no args) before raising under
        ``checkpoint_and_raise``; the trainers bind this to a live-center
        snapshot. A failing checkpoint_fn does not mask the trip — its
        exception is attached as ``__context__``.
      clock: injectable monotonic clock for stall tests.
      on_trip: optional callback receiving the error just before it is
        raised — the async runner uses it to abort sibling workers.
    """

    def __init__(self, policy: str = "warn", nan: bool = True,
                 divergence_factor: Optional[float] = None,
                 divergence_floor: float = 1e-8,
                 min_observations: int = 8,
                 ema: float = 0.9,
                 stall_timeout_s: Optional[float] = None,
                 checkpoint_fn: Optional[Callable[[], object]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_trip: Optional[Callable[[WatchdogError], None]] = None):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        if divergence_factor is not None and divergence_factor <= 1.0:
            raise ValueError(f"divergence_factor must be > 1, "
                             f"got {divergence_factor}")
        if not (0.0 <= ema < 1.0):
            raise ValueError(f"ema must be in [0, 1), got {ema}")
        self.policy = policy
        self.nan = bool(nan)
        self.divergence_factor = divergence_factor
        self.divergence_floor = float(divergence_floor)
        self.min_observations = int(min_observations)
        self.ema = float(ema)
        self.stall_timeout_s = stall_timeout_s
        self.checkpoint_fn = checkpoint_fn
        self.on_trip = on_trip
        self._clock = clock
        self._lock = threading.Lock()
        self._n = 0
        self._smoothed: Optional[float] = None
        self._best: Optional[float] = None
        self._last_progress = clock()
        self.tripped: Optional[WatchdogError] = None
        self._stop_evt: Optional[threading.Event] = None
        self._monitor: Optional[threading.Thread] = None

    # -- trip machinery ---------------------------------------------------
    def _trip(self, err: WatchdogError) -> None:
        with self._lock:
            if self.tripped is not None:
                return
            self.tripped = err
        telemetry.counter("health.watchdog.trips", kind=err.kind,
                          policy=self.policy).inc()
        telemetry.gauge("health.watchdog.tripped").set(1.0)
        # forensics: the trip goes onto the flight-recorder ring, and (when
        # a dump dir is configured — trainers bind the checkpoint dir) the
        # whole ring is preserved as a postmortem bundle BEFORE any policy
        # action can unwind the process
        telemetry.record_event("watchdog_trip", kind=err.kind,
                               policy=self.policy, message=str(err))
        from distkeras_tpu_torch.health import recorder

        recorder.auto_dump(f"watchdog_{err.kind}")
        if self.policy == "warn":
            warnings.warn(f"watchdog [{err.kind}]: {err} "
                          f"(policy=warn, training continues)",
                          RuntimeWarning, stacklevel=3)
            return
        if self.policy == "checkpoint_and_raise" and \
                self.checkpoint_fn is not None:
            try:
                self.checkpoint_fn()
            except Exception as ckpt_err:
                err.__context__ = ckpt_err
                warnings.warn(
                    f"watchdog: crash-time checkpoint failed "
                    f"({type(ckpt_err).__name__}: {ckpt_err}); raising the "
                    f"original {err.kind} trip anyway", RuntimeWarning,
                    stacklevel=3)
        if self.on_trip is not None:
            self.on_trip(err)
        raise err

    # -- observation API --------------------------------------------------
    def observe_loss(self, value: float, source: str = "loss") -> None:
        """Feed one loss observation (a window/step mean). May raise a
        typed :class:`WatchdogError` per the policy; no-op after a trip."""
        if self.tripped is not None:
            return
        v = float(value)
        telemetry.gauge("health.watchdog.last_loss").set(v)
        if self.nan and not math.isfinite(v):
            self._trip(NaNLoss(
                f"non-finite {source} observed: {v!r} "
                f"(observation #{self._n + 1})"))
            return
        with self._lock:
            self._n += 1
            self._smoothed = v if self._smoothed is None else \
                self.ema * self._smoothed + (1.0 - self.ema) * v
            if self._best is None or self._smoothed < self._best:
                self._best = self._smoothed
            n, sm, best = self._n, self._smoothed, self._best
        if self.divergence_factor is not None and \
                n >= self.min_observations and \
                sm > self.divergence_factor * max(best,
                                                  self.divergence_floor):
            self._trip(Divergence(
                f"smoothed {source} {sm:.6g} exceeded "
                f"{self.divergence_factor}x its best {best:.6g} "
                f"after {n} observations"))

    def observe_slo_breach(self, alert) -> None:
        """Feed one SLO
        :class:`~distkeras_tpu_torch.health.slo.AlertEvent` into the policy
        ladder (the ``on_breach`` seam the rollout controller's
        canary/rollback attaches to): ``warn`` logs it, ``raise`` /
        ``checkpoint_and_raise`` abort the run with a typed
        :class:`SloBreach`. No-op after a trip, like every observation."""
        if self.tripped is not None:
            return
        self._trip(SloBreach(
            f"SLO {getattr(alert, 'slo', alert)!s} breached: "
            f"{getattr(alert, 'message', '')}"))

    def observe_update_norm(self, value: float) -> None:
        """Feed one update (commit/delta) norm — NaN/Inf screened like a
        loss; divergence tracking is loss-only."""
        if self.tripped is not None:
            return
        v = float(value)
        telemetry.gauge("health.watchdog.last_update_norm").set(v)
        if self.nan and not math.isfinite(v):
            self._trip(NaNLoss(f"non-finite update norm observed: {v!r}"))

    def notify_progress(self, now: Optional[float] = None) -> None:
        """Mark training progress (called per window/epoch) — resets the
        stall clock."""
        self._last_progress = self._clock() if now is None else now

    def check_stall(self, now: Optional[float] = None) -> None:
        """Raise :class:`Stall` (per policy) when no progress was notified
        within ``stall_timeout_s``. No-op when stall checking is off."""
        if self.stall_timeout_s is None or self.tripped is not None:
            return
        now = self._clock() if now is None else now
        idle = now - self._last_progress
        telemetry.gauge("health.watchdog.idle_s").set(idle)
        if idle > self.stall_timeout_s:
            self._trip(Stall(
                f"no training progress for {idle:.1f}s "
                f"(stall_timeout_s={self.stall_timeout_s})"))

    # -- background stall monitor -----------------------------------------
    def start_stall_monitor(self, interval: Optional[float] = None) -> None:
        """Run ``check_stall`` on a daemon thread every ``interval`` seconds
        (default: stall_timeout/4, capped at 1s). A trip is delivered
        through ``on_trip`` (the raise is swallowed by the monitor thread —
        there is no caller to propagate it to). No-op when stall checking
        is off."""
        if self.stall_timeout_s is None or self._monitor is not None:
            return
        interval = interval if interval is not None else \
            min(1.0, self.stall_timeout_s / 4.0)
        self._stop_evt = threading.Event()
        self.notify_progress()  # the monitor's epoch starts now

        def loop():
            while not self._stop_evt.wait(interval):
                try:
                    self.check_stall()
                except WatchdogError:
                    return  # on_trip already delivered it
        self._monitor = threading.Thread(target=loop, daemon=True,
                                         name="distkeras-watchdog")
        self._monitor.start()

    def stop_stall_monitor(self) -> None:
        if self._monitor is None:
            return
        self._stop_evt.set()
        self._monitor.join()
        self._monitor = None
        self._stop_evt = None
