"""Live rollout (port of ``distkeras_tpu/serving/rollout.py``): versioned
weight swaps, canary scoring, rollback.

A trainer publishes monotone-versioned weight snapshots through a
:class:`WeightPublisher`; a :class:`RolloutController` on the serving
side installs them into
:class:`~distkeras_tpu_torch.serving.engine.ServingEngine` and/or
:class:`~distkeras_tpu_torch.serving.generation.GenerationEngine` with
no capture: every CUDA graph was captured in the engine's constructor,
and a swap casts the new float32 masters into a weight bank in place
(the tensors the graphs read keep their addresses). The
``GenerationEngine`` holds two banks, so in-flight requests finish on
the version they were admitted on; the ``ServingEngine`` holds one and
loads it between two batches.

A "params tree" here is a ``state_dict`` (name -> tensor, as
``model.state_dict()`` gives; numpy arrays are taken too). The safety
ladder is the JAX package's:

- **swap atomicity**: :func:`validate_tree_like` refuses a candidate
  whose names, shapes or dtypes differ from the incumbent's before any
  engine state is touched, and each engine makes a loaded bank current
  in one step that request execution reads once a batch or step;
- **canary**: a staged version is scored on mirrored shadow rows against
  the incumbent (:class:`~distkeras_tpu_torch.evaluators.
  CanaryAgreementEvaluator`) and promotes only at agreement >= threshold;
- **rollback**: a swap of the retained last-good ``state_dict``; the
  float32 -> bank-dtype cast is deterministic, so the restore is
  bit-identical. :meth:`RolloutController.on_breach` takes any alert with
  the fields of the JAX package's ``AlertEvent`` (``slo``, ``message``).

The controller is duck-typed against ``swap_weights``/``model_version``/
``shadow_forward`` and imports neither engine.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from distkeras_tpu_torch import telemetry

logger = logging.getLogger("distkeras_tpu_torch.serving.rollout")


def _dtype(a) -> torch.dtype:
    if isinstance(a, torch.Tensor):
        return a.dtype
    return torch.from_numpy(np.empty(0, np.asarray(a).dtype)).dtype


def validate_tree_like(new, like) -> None:
    """Refuse a candidate ``state_dict`` that is not drop-in compatible
    with the incumbent: the same names, and per name the same shape and
    dtype. This is the swap-atomicity gate: a torn publish fails here
    BEFORE any engine state is touched. Raises ValueError with the first
    mismatch; returns None when compatible."""
    if sorted(new) != sorted(like):
        missing = sorted(set(like) - set(new))
        extra = sorted(set(new) - set(like))
        raise ValueError(
            f"weight swap rejected: tree structure mismatch (missing "
            f"{missing[:4]}, unexpected {extra[:4]})")
    for i, name in enumerate(sorted(like)):
        a, b = new[name], like[name]
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(
                f"weight swap rejected: leaf {i} ({name}) shape "
                f"{tuple(a.shape)} != incumbent {tuple(b.shape)} (torn or "
                f"mismatched publish)")
        if _dtype(a) != _dtype(b):
            raise ValueError(
                f"weight swap rejected: leaf {i} ({name}) dtype "
                f"{_dtype(a)} != incumbent {_dtype(b)}")


def _torn_copy(tree) -> dict:
    """A structurally valid but shape-torn copy of ``tree`` (every other
    entry, in sorted name order, replaced by an empty tensor): what a
    half-serialized publish looks like after decode. Engine-side
    validation MUST refuse it."""
    return {name: (torch.zeros(0, dtype=_dtype(tree[name])) if i % 2
                   else tree[name])
            for i, name in enumerate(sorted(tree))}


class WeightPublisher:
    """Trainer-side half of the rollout plane: stamps a monotone
    ``model_version`` onto weight snapshots and hands them to subscribers
    (in-process controllers) and/or the parameter server
    (``ps.set_model_version``: remote controllers see the version on
    their next pull).

    With ``ps=`` (a local :class:`~distkeras_tpu_torch.parameter_servers.
    ParameterServer` or a :class:`~distkeras_tpu_torch.parallel.
    remote_ps.RemoteParameterServer`), ``publish(params=None)`` pulls the
    live center and hands it to subscribers as tensors on ``device``
    (``cuda:0`` unless the caller passes ``device="cpu"``).

    The publish path is a chaos site (``"rollout.publish"``,
    :mod:`distkeras_tpu_torch.utils.fault`): ``drop`` loses the publish
    (version not bumped), ``delay`` stalls it, ``torn`` delivers a
    half-serialized tree that subscriber-side validation must refuse.
    """

    def __init__(self, ps=None, start_version: int = 0, device=None):
        self.ps = ps
        self.device = None
        if ps is not None:
            from distkeras_tpu_torch.device import resolve_device

            self.device = resolve_device(device)
        self.version = int(start_version)
        self._subscribers: list[Callable] = []
        self._lock = threading.Lock()

    def subscribe(self, callback: Callable) -> None:
        """Register ``callback(version, params, clock)`` for each publish."""
        self._subscribers.append(callback)

    def publish(self, params=None, clock=None) -> Optional[int]:
        """Publish a snapshot as the next version. ``params=None`` pulls
        the live center from ``self.ps``. Returns the published version,
        or None when chaos dropped the publish."""
        from distkeras_tpu_torch.utils import fault

        act = fault.chaos("rollout.publish")
        if act is not None and act.action == "drop":
            telemetry.counter("rollout.publish_dropped").inc()
            logger.warning("weight publish dropped by chaos injection")
            return None
        if act is not None and act.action == "delay":
            time.sleep(act.delay_s)
        if params is None:
            if self.ps is None:
                raise ValueError("publish(params=None) needs a ps to "
                                 "snapshot the center from")
            from distkeras_tpu_torch.utils.transfer import to_device

            params, pulled_clock = self.ps.pull()
            params = to_device(params, self.device)
            if clock is None:
                clock = pulled_clock
        if act is not None and act.action == "torn":
            # half-serialized delivery: structurally valid, leaf shapes
            # wrong — every subscriber's swap validation must refuse it
            params = _torn_copy(params)
        with self._lock:
            self.version += 1
            version = self.version
        if self.ps is not None:
            self.ps.set_model_version(version)
        telemetry.counter("rollout.publishes").inc()
        telemetry.record_event("rollout", action="publish",
                               version=version, clock=clock)
        for cb in list(self._subscribers):
            cb(version, params, clock)
        return version


class CanaryConfig:
    """How a staged version must prove itself before promotion.

    ``fraction`` of served batches are mirrored into a shadow buffer
    (a deterministic accumulator, not sampling); once ``min_rows``
    mirrored rows have been scored, agreement between candidate and
    incumbent outputs (``evaluator``, default
    :class:`~distkeras_tpu_torch.evaluators.CanaryAgreementEvaluator`)
    must reach ``threshold`` to promote.
    """

    def __init__(self, fraction: float = 0.25, min_rows: int = 32,
                 threshold: float = 0.98, evaluator=None,
                 max_mirror_rows: int = 512):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        self.fraction = float(fraction)
        self.min_rows = int(min_rows)
        self.threshold = float(threshold)
        if evaluator is None:
            from distkeras_tpu_torch.evaluators import \
                CanaryAgreementEvaluator

            evaluator = CanaryAgreementEvaluator()
        self.evaluator = evaluator
        self.max_mirror_rows = int(max_mirror_rows)


class RolloutController:
    """Serving-side half: receives or pulls versions, canaries them
    against the incumbent on mirrored traffic, promotes on pass, and
    rolls back to the retained last-good version on an SLO breach.

    ``engine`` (ServingEngine) and/or ``generator`` (GenerationEngine)
    are the swap targets; ``source`` is an optional versioned pull
    source (``pull_versioned()`` or ``pull()`` plus ``model_version``)
    for :meth:`poll`. ``canary=None`` promotes every staged version
    immediately (still validated, still retaining last-good).
    """

    def __init__(self, engine=None, generator=None, source=None,
                 canary: Optional[CanaryConfig] = None):
        if engine is None and generator is None:
            raise ValueError("RolloutController needs at least one of "
                             "engine= or generator=")
        self.engine = engine
        self.generator = generator
        self.source = source
        self.canary = canary
        self._lock = threading.Lock()
        primary = engine if engine is not None else generator
        self.current_version = int(getattr(primary, "model_version", 0))
        self.current_params = engine.params if engine is not None \
            else generator._params
        # last-good retained for rollback (starts empty: the boot version
        # has nothing earlier to fall back to)
        self.last_good_version: Optional[int] = None
        self.last_good_params = None
        # staged candidate awaiting canary verdict
        self.candidate_version: Optional[int] = None
        self.candidate_params = None
        self._mirror = collections.deque(
            maxlen=canary.max_mirror_rows if canary else 0)
        self._acc = 0.0
        self.last_agreement: Optional[float] = None
        if canary is not None and engine is not None:
            engine.mirror_sink = self._tap

    # -- mirrored shadow traffic ------------------------------------------

    def _tap(self, rows: np.ndarray) -> None:
        """Mirror sink installed on the serving engine: keeps a
        deterministic ``fraction`` of served batches for shadow scoring.
        Runs on the batcher thread; never touches engine state."""
        if self.canary is None:
            return
        self._acc += self.canary.fraction
        if self._acc < 1.0:
            return
        self._acc -= 1.0
        with self._lock:
            self._mirror.append(np.asarray(rows))
        telemetry.counter("rollout.canary.mirrored").inc(len(rows))

    def mirrored_rows(self) -> Optional[np.ndarray]:
        with self._lock:
            if not self._mirror:
                return None
            return np.concatenate(list(self._mirror), axis=0)

    # -- staging / promotion ----------------------------------------------

    def stage(self, version: int, params) -> bool:
        """Receive a published version. Non-monotone versions are refused
        (counter ``rollout.stale_publishes``); with no canary configured
        the version promotes immediately; otherwise it waits as candidate
        until :meth:`evaluate_canary` passes."""
        version = int(version)
        with self._lock:
            if version <= self.current_version:
                telemetry.counter("rollout.stale_publishes").inc()
                telemetry.record_event("rollout", action="stale_publish",
                                       version=version,
                                       current=self.current_version)
                return False
        if self.canary is None:
            return self.promote(version, params)
        # validate EAGERLY so a torn publish is refused at staging time,
        # not after it has shadow-served
        try:
            validate_tree_like(params, self.current_params)
        except ValueError:
            telemetry.counter("rollout.torn_swaps_blocked",
                              engine="controller").inc()
            telemetry.record_event("rollout", action="torn_stage_blocked",
                                   version=version)
            logger.warning("staged version %d refused: incompatible tree",
                           version)
            return False
        with self._lock:
            self.candidate_version = version
            self.candidate_params = params
            self.last_agreement = None
        telemetry.record_event("rollout", action="stage", version=version)
        return True

    def poll(self) -> bool:
        """Pull the source once; stage when it advertises a newer version.
        Returns True when something was staged/promoted."""
        if self.source is None:
            raise ValueError("poll() needs a source= pull target")
        if hasattr(self.source, "pull_versioned"):
            params, _clock, version = self.source.pull_versioned()
        else:
            params, _clock = self.source.pull()
            version = int(getattr(self.source, "model_version", 0))
        if version <= self.current_version:
            return False
        return self.stage(version, params)

    def evaluate_canary(self, rows: Optional[np.ndarray] = None
                        ) -> Optional[float]:
        """Score the staged candidate against the incumbent on mirrored
        shadow rows (or explicit ``rows``). Promotes on pass; discards
        the candidate on fail. Returns the agreement score, or None when
        there is nothing to score yet. Requires ``engine`` (the one-shot
        engine owns ``shadow_forward``)."""
        with self._lock:
            candidate_version = self.candidate_version
            candidate_params = self.candidate_params
        if candidate_version is None:
            return None
        if self.engine is None:
            raise ValueError("canary scoring needs the dense engine= "
                             "(shadow_forward lives there)")
        if rows is None:
            rows = self.mirrored_rows()
        if rows is None or len(rows) < (self.canary.min_rows
                                        if self.canary else 1):
            return None
        cand = self.engine.shadow_forward(candidate_params, rows)
        incumbent = self.engine.shadow_forward(self.current_params, rows)
        score = float(self.canary.evaluator.evaluate(
            {"candidate": cand, "incumbent": incumbent}))
        with self._lock:
            self.last_agreement = score
        telemetry.counter("rollout.canary.evals").inc()
        telemetry.gauge("rollout.canary.agreement").set(score)
        telemetry.record_event("rollout", action="canary_eval",
                               version=candidate_version, agreement=score,
                               rows=int(len(rows)))
        if score >= (self.canary.threshold if self.canary else 0.0):
            self.promote(candidate_version, candidate_params)
        else:
            with self._lock:
                self.candidate_version = None
                self.candidate_params = None
            telemetry.counter("rollout.rejections").inc()
            telemetry.record_event("rollout", action="canary_reject",
                                   version=candidate_version,
                                   agreement=score)
            logger.warning("canary version %d rejected: agreement %.4f "
                           "< %.4f", candidate_version, score,
                           self.canary.threshold if self.canary else 0.0)
        return score

    def promote(self, version: int, params) -> bool:
        """Install ``params`` as ``version`` on every engine, retaining
        the incumbent as last-good. All-or-nothing at the controller
        level: validation runs against the one-shot engine first, so a
        refused tree never reaches the generator either."""
        version = int(version)
        try:
            self._install(version, params)
        except ValueError:
            # torn/incompatible tree: engines refused, nothing installed
            return False
        with self._lock:
            self.last_good_version = self.current_version
            self.last_good_params = self.current_params
            self.current_version = version
            self.current_params = params
            if self.candidate_version == version:
                self.candidate_version = None
                self.candidate_params = None
        telemetry.counter("rollout.promotions").inc()
        telemetry.record_event("rollout", action="promote", version=version,
                               previous=self.last_good_version)
        return True

    def _install(self, version: int, params) -> None:
        """Swap both engines to (version, params). The one-shot engine
        goes first (its validation is synchronous and cheap); a refusal
        there aborts before the generator is touched. If the generator's
        swap then fails (refused, timed out waiting for a pinned version,
        engine closed), the one-shot engine is swapped back to what it
        served, so both engines stay on the controller's version."""
        t0 = time.perf_counter()
        if self.engine is not None:
            before = (self.engine.params, self.engine.model_version)
            self.engine.swap_weights(params, version)
        if self.generator is not None:
            try:
                self.generator.swap_weights(params, version)
            except Exception:
                if self.engine is not None:
                    self.engine.swap_weights(*before)
                raise
        telemetry.histogram("rollout.swap_s").record(
            time.perf_counter() - t0)
        from distkeras_tpu_torch.health import recorder as flight_recorder

        flight_recorder.configure(serving_model_version=int(version))

    # -- rollback ----------------------------------------------------------

    def rollback(self, alert=None) -> bool:
        """Swap back to the retained last-good version (bit-identical:
        the same float32 masters, cast again). A pending candidate is
        discarded first. Idempotent: a second rollback with nothing newer
        installed is a no-op. Returns True when a swap happened."""
        with self._lock:
            candidate = self.candidate_version
            self.candidate_version = None
            self.candidate_params = None
            from_version = self.current_version
            to_version = self.last_good_version
            to_params = self.last_good_params
        if candidate is not None:
            telemetry.counter("rollout.rejections").inc()
            telemetry.record_event("rollout", action="candidate_discarded",
                                   version=candidate)
        if to_version is None or to_params is None \
                or to_version == from_version:
            telemetry.record_event("rollout", action="rollback_noop",
                                   current=from_version)
            return False
        self._install(to_version, to_params)
        with self._lock:
            self.current_version = to_version
            self.current_params = to_params
            # last-good stays as-is: rolling back twice is a no-op, not a
            # walk further into history
        telemetry.counter("rollout.rollbacks").inc()
        from distkeras_tpu_torch.health import recorder as flight_recorder

        rec = flight_recorder.get_recorder()
        rec.record("rollout", action="rollback",
                   from_version=from_version, to_version=to_version,
                   slo=getattr(alert, "slo", None),
                   message=getattr(alert, "message", None))
        rec.set_fingerprint(serving_model_version=int(to_version),
                            rollback_from_version=int(from_version))
        telemetry.record_event("rollout", action="rollback",
                               from_version=from_version,
                               to_version=to_version,
                               slo=getattr(alert, "slo", None))
        logger.warning("rolled back %d -> %d (%s)", from_version,
                       to_version, getattr(alert, "slo", "manual"))
        return True

    def on_breach(self, alert) -> None:
        """SLO ``on_breach`` hook: roll back instead of raising, keeping
        the breach's context in a postmortem bundle. NEVER raises."""
        try:
            from distkeras_tpu_torch.health import recorder as \
                flight_recorder

            swapped = self.rollback(alert)
            reason = "rollout_rollback" if swapped else "canary_breach"
            flight_recorder.auto_dump(reason)
        except Exception:  # pragma: no cover - forensics must not raise
            logger.exception("rollback on SLO breach failed")

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        """JSON-safe controller state for health digests."""
        with self._lock:
            return {
                "current_version": self.current_version,
                "last_good_version": self.last_good_version,
                "candidate_version": self.candidate_version,
                "last_agreement": self.last_agreement,
                "mirror_rows": int(sum(len(r) for r in self._mirror)),
            }


__all__ = [
    "CanaryConfig",
    "RolloutController",
    "WeightPublisher",
    "validate_tree_like",
]
