"""Live health plane of the port (``distkeras_tpu/health/`` in the JAX
package): introspection endpoints, heartbeats, membership, SLOs, the
time-series store, the watchdog and the flight recorder.

Turns the passive telemetry layer (``telemetry.py``: write metrics, dump
JSONL post-run) into something you can *query while a job runs* — see
DESIGN.md §9:

- :mod:`.endpoints` — ``status`` / ``metrics-snapshot`` / ``recent-spans``
  / ``series`` ops mounted on the serving front-end, plus the
  :class:`HealthClient` poller and the
  ``python -m distkeras_tpu_torch.health.cli`` command.
- :mod:`.heartbeat` — per-window worker heartbeats and the rolling-median
  :class:`StragglerDetector`; :mod:`.membership` — leases, eviction and
  re-admission (the fleet router's liveness).
- :mod:`.slo` and :mod:`.timeseries` — burn-rate objectives over the live
  registry or the tiered history, and the trend detectors.
- :mod:`.watchdog` — :class:`TrainingWatchdog` NaN/divergence/stall
  monitor with ``warn`` / ``raise`` / ``checkpoint_and_raise`` policies.

No module in this package imports torch — same rule as ``telemetry.py``:
publishing a heartbeat or observing a loss can never put a device sync
on the step path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from distkeras_tpu_torch.health.endpoints import (HEALTH_OPS, HealthClient,
                                                  handle_health_op)
from distkeras_tpu_torch.health.heartbeat import (HeartbeatPublisher,
                                                  StragglerDetector)
# importing the recorder module installs the default-on FlightRecorder
# into telemetry's sink slot (the package is loaded by every trainer path)
from distkeras_tpu_torch.health.recorder import FlightRecorder
from distkeras_tpu_torch.health.slo import AlertEvent, SloEngine, SloSpec
from distkeras_tpu_torch.health.watchdog import (POLICIES, Divergence,
                                                 NaNLoss, SloBreach, Stall,
                                                 TrainingWatchdog,
                                                 WatchdogError)

__all__ = [
    "HealthConfig", "resolve",
    "HEALTH_OPS", "HealthClient", "handle_health_op",
    "HeartbeatPublisher", "StragglerDetector",
    "POLICIES", "TrainingWatchdog", "WatchdogError",
    "NaNLoss", "Divergence", "Stall", "SloBreach",
    "FlightRecorder", "SloSpec", "SloEngine", "AlertEvent",
]


@dataclasses.dataclass
class HealthConfig:
    """Declarative form of the watchdog + straggler knobs, accepted by
    ``DistributedTrainer(health=...)``. Field semantics match
    :class:`TrainingWatchdog` / :class:`StragglerDetector`."""

    policy: str = "warn"
    nan: bool = True
    divergence_factor: Optional[float] = None
    stall_timeout_s: Optional[float] = None
    straggler_k: float = 3.0
    straggler_min_samples: int = 4

    def make_watchdog(self, checkpoint_fn=None,
                      on_trip=None) -> TrainingWatchdog:
        return TrainingWatchdog(
            policy=self.policy, nan=self.nan,
            divergence_factor=self.divergence_factor,
            stall_timeout_s=self.stall_timeout_s,
            checkpoint_fn=checkpoint_fn, on_trip=on_trip)

    def make_straggler_detector(self) -> StragglerDetector:
        return StragglerDetector(k=self.straggler_k,
                                 min_samples=self.straggler_min_samples)


def resolve(health: Union[None, str, dict, HealthConfig,
                          TrainingWatchdog]) -> Optional[HealthConfig]:
    """Normalize the trainer's ``health=`` argument to a
    :class:`HealthConfig` (or None = health monitoring off):

    - ``None`` → None
    - policy string (``"warn"`` / ``"raise"`` / ``"checkpoint_and_raise"``)
      → config with that policy and defaults otherwise
    - dict → ``HealthConfig(**dict)``
    - :class:`HealthConfig` → itself

    A pre-built :class:`TrainingWatchdog` is rejected: the trainer creates
    a fresh watchdog per ``train()`` call (trip state must not leak across
    runs) and binds ``checkpoint_fn`` itself.
    """
    if health is None or isinstance(health, HealthConfig):
        return health
    if isinstance(health, str):
        if health not in POLICIES:
            raise ValueError(f"health policy must be one of {POLICIES}, "
                             f"got {health!r}")
        return HealthConfig(policy=health)
    if isinstance(health, dict):
        return HealthConfig(**health)
    if isinstance(health, TrainingWatchdog):
        raise TypeError(
            "pass a HealthConfig (or dict/policy string), not a built "
            "TrainingWatchdog — the trainer makes a fresh watchdog per "
            "train() so trip state cannot leak across runs")
    raise TypeError(f"health= must be None, a policy string, a dict, or a "
                    f"HealthConfig; got {type(health).__name__}")
