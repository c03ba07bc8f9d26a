"""Elastic worker membership: leases, eviction, re-admission (port of
``distkeras_tpu/health/membership.py``).

The reference's parameter server had no notion of membership at all —
workers were whatever Spark happened to schedule, and a straggling or
preempted executor just made the loss curve mushier (SURVEY.md §5). The
elastic fleet (DESIGN.md §13) gives the coordinator shard an explicit
member table with three verbs:

- **register**: a worker joins (or re-joins) and is granted a lease;
  every commit it lands renews the lease — a commit IS proof of life.
- **evict**: the coordinator expels a worker whose lease lapsed (it
  stopped committing: killed, preempted, partitioned) or whose window
  durations trip the :class:`~distkeras_tpu_torch.health.heartbeat.
  StragglerDetector` rolling-median threshold — the detector graduates
  from reporting to acting here.
- **re-admit**: an evicted worker that returns is taken back, and the
  commit it returns WITH is folded at DynSGD staleness weight
  (1/(staleness+1)) regardless of server flavor — the paper's rule for
  exactly this churn scenario, applied by the service's commit handler
  (``should_late_fold`` is the decision surface).

Deterministic by construction: ``time_fn`` is injectable (scripted-clock
tests advance it by hand) and the straggler verdict is a pure function
of the observed duration sequence. Like the rest of ``health/``, this
module never imports torch — membership decisions must be computable while
the device runtime is wedged.

Telemetry: ``elastic.workers`` gauge (registered members),
``elastic.evictions{reason=}`` / ``elastic.readmissions`` counters.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.health.heartbeat import StragglerDetector

#: Default lease: generous against scheduling hiccups on a shared CPU
#: host, small against a real preemption (a TPU pod eviction notice is
#: tens of seconds).
DEFAULT_LEASE_S = 30.0


class _Member:
    __slots__ = ("lease_s", "expires", "evicted", "reason", "commits")

    def __init__(self, lease_s: float, now: float):
        self.lease_s = lease_s
        self.expires = now + lease_s
        self.evicted = False
        self.reason = ""
        self.commits = 0


class Membership:
    """The coordinator's member table (one per fleet, lives on shard 0).

    Thread-safe: the service's handler threads call into it concurrently.
    Workers the table has never seen (or that cleanly deregistered) are
    non-members — their commits fold normally; membership only *acts* on
    workers that joined and then misbehaved.
    """

    def __init__(self, lease_s: float = DEFAULT_LEASE_S,
                 straggler: Optional[StragglerDetector] = None,
                 time_fn: Callable[[], float] = time.time):
        if lease_s <= 0:
            raise ValueError(f"lease_s must be > 0, got {lease_s}")
        self.lease_s = float(lease_s)
        self.straggler = straggler
        self._time = time_fn
        self._members: Dict[int, _Member] = {}
        self._lock = threading.Lock()

    # -- verbs -----------------------------------------------------------
    def register(self, worker: int, lease_s: Optional[float] = None) -> float:
        """Join (or re-join) the fleet; returns the granted lease length.
        Registering while evicted is a re-admission."""
        worker = int(worker)
        lease = float(lease_s) if lease_s else self.lease_s
        with self._lock:
            m = self._members.get(worker)
            if m is None:
                self._members[worker] = _Member(lease, self._time())
            else:
                if m.evicted:
                    self._readmit_locked(worker, m)
                m.lease_s = lease
                m.expires = self._time() + lease
            n = len(self._members)
        telemetry.gauge("elastic.workers").set(n)
        return lease

    def renew(self, worker: int) -> bool:
        """Extend the worker's lease; returns True when the worker is
        (still) evicted — a renewing evicted worker is NOT readmitted
        (readmission rides its next commit, which late-folds)."""
        self.sweep()
        with self._lock:
            m = self._members.get(int(worker))
            if m is None:
                return False
            m.expires = self._time() + m.lease_s
            return m.evicted

    def deregister(self, worker: int) -> None:
        """Clean leave: the worker is forgotten (no eviction recorded)."""
        with self._lock:
            self._members.pop(int(worker), None)
            n = len(self._members)
        telemetry.gauge("elastic.workers").set(n)

    def sweep(self) -> list:
        """Evict every member whose lease has lapsed; returns the worker
        ids evicted by THIS sweep. Called lazily from every op — the
        table needs no timer thread of its own."""
        now = self._time()
        newly: list = []
        with self._lock:
            for worker, m in self._members.items():
                if not m.evicted and now > m.expires:
                    self._evict_locked(worker, m, "lease")
                    newly.append(worker)
        return newly

    def should_late_fold(self, worker: int) -> bool:
        """The commit handler's decision surface: sweep, then report
        whether this worker's commit must be DynSGD-staleness-weighted
        (it is currently evicted). Does NOT mutate state beyond the
        sweep — call :meth:`observe_commit` after the fold."""
        self.sweep()
        with self._lock:
            m = self._members.get(int(worker))
            return m is not None and m.evicted

    def observe_commit(self, worker: int,
                       window_s: Optional[float] = None) -> None:
        """Account a landed commit: renew the lease, re-admit if the
        worker was evicted (it returned), and feed the straggler
        detector — whose verdict may evict it for SUBSEQUENT commits."""
        worker = int(worker)
        with self._lock:
            m = self._members.get(worker)
            if m is not None:
                if m.evicted:
                    self._readmit_locked(worker, m)
                m.expires = self._time() + m.lease_s
                m.commits += 1
        if (self.straggler is not None and window_s is not None
                and m is not None):
            flagged = self.straggler.observe(worker, float(window_s))
            with self._lock:
                m = self._members.get(worker)
                if m is None:
                    return
                if flagged and not m.evicted:
                    self._evict_locked(worker, m, "straggler")
                elif not flagged and m.evicted and m.reason == "straggler":
                    self._readmit_locked(worker, m)

    # -- state transitions (callers hold self._lock) ---------------------
    def _evict_locked(self, worker: int, m: _Member, reason: str) -> None:
        m.evicted = True
        m.reason = reason
        telemetry.counter("elastic.evictions", reason=reason).inc()
        telemetry.record_event("membership", transition="evict",
                               worker=worker, reason=reason)

    def _readmit_locked(self, worker: int, m: _Member) -> None:
        m.evicted = False
        m.reason = ""
        m.expires = self._time() + m.lease_s
        telemetry.counter("elastic.readmissions").inc()
        telemetry.record_event("membership", transition="readmit",
                               worker=worker)

    # -- replication (coordinator failover, parallel/failover.py) --------
    def export(self) -> dict:
        """The member table as a plain-JSON snapshot for the write-behind
        log. Lease deadlines travel as REMAINING seconds (``expires_in``),
        not absolute times: the standby's clock need not agree with the
        coordinator's, only tick at the same rate."""
        now = self._time()
        with self._lock:
            return {
                str(w): {
                    "lease_s": m.lease_s,
                    "expires_in": round(m.expires - now, 3),
                    "evicted": m.evicted,
                    "reason": m.reason,
                    "commits": m.commits,
                } for w, m in self._members.items()
            }

    def restore(self, table: dict) -> None:
        """Rebuild the member table from an :meth:`export` snapshot — the
        promotion half of coordinator failover. Replaces any existing
        members; lease deadlines re-anchor on THIS table's clock. Members
        whose remaining lease was already negative at export time come
        back expired and are evicted by the next sweep (they then re-admit
        through the normal late-fold path when they return)."""
        now = self._time()
        with self._lock:
            self._members.clear()
            for worker, row in table.items():
                m = _Member(float(row.get("lease_s", self.lease_s)), now)
                m.expires = now + float(row.get("expires_in", m.lease_s))
                m.evicted = bool(row.get("evicted", False))
                m.reason = str(row.get("reason", ""))
                m.commits = int(row.get("commits", 0))
                self._members[int(worker)] = m
            n = len(self._members)
        telemetry.gauge("elastic.workers").set(n)

    # -- introspection ---------------------------------------------------
    def is_evicted(self, worker: int) -> bool:
        with self._lock:
            m = self._members.get(int(worker))
            return m is not None and m.evicted

    @property
    def workers(self) -> list:
        with self._lock:
            return sorted(self._members)

    def status(self) -> dict:
        """Digest for the health ``status`` op: per-worker lease state."""
        self.sweep()
        now = self._time()
        with self._lock:
            return {
                "workers": {
                    str(w): {
                        "lease_remaining_s": round(m.expires - now, 3),
                        "evicted": m.evicted,
                        **({"reason": m.reason} if m.evicted else {}),
                        "commits": m.commits,
                    } for w, m in sorted(self._members.items())
                },
                "evicted": sorted(w for w, m in self._members.items()
                                  if m.evicted),
            }
