"""Fault injection (port of ``distkeras_tpu/utils/fault.py``, without
``run_with_retries``, which comes with the trainers: ROADMAP.md Queue A,
item 12).

**Value corruption**: instrumented sites pass observed values through
:func:`apply`, and a test (or chaos run) arms a corruption with
:func:`inject`, e.g. ``inject("host_async.window_loss", after=3)`` makes
the fourth observed value a NaN. Hooks are empty-dict cheap when nothing
is armed.

**Transport chaos**: code passes control points through :func:`chaos`,
and a test arms a fault with :func:`inject_chaos`: drop a send, delay it,
reset the connection once (before or after the bytes left), kill the
service, or deliver a torn weight publish. Like :func:`apply`, the hooks
consume deterministic ``after``/``count`` budgets, so the paths behind
them are exercised by scripted injection instead of timing luck. The
sites the port passes through today are ``"rollout.publish"``
(:class:`~distkeras_tpu_torch.serving.rollout.WeightPublisher`),
``"kv.swap_in"`` (the prefix cache's page restore in
:class:`~distkeras_tpu_torch.serving.generation.GenerationEngine`) and
``"fleet.kv_handoff"`` (the prefill -> decode page shipment in
:class:`~distkeras_tpu_torch.serving.fleet.FleetRouter`).
"""

from __future__ import annotations

import math
import threading
from typing import Optional


# -- fault injection (health/watchdog test surface) --------------------------

class _Injection:
    __slots__ = ("value", "after", "count", "skipped", "fired")

    def __init__(self, value: float, after: int, count: Optional[int]):
        self.value = value
        self.after = int(after)    # clean observations before firing
        self.count = count         # firings before disarming (None = all)
        self.skipped = 0
        self.fired = 0


_injections: dict = {}
_inj_lock = threading.Lock()


def inject(site: str, value: float = math.nan, after: int = 0,
           count: Optional[int] = None) -> None:
    """Arm a fault at ``site``: the first ``after`` values observed by
    :func:`apply` pass through clean, then the next ``count`` (None = every
    subsequent one) are replaced by ``value`` (default NaN). Sites in use:

    - ``"host_async.window_loss"`` — each async worker's per-window mean
      loss, observed in the worker's bookkeeping (feeds the watchdog).
    """
    with _inj_lock:
        _injections[site] = _Injection(float(value), after, count)


def clear_injections(site: Optional[str] = None) -> None:
    """Disarm one site, or every site (``site=None``) — test teardown."""
    with _inj_lock:
        if site is None:
            _injections.clear()
        else:
            _injections.pop(site, None)


def apply(site: str, value: float) -> float:
    """Pass an observed value through the injection hook for ``site``.
    Returns the (possibly corrupted) value; identity when nothing is armed.
    Thread-safe: concurrent observers consume ``after``/``count`` budgets
    exactly once each."""
    inj = _injections.get(site)
    if inj is None:
        return value
    with _inj_lock:
        inj = _injections.get(site)
        if inj is None:
            return value
        if inj.skipped < inj.after:
            inj.skipped += 1
            return value
        if inj.count is not None and inj.fired >= inj.count:
            return value
        inj.fired += 1
    from distkeras_tpu_torch import telemetry

    telemetry.counter("fault.injected", site=site).inc()
    return inj.value


# -- socket-level chaos (elastic-fleet test surface) -------------------------

#: Actions a chaos site may be armed with. Semantics are implemented at
#: the call site (the site knows its socket); this module only meters.
#: "kill" is the strongest: the serving SERVICE dies (listener + every
#: connection — simulated process death), not just one connection.
#: "torn" is the weight-publish fault: the payload arrives structurally
#: valid but half-serialized (wrong leaf shapes) — the subscriber's swap
#: validation must refuse it atomically.
CHAOS_ACTIONS = ("drop", "delay", "reset", "reset_after_send", "kill",
                 "torn")


class ChaosAction:
    """One armed transport fault, returned by :func:`chaos` when it fires."""

    __slots__ = ("action", "delay_s")

    def __init__(self, action: str, delay_s: float):
        self.action = action
        self.delay_s = delay_s


class _ChaosInjection:
    __slots__ = ("action", "delay_s", "after", "count", "skipped", "fired",
                 "shard")

    def __init__(self, action: str, delay_s: float, after: int,
                 count: Optional[int], shard: Optional[int] = None):
        self.action = action
        self.delay_s = float(delay_s)
        self.after = int(after)
        self.count = count
        self.skipped = 0
        self.fired = 0
        self.shard = shard


_chaos: dict = {}


def inject_chaos(site: str, action: str, after: int = 0,
                 count: Optional[int] = 1, delay_s: float = 0.0,
                 shard: Optional[int] = None) -> None:
    """Arm a transport fault at ``site``: the first ``after`` passes through
    :func:`chaos` are clean, then the next ``count`` (default ONE — chaos
    faults are usually reset-once scripts; None = every subsequent one)
    return the armed action. ``shard=`` restricts the fault to call sites
    that identify as that shard (coordinator-kill drills arm
    ``shard=0``); passes from other shards neither fire nor consume the
    ``after``/``count`` budget. Sites (the JAX package's list; the
    port passes through the three its module docstring names):

    - ``"remote_ps.send"`` — client request egress
      (:meth:`RemoteParameterServer._roundtrip`): ``reset`` raises before
      the bytes leave (request lost), ``reset_after_send`` raises after
      (request applied server-side, reply lost — the dedup scenario),
      ``delay`` sleeps ``delay_s`` first, ``drop`` swallows the send so
      the reply wait hits the per-op timeout.
    - ``"remote_ps.server.handle"`` — server-side dispatch
      (:meth:`ParameterServerService._dispatch`): ``delay`` stalls the
      shard, ``reset`` closes the connection instead of replying,
      ``kill`` takes the whole service down (DESIGN.md §17's
      coordinator-death drill).
    - ``"rollout.publish"`` — the weight-publish path
      (``WeightPublisher.publish``, serving/rollout.py): ``drop`` loses
      the publish (serving keeps the incumbent), ``delay`` stalls the
      publisher ``delay_s``, ``torn`` delivers a half-serialized tree —
      engine swap validation must refuse it and keep serving the
      incumbent bit-for-bit (the swap-atomicity drill, DESIGN.md §18).
    - ``"kv.swap_in"`` — the prefix-cache page restore
      (``GenerationEngine._swap_in_entry``, serving/generation.py): ANY
      armed action models a torn/lost host-to-device page restore. The
      engine must evict the entry (a torn restore is never offered
      twice) and degrade that request to a cold prefill — slower, never
      a corrupted lane (DESIGN.md §19).
    - ``"data.lease"`` — data-coordinator dispatch
      (:meth:`DataCoordinator._dispatch`, data/service.py): ``delay``
      stalls the coordinator, ``reset`` drops the connection instead of
      replying (the client retries; ``(cid, seq)`` dedup absorbs an
      applied-but-unreplied lease/ack), ``kill`` takes the coordinator
      down — the torn-restart drill that must resume the shuffle cursor
      bitwise-deterministically (DESIGN.md §20).
    - ``"data.fetch"`` — data-client request egress
      (:meth:`DataServiceClient._send_once`): same action semantics as
      ``remote_ps.send`` (``reset`` before the bytes leave,
      ``reset_after_send`` after — the ack-dedup scenario, ``drop``
      swallows the request into a timeout, ``delay`` sleeps first).
    - ``"fleet.kv_handoff"`` — the cross-host prefill→decode KV page
      handoff (:meth:`FleetRouter._maybe_disaggregate`,
      serving/fleet.py): ANY armed action models a torn/lost handoff —
      the exported blobs never reach the decode replica. The router
      counts a ``fleet.handoff_failures`` and the request degrades to a
      cold prefill on the decode replica — slower, never a corrupted
      or half-installed cache entry (same rule as ``kv.swap_in``,
      DESIGN.md §22).
    """
    if action not in CHAOS_ACTIONS:
        raise ValueError(f"chaos action must be one of {CHAOS_ACTIONS}, "
                         f"got {action!r}")
    with _inj_lock:
        _chaos[site] = _ChaosInjection(action, delay_s, after, count,
                                       shard=shard)


def clear_chaos(site: Optional[str] = None) -> None:
    """Disarm one chaos site, or every site (``site=None``) — teardown."""
    with _inj_lock:
        if site is None:
            _chaos.clear()
        else:
            _chaos.pop(site, None)


def chaos(site: str, shard: Optional[int] = None) -> Optional[ChaosAction]:
    """Pass a transport control point through the chaos hook for ``site``.
    Returns the armed :class:`ChaosAction` when this pass fires, else None
    (always None when nothing is armed — the no-chaos fast path is one
    dict lookup). ``shard=`` identifies the caller for shard-filtered
    injections; a filter mismatch is a clean pass that consumes no
    budget. Thread-safe; budgets are consumed exactly once."""
    inj = _chaos.get(site)
    if inj is None:
        return None
    if inj.shard is not None and shard != inj.shard:
        return None
    with _inj_lock:
        inj = _chaos.get(site)
        if inj is None:
            return None
        if inj.shard is not None and shard != inj.shard:
            return None
        if inj.skipped < inj.after:
            inj.skipped += 1
            return None
        if inj.count is not None and inj.fired >= inj.count:
            return None
        inj.fired += 1
    from distkeras_tpu_torch import telemetry

    telemetry.counter("fault.chaos", site=site, action=inj.action).inc()
    return ChaosAction(inj.action, inj.delay_s)
