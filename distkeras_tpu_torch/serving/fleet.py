"""Routed serving fleet (port of ``distkeras_tpu/serving/fleet.py``): one
router tier over N engine replicas.

DESIGN.md §22. Every serving limit in §14/§19 says "single host" — one
``ServingEngine``/``GenerationEngine`` process is the whole fleet. This
module grows the predictor side of the paper's trainer → predictor →
evaluator loop (PAPER L6) to a pool: a :class:`FleetRouter` that spreads
requests over N replicas reachable through the existing serving wire,
reusing three proven planes instead of inventing new ones:

* **liveness** rides §13's lease-based :class:`Membership` — replicas
  register on attach, every successful reply renews the lease
  (``observe_commit``: a reply IS proof of life), and a lapsed lease
  evicts the replica from routing. A connection error evicts
  immediately and the failed request is **re-queued** onto another
  replica — safe because a replica that never sent its final frame
  never delivered anything (the router-stamped ``(cid, seq)`` pair
  rides the header, same dedup vocabulary as the PS/data planes).
* **load shedding** rides the §16 :class:`SloEngine`: the router
  publishes per-replica ``fleet.replica.queue_depth`` gauges and
  declares one burn-rate spec per replica; a replica whose depth burns
  through its budget is excluded from routing, and when NO replica is
  eligible the request fails with a typed :class:`FleetOverloaded` —
  never a silent drop.
* **prefix affinity**: the ``PrefixCache`` key is already a content
  hash, so the router keeps a bounded hash→replica map and routes
  prefix-sharing requests to the replica holding the warm pages —
  fleet-property cache hit rate instead of a per-process accident.
  Misses fall back to least-loaded by ``health_status()`` queue depth.

**Disaggregated prefill/decode**: replicas declare a role (``prefill``
/ ``decode`` / ``both``). When a request routes to a pure-``decode``
replica and a prefill-capable peer exists at the same model version,
the router runs the prompt through the prefill replica
(``max_new_tokens=1`` parks the prompt KV + last logits in its prefix
cache), ships the pages over the ``kv_export``/``kv_handoff`` wire ops
(§19's donation-based host-swap blobs — bitwise-lossless), and the
decode replica's generation becomes a full prefix hit: token-identical
to local prefill+decode (greedy, same weights). The handoff has a
``fleet.kv_handoff`` chaos site; a torn handoff degrades to cold
prefill on the decode replica — same rule as the torn swap-in.

Honest limits (also in DESIGN.md §22): the router is ONE process (it
is itself a single point of authority); roles are static declarations,
nothing rebalances a pool that was provisioned wrong; and the affinity map is hash-only
(no token verification — a collision mis-routes to a cold replica,
which costs a prefill, never correctness).

The port's router is JAX's, over the port's ``ServingClient``: both
routers hash a prompt to the same affinity key and route the same seeded
traffic alike, and either drives either package's servers (they speak
one wire). Its tallies move under the router lock (JAX bumps them
unlocked from every dispatch thread).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.comms.retry import RetryPolicy
from distkeras_tpu_torch.health.membership import DEFAULT_LEASE_S, Membership
from distkeras_tpu_torch.health.slo import SloEngine, SloSpec
from distkeras_tpu_torch.serving.server import ServingClient
from distkeras_tpu_torch.utils import fault

ROLES = ("prefill", "decode", "both")

#: the router's own (conservative) client retry: one reconnect attempt
#: per replica — anything longer belongs to the router's re-queue loop,
#: which can move the request to a DIFFERENT replica instead of waiting
ROUTER_CLIENT_RETRY = RetryPolicy(max_retries=1, base_s=0.02, max_s=0.1)


class FleetOverloaded(RuntimeError):
    """Every eligible replica is shedding — the request was refused at
    admission, not silently dropped. Callers back off and retry."""


class _Replica:
    """Router-side handle for one attached replica."""

    def __init__(self, rid: int, address: str, role: str,
                 client: ServingClient):
        self.rid = rid
        self.address = address
        self.role = role
        self.client = client
        self.dead = False
        self.inflight = 0          # router-side dispatched-not-finished
        self.queue_depth = 0.0     # from the last status poll
        self.model_version = -1
        self.status_time = 0.0     # when the last poll landed

    def decode_capable(self) -> bool:
        return self.role in ("decode", "both")

    def prefill_capable(self) -> bool:
        return self.role in ("prefill", "both")


class FleetRouter:
    """Spread ``generate``/``infer`` over N serving replicas.

    Thread-safe: callers on many threads dispatch concurrently; the
    router lock covers only its own tables (never a socket — each
    replica's :class:`ServingClient` has its own connection lock).

    ``shed_queue_depth``: per-replica decode queue depth above which the
    SLO spec starts burning (op ``<=`` threshold); ``shed_window_s`` /
    ``shed_budget_frac`` are the burn-rate budget — a single hot poll
    does not shed, sustained depth does. ``routing``: ``"affinity"``
    (default) or ``"random"`` — the seeded control leg the fleet probe
    measures the affinity win against. ``affinity_capacity=0`` disables
    the map entirely (every request routes least-loaded).
    """

    def __init__(self, token: Optional[str] = None,
                 lease_s: float = DEFAULT_LEASE_S,
                 affinity_capacity: int = 4096,
                 shed_queue_depth: float = 64.0,
                 shed_window_s: float = 2.0,
                 shed_budget_frac: float = 0.5,
                 routing: str = "affinity",
                 status_ttl_s: float = 0.25,
                 client_retry: Optional[RetryPolicy] = ROUTER_CLIENT_RETRY,
                 client_timeout: float = 60.0,
                 disaggregate: bool = True,
                 seed: int = 0,
                 time_fn: Callable[[], float] = time.time):
        if routing not in ("affinity", "random"):
            raise ValueError(f"routing must be 'affinity' or 'random', "
                             f"got {routing!r}")
        self.token = token
        self.routing = routing
        self.affinity_capacity = int(affinity_capacity)
        self.shed_queue_depth = float(shed_queue_depth)
        self._shed_window_s = float(shed_window_s)
        self._shed_budget_frac = float(shed_budget_frac)
        self._status_ttl_s = float(status_ttl_s)
        self._client_retry = client_retry
        self._client_timeout = float(client_timeout)
        self._disaggregate = bool(disaggregate)
        self._time = time_fn
        self._rng = random.Random(seed)
        self._lock = threading.RLock()
        self._replicas: Dict[int, _Replica] = {}
        self._next_rid = 0
        self._cid = self._rng.getrandbits(32)  # router identity for (cid,seq)
        self._seq = 0
        self.membership = Membership(lease_s=lease_s, time_fn=time_fn)
        self._slo: Optional[SloEngine] = None
        # affinity: (prefix_len, hash(prefix)) -> rid, LRU by insertion
        # order (dict preserves it; move-to-end on hit), plus the set of
        # lengths present so lookups walk longest-first like PrefixCache
        self._affinity: Dict[tuple, int] = {}
        self._affinity_lens: Dict[int, int] = {}
        # local tallies mirrored into telemetry (the digest reads these —
        # label-set counters are write-only from here)
        self._n = {"requests": 0, "sheds": 0, "requeued": 0, "handoffs": 0,
                   "handoff_failures": 0, "evictions": 0,
                   "affinity_hits": 0, "affinity_misses": 0}
        self._counters = {
            "requests": telemetry.counter("fleet.requests"),
            "sheds": telemetry.counter("fleet.sheds"),
            "requeued": telemetry.counter("fleet.requeued"),
            "handoffs": telemetry.counter("fleet.handoffs"),
            "handoff_failures": telemetry.counter("fleet.handoff_failures"),
            "evictions": telemetry.counter("fleet.evictions"),
            "affinity_hits": telemetry.counter("fleet.affinity.hits"),
            "affinity_misses": telemetry.counter("fleet.affinity.misses"),
        }
        # forensic record: postmortem bundles carry the routing
        # table / version skew / shed tallies the moment the run died.
        # Duck-typed like set_roofline — the recorder polls the digest at
        # bundle time, this module never imports recorder machinery.
        rec = telemetry.get_recorder()
        if rec is not None and hasattr(rec, "set_digest_source"):
            rec.set_digest_source("fleet", self.status_digest)

    def _tally(self, key: str) -> None:
        """One more of ``key`` in the digest's tallies and its counter."""
        with self._lock:
            self._n[key] += 1
        self._counters[key].inc()

    def _inflight(self, rep: "_Replica", n: int) -> None:
        with self._lock:
            rep.inflight += n

    # -- replica pool ------------------------------------------------------

    def add_replica(self, address: str, role: str = "both") -> int:
        """Attach one serving replica (``host:port``). Returns the
        replica id the router will route/evict/re-admit it under."""
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        client = ServingClient(address, token=self.token,
                               timeout=self._client_timeout,
                               retry=self._client_retry)
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._replicas[rid] = _Replica(rid, address, role, client)
            self.membership.register(rid)
            self._rebuild_slo_locked()
        self._poll(self._replicas[rid], force=True)
        self._refresh_gauges()
        telemetry.record_event("fleet", transition="attach", replica=rid,
                               address=address, role=role)
        return rid

    def remove_replica(self, rid: int) -> None:
        """Clean detach (no eviction recorded)."""
        with self._lock:
            rep = self._replicas.pop(int(rid), None)
            self.membership.deregister(int(rid))
            self._drop_affinity_locked(int(rid))
            self._rebuild_slo_locked()
        if rep is not None:
            rep.dead = True
            rep.client.close()
        self._refresh_gauges()

    def _rebuild_slo_locked(self) -> None:
        """One burn-rate spec per attached replica. Rebuilding resets the
        verdict windows — acceptable: attach/detach is rare, shedding
        state re-converges within ``shed_window_s``."""
        specs = [
            SloSpec(name=f"fleet-replica-{rid}-depth",
                    metric="fleet.replica.queue_depth",
                    threshold=self.shed_queue_depth, op="<=",
                    labels={"replica": str(rid)},
                    window_s=self._shed_window_s,
                    budget_frac=self._shed_budget_frac,
                    severity="shed")
            for rid in self._replicas
        ]
        self._slo = SloEngine(specs, clock=self._time) if specs else None

    def _evict(self, rep: _Replica, reason: str) -> None:
        """A replica stopped answering (connection error) or its lease
        lapsed: stop routing to it, drop its affinity entries. Its
        in-flight requests re-queue from the dispatch loop."""
        with self._lock:
            if rep.dead:
                return
            rep.dead = True
            self.membership.deregister(rep.rid)
            self._drop_affinity_locked(rep.rid)
        self._tally("evictions")
        rep.client.close()
        telemetry.record_event("fleet", transition="evict",
                               replica=rep.rid, reason=reason)
        self._refresh_gauges()

    def _sweep(self) -> None:
        """Lease-lapse eviction: replicas whose status polls stopped
        landing (every successful reply renews via observe_commit)."""
        for rid in self.membership.sweep():
            rep = self._replicas.get(rid)
            if rep is not None:
                self._evict(rep, "lease")

    # -- status / load -----------------------------------------------------

    def _poll(self, rep: _Replica, force: bool = False) -> None:
        """Refresh one replica's load signal (bounded by status_ttl_s so
        a dispatch storm does not turn into a status storm)."""
        now = self._time()
        if rep.dead or (not force and now - rep.status_time
                        < self._status_ttl_s):
            return
        try:
            st = rep.client.status()
        except (ConnectionError, OSError, RuntimeError):
            return  # the lease keeps ticking; a lapse evicts
        rep.status_time = now
        decode = st.get("decode") or {}
        rep.queue_depth = float(decode.get("queue_depth",
                                           st.get("queue_depth", 0)))
        rep.model_version = int(decode.get("model_version",
                                           st.get("model_version", -1)))
        self.membership.observe_commit(rep.rid)  # a reply IS proof of life
        telemetry.gauge("fleet.replica.queue_depth",
                        replica=str(rep.rid)).set(rep.queue_depth)

    def _shed_set(self) -> set:
        """Replica ids currently excluded by their burn-rate spec."""
        with self._lock:
            slo = self._slo
        if slo is None:
            return set()
        slo.evaluate_once(now=self._time())
        out = set()
        for alert in slo.active_alerts():
            name = alert.get("slo", "")
            if name.startswith("fleet-replica-") and name.endswith("-depth"):
                out.add(int(name[len("fleet-replica-"):-len("-depth")]))
        return out

    def _eligible(self, want_decode: bool = True) -> list:
        self._sweep()
        with self._lock:
            reps = [r for r in self._replicas.values() if not r.dead
                    and (r.decode_capable() if want_decode
                         else r.prefill_capable())]
        for rep in reps:
            self._poll(rep)
        shed = self._shed_set()
        return [r for r in reps if r.rid not in shed]

    # -- prefix affinity ---------------------------------------------------

    @staticmethod
    def _affinity_key(tokens: tuple) -> tuple:
        # same shape as PrefixCache._key: content hash + length. The map
        # stores no tokens — a hash collision mis-routes (costs one cold
        # prefill at the replica), it can never corrupt a result.
        return (len(tokens), hash(tokens))

    def _affinity_lookup(self, tokens: tuple) -> Optional[int]:
        """Longest recorded prefix of ``tokens`` → replica id."""
        with self._lock:
            if not self._affinity:
                return None
            lens = sorted((l for l in self._affinity_lens
                           if l <= len(tokens)), reverse=True)
            for l in lens:
                key = self._affinity_key(tokens[:l])
                rid = self._affinity.get(key)
                if rid is not None:
                    # LRU refresh
                    self._affinity.pop(key)
                    self._affinity[key] = rid
                    return rid
        return None

    def _affinity_record(self, tokens: tuple, rid: int) -> None:
        if self.affinity_capacity <= 0:
            return
        key = self._affinity_key(tokens)
        with self._lock:
            if key in self._affinity:
                self._affinity.pop(key)
            else:
                self._affinity_lens[key[0]] = \
                    self._affinity_lens.get(key[0], 0) + 1
            self._affinity[key] = rid
            while len(self._affinity) > self.affinity_capacity:
                old_key = next(iter(self._affinity))
                self._affinity.pop(old_key)
                n = self._affinity_lens.get(old_key[0], 1) - 1
                if n <= 0:
                    self._affinity_lens.pop(old_key[0], None)
                else:
                    self._affinity_lens[old_key[0]] = n

    def _drop_affinity_locked(self, rid: int) -> None:
        stale = [k for k, v in self._affinity.items() if v == rid]
        for k in stale:
            self._affinity.pop(k)
            n = self._affinity_lens.get(k[0], 1) - 1
            if n <= 0:
                self._affinity_lens.pop(k[0], None)
            else:
                self._affinity_lens[k[0]] = n

    # -- routing -----------------------------------------------------------

    def _pick(self, tokens: Optional[tuple]) -> _Replica:
        """One routing decision. Raises :class:`FleetOverloaded` when no
        decode-capable replica survives liveness + shedding."""
        eligible = self._eligible(want_decode=True)
        if not eligible:
            self._tally("sheds")
            raise FleetOverloaded(
                "no eligible replica: all dead, evicted, or shedding "
                f"(queue depth budget {self.shed_queue_depth})")
        if self.routing == "affinity" and tokens is not None \
                and self.affinity_capacity > 0:
            rid = self._affinity_lookup(tokens)
            by_id = {r.rid: r for r in eligible}
            if rid is not None and rid in by_id:
                self._tally("affinity_hits")
                return by_id[rid]
            self._tally("affinity_misses")
        elif self.routing == "random":
            return self._rng.choice(eligible)
        # least-loaded fallback: polled queue depth + our own in-flight
        return min(eligible,
                   key=lambda r: (r.queue_depth + r.inflight, r.rid))

    # -- disaggregated prefill → decode handoff ----------------------------

    def _maybe_disaggregate(self, target: _Replica, prompt: np.ndarray,
                            timeout_ms: Optional[float]) -> None:
        """When the chosen decode replica is prefill-light, run the
        prompt through a prefill replica and ship the parked KV pages
        over. Every failure mode — no prefill peer, version skew, torn
        handoff (chaos), refused install — degrades to cold prefill on
        ``target``; this method never raises."""
        if not self._disaggregate or target.role != "decode":
            return
        prefillers = [r for r in self._eligible(want_decode=False)
                      if r.rid != target.rid]
        if not prefillers:
            return
        src = min(prefillers,
                  key=lambda r: (r.queue_depth + r.inflight, r.rid))
        if src.model_version != target.model_version:
            # skewed weights would make the shipped KV wrong, not slow —
            # refuse and let the decode replica prefill at ITS version
            self._tally("handoff_failures")
            return
        try:
            self._inflight(src, 1)
            # max_new_tokens=1: the cheapest generation that parks the
            # prompt KV + last logits in src's prefix cache (§19 capture)
            src.client.generate(prompt, max_new_tokens=1,
                                timeout_ms=timeout_ms)
            export_header, export_blobs = src.client.kv_export(prompt)
            if not export_header.get("found"):
                self._tally("handoff_failures")
                return
            if fault.chaos("fleet.kv_handoff") is not None:
                # torn handoff: the blobs are considered lost in flight;
                # same degradation rule as the torn swap-in (§19)
                self._tally("handoff_failures")
                return
            ok = target.client.kv_handoff(prompt, export_header,
                                          export_blobs)
        except (ConnectionError, OSError):
            self._evict(src, "connection")
            self._tally("handoff_failures")
            return
        except RuntimeError as e:
            # only a dead prefill replica gets evicted; any other typed
            # error just forfeits the handoff (cold prefill on target)
            if str(e).startswith("serving (closed)"):
                self._evict(src, "closed")
            self._tally("handoff_failures")
            return
        finally:
            self._inflight(src, -1)
        if ok:
            self._tally("handoffs")
        else:
            self._tally("handoff_failures")

    # -- request paths -----------------------------------------------------

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 eos_id: Optional[int] = None, on_token=None):
        """Route one generation; returns the replica's final
        :class:`GenerationResult`. A replica dying mid-request re-queues
        the request onto another replica (at-most-once delivery holds:
        a replica that never sent its final frame delivered nothing);
        :class:`FleetOverloaded` when the whole fleet is shedding."""
        p = np.ascontiguousarray(np.asarray(prompt, np.int32).reshape(-1))
        tokens = tuple(int(t) for t in p)
        self._tally("requests")
        with self._lock:
            self._seq += 1
        last_err: Optional[Exception] = None
        # one attempt per currently-attached replica, plus one: every
        # failed attempt evicts its replica, so the loop strictly shrinks
        # the pool — it cannot spin
        for _ in range(len(self._replicas) + 1):
            rep = self._pick(tokens)
            self._maybe_disaggregate(rep, p, timeout_ms)
            try:
                self._inflight(rep, 1)
                res = rep.client.generate(
                    p, max_new_tokens=max_new_tokens,
                    timeout_ms=timeout_ms, eos_id=eos_id,
                    on_token=on_token)
            except (ConnectionError, OSError) as e:
                self._evict(rep, "connection")
                self._tally("requeued")
                last_err = e
                continue
            except RuntimeError as e:
                # a killed replica's handler threads outlive its engine:
                # they answer with the typed "closed" frame before the
                # socket dies — the same death, seen one layer higher.
                # Anything else (bad_request, deadline) is the caller's
                # error: surface it, never re-queue it
                if not str(e).startswith("serving (closed)"):
                    raise
                self._evict(rep, "closed")
                self._tally("requeued")
                last_err = e
                continue
            finally:
                self._inflight(rep, -1)
            if self.routing == "affinity":
                self._affinity_record(tokens, rep.rid)
            self.membership.observe_commit(rep.rid)
            return res
        raise FleetOverloaded(
            f"request re-queued past every replica; last error: "
            f"{last_err!r}")

    def infer(self, rows, timeout_ms: Optional[float] = None) -> np.ndarray:
        """Route one-shot inference rows to the least-loaded replica
        (same eviction + re-queue rules as :meth:`generate`)."""
        self._tally("requests")
        last_err: Optional[Exception] = None
        for _ in range(len(self._replicas) + 1):
            rep = self._pick(None)
            try:
                self._inflight(rep, 1)
                return rep.client.infer(rows, timeout_ms=timeout_ms)
            except (ConnectionError, OSError) as e:
                self._evict(rep, "connection")
                self._tally("requeued")
                last_err = e
                continue
            except RuntimeError as e:
                if not str(e).startswith("serving (closed)"):
                    raise
                self._evict(rep, "closed")
                self._tally("requeued")
                last_err = e
                continue
            finally:
                self._inflight(rep, -1)
        raise FleetOverloaded(
            f"request re-queued past every replica; last error: "
            f"{last_err!r}")

    # -- fleet-wide weight pushes -----------------------------------------

    def push_weights(self, params, version: int,
                     target: str = "generation") -> dict:
        """Push one published version to every live replica (each rides
        its own rollout rails when mounted). Returns per-replica
        outcomes; failures evict the replica but do not abort the push —
        the skew gauge reports the resulting spread."""
        out = {}
        for rep in list(self._replicas.values()):
            if rep.dead:
                continue
            try:
                out[rep.rid] = rep.client.put_weights(params, version,
                                                      target=target)
                self.membership.observe_commit(rep.rid)
            except (ConnectionError, OSError, RuntimeError) as e:
                self._evict(rep, "push-error")
                out[rep.rid] = {"ok": False, "error": str(e)}
            self._poll(rep, force=True)
        self._refresh_gauges()
        return out

    # -- introspection -----------------------------------------------------

    def _refresh_gauges(self) -> None:
        with self._lock:
            live = [r for r in self._replicas.values() if not r.dead]
            versions = sorted({r.model_version for r in live
                               if r.model_version >= 0})
            skew = (versions[-1] - versions[0]) if len(versions) > 1 else 0
            for role in ROLES:
                telemetry.gauge("fleet.replicas", role=role).set(
                    sum(1 for r in live if r.role == role))
            telemetry.gauge("fleet.version_skew").set(skew)
            telemetry.gauge("fleet.affinity.entries").set(
                len(self._affinity))
            hits, misses = self._n["affinity_hits"], \
                self._n["affinity_misses"]
            telemetry.gauge("fleet.affinity.hit_rate").set(
                hits / (hits + misses) if hits + misses else 0.0)

    def status_digest(self) -> dict:
        """The FLEET view for the health plane (``health.cli watch``
        renders it): replicas, roles, load, sheds/handoffs, skew."""
        self._sweep()
        self._refresh_gauges()
        with self._lock:
            live = [r for r in self._replicas.values() if not r.dead]
            versions = sorted({r.model_version for r in live
                               if r.model_version >= 0})
            hits, misses = self._n["affinity_hits"], \
                self._n["affinity_misses"]
            return {
                "replicas": {
                    str(r.rid): {
                        "address": r.address,
                        "role": r.role,
                        "queue_depth": r.queue_depth,
                        "inflight": r.inflight,
                        "model_version": r.model_version,
                    } for r in live
                },
                "roles": {role: sum(1 for r in live if r.role == role)
                          for role in ROLES},
                "routing": self.routing,
                "version_skew": ((versions[-1] - versions[0])
                                 if len(versions) > 1 else 0),
                "sheds": self._n["sheds"],
                "requeued": self._n["requeued"],
                "evictions": self._n["evictions"],
                "handoffs": self._n["handoffs"],
                "handoff_failures": self._n["handoff_failures"],
                "requests": self._n["requests"],
                "affinity": {
                    "entries": len(self._affinity),
                    "capacity": self.affinity_capacity,
                    "hits": hits,
                    "misses": misses,
                    "hit_rate": (hits / (hits + misses)
                                 if hits + misses else 0.0),
                },
                "membership": self.membership.status(),
            }

    def close(self) -> None:
        rec = telemetry.get_recorder()
        if rec is not None and hasattr(rec, "set_digest_source"):
            rec.set_digest_source("fleet", None)
        with self._lock:
            reps = list(self._replicas.values())
            self._replicas.clear()
        for rep in reps:
            rep.dead = True
            rep.client.close()
