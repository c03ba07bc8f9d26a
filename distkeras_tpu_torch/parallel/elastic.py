"""Sharded parameter-server fleet: split the center, survive the churn
(port of ``distkeras_tpu/parallel/elastic.py``).

DESIGN.md §6 called the single ParameterServerService the honest
limitation of the cross-process path: one process, one socket, the whole
center tree through one NIC. This module removes it (DESIGN.md §13):

- :func:`shard_assignment` splits the center's LEAVES over N shards with
  a deterministic size-balanced greedy packing — every process computes
  the identical map from its own (identically-initialized) params, so the
  map never travels;
- each shard is an ordinary :class:`ParameterServerService` over an
  ordinary ParameterServer holding just its leaf subset (a python list of
  leaves is a tree — the codec/chunking/auth stack is reused unchanged,
  and N=1 is wire-identical to the single-server protocol);
- :class:`ShardedRemoteParameterServer` fans pull/commit out in parallel
  and reassembles, presenting the same ParameterServer interface, so
  HostAsyncRunner cannot tell a fleet from a single server.

Consistency model (the paper's, made explicit): shard 0 is the
**coordinator** — its clock is the authority a pull reports and the
membership/lease/history plane lives there. A logical commit folds on
the coordinator FIRST; the coordinator's reply carries the applied fold
weight, and every follower shard folds the same commit with that exact
explicit weight — so a DynSGD fold scales identically on all shards even
though their local clocks never talk to each other. A pull reads shards
concurrently and may observe a commit on one shard before another (a
torn read); under ASYNCHRONOUS SGD that is one more staleness
perturbation of the same kind the algorithm already absorbs, and it
vanishes at the quiescent points where equality matters (history
barrier, final center).
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.health.heartbeat import StragglerDetector
from distkeras_tpu_torch.health.membership import DEFAULT_LEASE_S, Membership
from distkeras_tpu_torch.parallel import failover
from distkeras_tpu_torch.parallel.remote_ps import (
    CoordinatorFenced,
    ParameterServerService,
    PSUnavailable,
    RemoteParameterServer,
)
from distkeras_tpu_torch.utils.transfer import to_host
from distkeras_tpu_torch.utils.trees import tree_flatten, tree_unflatten

#: shard→process placement policies (DESIGN.md §17): "process0" is the
#: historical layout (every shard on process 0's host — fan-out buys
#: socket/codec/fold parallelism, not NIC aggregation); "spread" deals
#: shards round-robin over processes so the fleet aggregates NICs and
#: survives single-host loss.
PLACEMENT_POLICIES = ("process0", "spread")


def shard_placement(num_shards: int, num_processes: int,
                    policy: str = "process0") -> list:
    """Deterministic shard→hosting-process map; every process computes
    the identical map from the same (num_shards, num_processes, policy),
    so the map itself never travels — only the resulting addresses do.
    "spread" degenerates to all-on-0 at one process."""
    if policy not in PLACEMENT_POLICIES:
        raise ValueError(f"ps_placement must be one of "
                         f"{PLACEMENT_POLICIES}, got {policy!r}")
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if policy == "process0" or int(num_processes) <= 1:
        return [0] * num_shards
    return [s % int(num_processes) for s in range(num_shards)]


def standby_process(placement: Sequence[int]) -> int:
    """Which process hosts the coordinator's standby: shard 1's process —
    a DIFFERENT host than the coordinator whenever the placement spreads
    over >1 process, so the standby survives the coordinator's host
    dying. Single-shard (or process0) fleets fall back to the
    coordinator's own process: the standby then still survives service
    death, just not host death."""
    placement = list(placement)
    return placement[1] if len(placement) > 1 else placement[0]


def shard_assignment(like: Any, num_shards: int) -> list:
    """Deterministic size-balanced leaf→shard map: greedy longest-
    processing-time packing (leaves by descending byte size, each to the
    currently lightest shard; all ties broken by index, so every process
    computes the same map). Returns ``num_shards`` sorted index lists.
    """
    leaves = tree_flatten(like)[0]
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_shards > len(leaves):
        raise ValueError(
            f"cannot split {len(leaves)} leaves over {num_shards} shards "
            f"(a shard would hold no parameters)")
    sizes = [int(np.prod(np.shape(l))) * _itemsize(l) for l in leaves]
    order = sorted(range(len(leaves)), key=lambda i: (-sizes[i], i))
    loads = [0] * num_shards
    shards: list = [[] for _ in range(num_shards)]
    for i in order:
        s = min(range(num_shards), key=lambda j: (loads[j], j))
        shards[s].append(i)
        loads[s] += sizes[i]
    return [sorted(s) for s in shards]


def _itemsize(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.dtype(getattr(leaf, "dtype", np.float32)).itemsize


def split_tree(tree: Any, assignment: Sequence[Sequence[int]]) -> list:
    """The tree's leaves regrouped per shard (each group is itself a
    tree — a python list — so the per-shard codec stack is unchanged)."""
    leaves = tree_flatten(tree)[0]
    return [[leaves[i] for i in idxs] for idxs in assignment]


def join_tree(parts: Sequence[Sequence], assignment, treedef) -> Any:
    """Inverse of :func:`split_tree`: reassemble the full tree."""
    leaves: list = [None] * sum(len(idxs) for idxs in assignment)
    for part, idxs in zip(parts, assignment):
        for leaf, i in zip(part, idxs):
            leaves[i] = leaf
    return tree_unflatten(treedef, leaves)


def make_ps_fleet(ps_factory: Callable[[Any], Any], like: Any,
                  num_shards: int, expected_processes: int = 1,
                  host: str = "0.0.0.0", token: Optional[str] = None,
                  codecs: Optional[Sequence[str]] = None,
                  advertise_host: str = "127.0.0.1",
                  lease_s: float = DEFAULT_LEASE_S,
                  straggler: Optional[StragglerDetector] = None,
                  time_fn: Callable[[], float] = time.time,
                  local_shards: Optional[Sequence[int]] = None,
                  standby: bool = False,
                  coord_lease_s: float = failover.DEFAULT_COORD_LEASE_S,
                  start: bool = True) -> list:
    """Construct (and by default wire + start) shard services on this host.

    ``ps_factory`` builds the server flavor for one shard's leaf list
    (e.g. ``DynSGDParameterServer``). Shard 0 gets the membership plane
    (leases + straggler-driven eviction); followers hold only leaves.

    ``local_shards`` selects WHICH shards this process hosts (None = all
    of them — the single-host fleet). With a partial set the services
    come back bound-but-unstarted regardless of ``start``: the launcher
    must gather the cross-host address map first and finish via
    :func:`connect_fleet` (``run_cross_process``'s spread placement).

    ``standby=True`` appends a DARK standby service (LAST in the returned
    list, so ``services[0]`` stays the coordinator when it is local and
    blanket ``stop()`` loops keep working): a full service over a
    shard-0 replica built by the same factory, serving only the
    replication/discovery/health plane until its
    :class:`~distkeras_tpu_torch.parallel.failover.StandbyState` promotes.
    """
    assignment = shard_assignment(like, num_shards)
    parts = split_tree(like, assignment)
    which = list(range(num_shards)) if local_shards is None \
        else sorted(int(s) for s in local_shards)
    services = []
    for shard in which:
        part = parts[shard]
        membership = Membership(lease_s=lease_s, straggler=straggler,
                                time_fn=time_fn) if shard == 0 else None
        svc = ParameterServerService(
            ps_factory(part), part, expected_processes=expected_processes,
            host=host, token=token, codecs=codecs, membership=membership,
            shard=shard, num_shards=num_shards)
        svc.advertised = f"{advertise_host}:{svc.port}"
        services.append(svc)
    if standby:
        # the standby replicates the COORDINATOR: same shard-0 leaf
        # subset, same server flavor (same start clock via the factory),
        # so replayed folds land on a bit-identical replica
        svc = ParameterServerService(
            ps_factory(parts[0]), parts[0],
            expected_processes=expected_processes, host=host,
            token=token, codecs=codecs, membership=None, shard=0,
            num_shards=num_shards)
        svc.advertised = f"{advertise_host}:{svc.port}"
        svc.is_standby = True
        svc.standby = failover.StandbyState(
            svc, lease_s=coord_lease_s, member_lease_s=lease_s,
            straggler=straggler, time_fn=time_fn)
        services.append(svc)
    if start and local_shards is None:
        addresses = [svc.advertised for svc in services
                     if not svc.is_standby]
        standby_addr = next((svc.advertised for svc in services
                             if svc.is_standby), None)
        connect_fleet(services, addresses, standby_address=standby_addr,
                      token=token, coord_lease_s=coord_lease_s,
                      time_fn=time_fn)
    return services


def connect_fleet(services: Sequence, addresses: Sequence[str],
                  standby_address: Optional[str] = None, *,
                  token: Optional[str] = None,
                  coord_lease_s: float = failover.DEFAULT_COORD_LEASE_S,
                  time_fn: Callable[[], float] = time.time) -> None:
    """Wire this process's (possibly partial) services into one fleet and
    start them: every service learns the full shard map + standby
    address, and a locally-hosted coordinator gets its
    :class:`~distkeras_tpu_torch.parallel.failover.Replicator` streaming
    clock/membership/commits to the standby."""
    addresses = list(addresses)
    for svc in services:
        svc.shard_addresses = addresses
        svc.standby_address = standby_address
        svc.start()
    if standby_address is None:
        return
    for svc in services:
        if svc.shard == 0 and not svc.is_standby:
            rep = failover.Replicator(
                standby_address, token=token, lease_s=coord_lease_s,
                members_fn=(svc.membership.export
                            if svc.membership is not None else None),
                clock_fn=lambda s=svc: int(s.ps.num_updates),
                on_fenced=lambda epoch, s=svc: s.fence(epoch),
                time_fn=time_fn)
            svc.replicator = rep
            rep.start()


def gather_fleet_addresses(services: Sequence, num_shards: int) -> tuple:
    """All-gather every process's locally-hosted shard addresses into the
    complete fleet map. Returns ``(addresses, standby_address)``,
    identical on every process. In one process: a local reshuffle, no
    collective. The payload is the JAX package's (512 bytes a process of
    ``key=host:port`` entries joined by ``;``)."""
    from distkeras_tpu_torch.parallel import distributed

    local = {("standby" if svc.is_standby else int(svc.shard)):
             svc.advertised for svc in services}
    if distributed.process_count() == 1:
        missing = [s for s in range(num_shards) if s not in local]
        if missing:
            raise RuntimeError(f"fleet address gather incomplete: shards "
                               f"{missing} unhosted (map: {local})")
        return ([local[s] for s in range(num_shards)],
                local.get("standby"))
    msg = ";".join(f"{k}={v}" for k, v in sorted(
        local.items(), key=lambda kv: str(kv[0])))
    payload = distributed.encode_payload(msg)
    merged: dict = {}
    for row in distributed.process_allgather(payload):
        for entry in filter(None, distributed.decode_payload(row).split(";")):
            key, _, addr = entry.partition("=")
            merged[key] = addr
    missing = [s for s in range(num_shards) if str(s) not in merged]
    if missing:
        raise RuntimeError(f"fleet address gather incomplete: shards "
                           f"{missing} unhosted (map: {merged})")
    return ([merged[str(s)] for s in range(num_shards)],
            merged.get("standby"))


class ShardedRemoteParameterServer:
    """Client for a shard fleet — a drop-in for the ParameterServer
    interface, exactly like :class:`RemoteParameterServer` is for one
    server (which is also what this degenerates to at N=1, one object
    deep).

    Pulls and follower commits fan out on a small thread pool; commit
    identity (one ``(cid, seq)`` per LOGICAL commit, shared by all its
    shard legs and all their retries) comes from the coordinator client,
    so a retried multi-shard commit dedups per shard and folds once
    everywhere.
    """

    elastic = True

    def __init__(self, addresses: Sequence[str], like: Any,
                 timeout: float = 600.0, token: Optional[str] = None,
                 codec: str = "raw", retry=None,
                 op_timeout: Optional[float] = None,
                 standby: Optional[str] = None):
        addresses = list(addresses)
        if not addresses:
            raise ValueError("need at least one shard address")
        self.assignment = shard_assignment(like, len(addresses))
        host_tree = to_host(like)
        self._treedef = tree_flatten(host_tree)[1]
        parts = split_tree(host_tree, self.assignment)
        self.clients = [
            RemoteParameterServer(addr, part, timeout=timeout, token=token,
                                  codec=codec, retry=retry,
                                  op_timeout=op_timeout)
            for addr, part in zip(addresses, parts)]
        for client in self.clients[1:]:
            client.cid = self.clients[0].cid  # one commit identity
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(4, 2 * len(self.clients)),
            thread_name_prefix="ps-shard")
        # coordinator failover (DESIGN.md §17): the standby's address and
        # everything needed to rebuild the coordinator leg against it
        self.standby_address = standby
        self.coord_epoch = 0
        self._parts = parts
        self._client_kw = dict(timeout=timeout, token=token, codec=codec,
                               retry=retry, op_timeout=op_timeout)
        self._failover_lock = threading.Lock()

    @property
    def coordinator(self) -> RemoteParameterServer:
        return self.clients[0]

    # -- coordinator re-resolution (DESIGN.md §17) -------------------------
    def _coord_call(self, fn):
        """Run a coordinator-leg operation; on a dead or fenced
        coordinator, re-resolve through the standby and retry ONCE. The
        original typed error propagates when re-resolution fails (or no
        standby is configured) — the host_async degradation ladder then
        takes over exactly as before failover existed."""
        client = self.clients[0]
        try:
            return fn(client)
        except (PSUnavailable, CoordinatorFenced) as e:
            if not self._re_resolve(client, e):
                raise
        return fn(self.clients[0])

    def _re_resolve(self, failed, err) -> bool:
        if self.standby_address is None:
            return False
        with self._failover_lock:
            if self.clients[0] is not failed:
                return True  # another thread already swapped the leg
            # a fenced reply names the promoted coordinator outright;
            # otherwise ask the standby (whose lease check IS the
            # failure detector — it promotes while answering)
            addr = getattr(err, "coordinator", None) or \
                self.standby_address
            fresh = None
            try:
                fresh = RemoteParameterServer(addr, self._parts[0],
                                              **self._client_kw)
                view = fresh.coordinator_view()
            except (PSUnavailable, RuntimeError, OSError):
                if fresh is not None:
                    fresh.close()
                return False
            if not view.get("promoted") or \
                    int(view.get("epoch", 0)) <= self.coord_epoch:
                # the lease has not lapsed yet (coordinator slow, not
                # dead) — keep degrading; a later window retries here
                fresh.close()
                return False
            old = self.clients[0]
            # commit identity continuity: the promoted coordinator's
            # replicated dedup mirror is keyed by the ORIGINAL (cid, seq)
            # stream, so the new leg keeps both
            fresh.cid = old.cid
            with old._seq_lock:
                fresh._seq = old._seq
            self.clients[0] = fresh
            self.coord_epoch = int(view["epoch"])
            old.close()
            telemetry.counter("elastic.failover.resolves").inc()
            telemetry.record_event("failover", transition="re_resolve",
                                   address=view.get("address", addr),
                                   epoch=self.coord_epoch)
            return True

    # -- ParameterServer interface ----------------------------------------
    def pull(self):
        futures = [self._pool.submit(self._coord_call,
                                     lambda c: c.pull())]
        futures += [self._pool.submit(c.pull) for c in self.clients[1:]]
        results = [f.result() for f in futures]
        # clock authority is the coordinator; follower clocks only order
        # their own folds (see the torn-read note in the module docstring)
        return (join_tree([r[0] for r in results], self.assignment,
                          self._treedef), results[0][1])

    def commit(self, delta: Any, last_update: int = 0, **kw) -> int:
        return self.commit_ex(delta, last_update=last_update, **kw)[0]

    def commit_ex(self, delta: Any, last_update: int = 0, weight=None,
                  seq: Optional[int] = None, worker: Optional[int] = None,
                  window_s: Optional[float] = None) -> tuple:
        parts = split_tree(delta, self.assignment)
        if seq is None:
            seq = self.clients[0].next_seq()
        # the fan-out is the trace's branching point: the caller's commit
        # span is the parent, each shard leg a child. Pool threads do not
        # inherit thread-local context, so follower legs adopt it
        # explicitly (None when the commit is untraced — plain path).
        ctx = telemetry.current_trace()
        # coordinator first: its fold fixes the authoritative weight (and
        # runs the membership plane — late folds, lease renewal); every
        # follower then folds the same commit at that explicit weight
        with telemetry.span("trace.shard", shard=0):
            at_fold, applied = self._coord_call(
                lambda c: c.commit_ex(
                    parts[0], last_update=last_update, weight=weight,
                    seq=seq, worker=worker, window_s=window_s))
        futures = [
            self._pool.submit(self._shard_leg, ctx, i, c, part,
                              last_update, applied, seq)
            for i, (c, part) in enumerate(
                zip(self.clients[1:], parts[1:]), start=1)]
        for f in futures:
            f.result()
        return at_fold, applied

    @staticmethod
    def _shard_leg(ctx, shard, client, part, last_update, applied, seq):
        with telemetry.use_trace(ctx):
            with telemetry.span("trace.shard", shard=shard):
                return client.commit_ex(part, last_update, applied, seq)

    @property
    def num_updates(self) -> int:
        return self._coord_call(lambda c: c.num_updates)

    # membership/history live on the coordinator shard
    def register(self, worker: int,
                 lease_s: Optional[float] = None) -> float:
        return self._coord_call(
            lambda c: c.register(worker, lease_s=lease_s))

    def renew_lease(self, worker: int) -> bool:
        return self._coord_call(lambda c: c.renew_lease(worker))

    def deregister(self, worker: int) -> None:
        self._coord_call(lambda c: c.deregister(worker))

    def shard_map(self) -> dict:
        return self._coord_call(lambda c: c.shard_map())

    def coordinator_view(self) -> dict:
        return self._coord_call(lambda c: c.coordinator_view())

    def put_history(self, pid: int, windows: list) -> None:
        self._coord_call(lambda c: c.put_history(pid, windows))

    # the telemetry collector also lives on the coordinator shard (and
    # follows it through a promotion — the standby re-mounts one)
    def put_telemetry(self, pid: int, rows: list) -> dict:
        return self._coord_call(lambda c: c.put_telemetry(pid, rows))

    def get_merged_telemetry(self) -> list:
        return self._coord_call(lambda c: c.get_merged_telemetry())

    def get_history(self, timeout: float = 600):
        # the barrier (and merged history, and final clock) live on the
        # coordinator; the fleet is quiescent once it resolves, so the
        # follower pulls below read a settled center
        windows, part0, clock = self._coord_call(
            lambda c: c.get_history(timeout=timeout))
        futures = [self._pool.submit(c.pull) for c in self.clients[1:]]
        parts = [part0] + [f.result()[0] for f in futures]
        return (windows, join_tree(parts, self.assignment, self._treedef),
                clock)

    def close(self) -> None:
        for client in self.clients:
            client.close()  # idempotent, bounded
        self._pool.shutdown(wait=False)

    # reference lifecycle no-ops (parity with ParameterServer)
    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass
