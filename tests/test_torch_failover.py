"""The port's coordinator failover against the JAX package's scenarios,
over ``127.0.0.1:0``.

Every lease here runs on a scripted clock: a coordinator's death is
followed by advancing that clock past the lease, so the standby promotes
at the next ``coordinator`` query, with no wait on wall time.

- the lease-fencing state machine: a live lease blocks promotion, one
  promotion is admitted and a second rejected, the deposed coordinator
  hears the fence on its next heartbeat and redirects coordinator ops
  with a typed ``CoordinatorFenced``;
- replicated state survives promotion: an acked and replicated commit is
  replayed on the standby (clock intact, no gaps) and the fold sequence
  continues;
- a sharded DynSGD commit schedule gives the same ``(at_fold, weight)``
  trajectory and a bitwise-equal center whether the coordinator lives or
  is killed mid-schedule, and the same trajectory as a JAX fleet;
- the acceptance run: a K = 2 DynSGD runner over a standby-backed N = 2
  fleet whose coordinator is chaos-killed mid-run ends with zero lost
  windows, one promotion, the fleet's clock equal to the run's, and the
  dead coordinator's flight-recorder bundle carrying the kill.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.parallel import elastic as jelastic
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.comms import RetryPolicy
from distkeras_tpu_torch.health import recorder as flight_recorder
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.ops import optimizers as topt
from distkeras_tpu_torch.parallel import failover
from distkeras_tpu_torch.parallel import host_async as tha
from distkeras_tpu_torch.parallel import strategies as tstrat
from distkeras_tpu_torch.parallel.elastic import (
    ShardedRemoteParameterServer, make_ps_fleet)
from distkeras_tpu_torch.parallel.remote_ps import (CoordinatorFenced,
                                                    RemoteParameterServer)
from distkeras_tpu_torch.parameter_servers import DynSGDParameterServer
from distkeras_tpu_torch.utils import fault
from distkeras_tpu_torch.utils.trees import tree_map

PARAMS = {"w": np.ones((4, 3), np.float32),
          "b": np.zeros((3,), np.float32),
          "s": np.full((2,), 2.0, np.float32)}
FAST = dict(retry=RetryPolicy(max_retries=3, base_s=0.01, max_s=0.05),
            op_timeout=5.0)


@pytest.fixture(autouse=True)
def fresh_state():
    telemetry.reset()
    fault.clear_chaos()
    flight_recorder.get_recorder().clear()
    yield
    fault.clear_chaos()
    flight_recorder.configure(dump_dir=None)
    flight_recorder.get_recorder().clear()
    telemetry.reset()


def _counter(name: str) -> int:
    snap = telemetry.get_registry().snapshot()
    return sum(v for k, v in snap["counters"].items()
               if k.split("{", 1)[0] == name)


class _Clock:
    """The scripted lease clock; ``lapse()`` moves it past every lease."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def lapse(self):
        self.now += 1000.0


def _fleet(like=PARAMS, clock=None, **kw):
    return make_ps_fleet(
        lambda part: DynSGDParameterServer(
            tree_map(lambda x: torch.as_tensor(np.array(x)), part)),
        like, 2, host="127.0.0.1", time_fn=clock or _Clock(), **kw)


def _stop(services):
    for svc in services:
        if svc.replicator is not None:
            svc.replicator.close(timeout=0.5)
        svc.stop()


def _ones(like=PARAMS):
    return tree_map(lambda l: np.ones(np.shape(l), np.float32), like)


def _standby_client(services, like=PARAMS, **kw):
    return ShardedRemoteParameterServer(
        [svc.advertised for svc in services if not svc.is_standby],
        like, standby=services[-1].advertised, **kw)


def _kill_and_lapse(services, clock):
    assert services[0].replicator.flush(timeout=10.0)
    services[0].kill(reason="drill")
    clock.lapse()


def test_double_promotion_rejected_and_stale_coordinator_fenced():
    clock = _Clock()
    services = _fleet(clock=clock, standby=True, coord_lease_s=30.0)
    coord, standby = services[0], services[-1]
    try:
        assert standby.is_standby and standby.standby is not None
        # the replicator's first heartbeat lands before the promotion
        # (the next one is lease/3 = 10 s away), so the fence below is
        # heard only on the explicit heartbeat
        assert coord.replicator.flush(timeout=10.0)
        did, reason = standby.standby.maybe_promote()
        assert not did and "lease still live" in reason
        did, reason = standby.standby.maybe_promote(force=True)
        assert did and standby.standby.epoch == 1
        did, reason = standby.standby.maybe_promote(force=True)
        assert not did and "double promotion rejected" in reason
        assert not coord.fenced
        coord.replicator.heartbeat()
        assert coord.fenced and coord.fenced_by["epoch"] == 1
        assert coord.fenced_by["coordinator"] == standby.advertised
        stale = RemoteParameterServer(coord.advertised, PARAMS, **FAST)
        try:
            with pytest.raises(CoordinatorFenced) as ei:
                stale.pull()
            assert ei.value.coordinator == standby.advertised
            assert ei.value.epoch == 1
        finally:
            stale.close()
        assert _counter("elastic.failover.promotions") == 1
        assert _counter("elastic.failover.fenced") >= 1
    finally:
        _stop(services)


def test_replicated_state_survives_promotion():
    clock = _Clock()
    services = _fleet(clock=clock, standby=True, coord_lease_s=30.0)
    fleet = _standby_client(services, **FAST)
    try:
        assert fleet.commit_ex(_ones(), last_update=0) == (0, 1.0)
        _kill_and_lapse(services, clock)
        view = fleet.coordinator_view()  # re-resolves; the standby promotes
        assert view["promoted"] and view["epoch"] == 1
        standby = services[-1].standby
        assert standby.promoted and standby.applied >= 1
        assert standby.gaps == 0
        assert fleet.num_updates == 1
        assert fleet.commit_ex(_ones(), last_update=1) == (1, 1.0)
        assert _counter("elastic.failover.resolves") == 1
    finally:
        fleet.close()
        _stop(services)


PRE, POST = (0, 0, 1, 0, 1, 0), (2, 1, 4, 3, 5, 2)


def test_promotion_preserves_dynsgd_fold_trajectory():
    clock = _Clock()
    ref_services = _fleet()
    services = _fleet(clock=clock, standby=True, coord_lease_s=30.0)
    jservices = jelastic.make_ps_fleet(
        lambda part: jps.DynSGDParameterServer(
            jax.tree.map(jnp.asarray, part)), PARAMS, 2, host="127.0.0.1")
    one = _ones()
    ref = ShardedRemoteParameterServer(
        [svc.advertised for svc in ref_services], PARAMS, **FAST)
    fleet = _standby_client(services, **FAST)
    jref = jelastic.ShardedRemoteParameterServer(
        [svc.advertised for svc in jservices], PARAMS)
    try:
        seq = [fleet.commit_ex(one, last_update=u) for u in PRE]
        _kill_and_lapse(services, clock)
        seq += [fleet.commit_ex(one, last_update=u) for u in POST]
        ref_seq = [ref.commit_ex(one, last_update=u) for u in PRE + POST]
        jseq = [tuple(jref.commit_ex(one, last_update=u))
                for u in PRE + POST]
        assert seq == ref_seq == jseq
        c_ref, clock_ref = ref.pull()
        c_fail, clock_fail = fleet.pull()
        assert clock_fail == clock_ref == len(ref_seq)
        for k in PARAMS:
            assert c_fail[k].tobytes() == c_ref[k].tobytes()
            np.testing.assert_allclose(c_fail[k], np.asarray(jref.pull()[0][k]),
                                       rtol=1e-6)
        assert services[-1].standby.promoted
        assert services[-1].standby.gaps == 0
        assert _counter("elastic.failover.promotions") == 1
        assert _counter("elastic.failover.resolves") >= 1
    finally:
        for cli in (ref, fleet, jref):
            cli.close()
        _stop(ref_services)
        _stop(services)
        for svc in jservices:
            svc.stop()


def test_coordinator_values_and_lease_constants_equal_jax():
    from distkeras_tpu.parallel import failover as jfailover

    assert failover.DEFAULT_COORD_LEASE_S == jfailover.DEFAULT_COORD_LEASE_S
    assert failover.Replicator.QUEUE_MAX == jfailover.Replicator.QUEUE_MAX
    assert failover.StandbyState.DEDUP_MIRROR == \
        jfailover.StandbyState.DEDUP_MIRROR


def test_chaos_coordinator_kill_mid_run_fails_over(tmp_path):
    """A K = 2 DynSGD runner over a standby-backed N = 2 fleet; the
    coordinator is chaos-killed at its 7th op (past the registrations and
    the first pulls), and the kill moves the lease clock past the lease.
    Zero lost windows, one promotion, the fleet's clock the run's."""
    flight_recorder.configure(dump_dir=str(tmp_path))
    clock = _Clock()
    model = MLP(features=(8,), num_classes=4, in_features=12)
    like = {n: p.detach().clone() for n, p in model.named_parameters()}
    services = _fleet(like=like, clock=clock, standby=True,
                      coord_lease_s=30.0)
    orig_kill = services[0].kill

    def kill(reason="chaos"):
        orig_kill(reason)
        clock.lapse()

    services[0].kill = kill
    fault.inject_chaos("remote_ps.server.handle", "kill", after=6, count=1,
                       shard=0)
    fleet = _standby_client(
        services, like,
        retry=RetryPolicy(max_retries=2, base_s=0.01, max_s=0.05),
        op_timeout=5.0)
    rng = np.random.default_rng(0)
    shards = [[{"features": rng.standard_normal((2, 8, 12)).astype(
                   np.float32),
                "labels": np.eye(4, dtype=np.float32)[
                    rng.integers(0, 4, (2, 8))]} for _ in range(6)]
              for _ in range(2)]
    runner = tha.HostAsyncRunner(model, "categorical_crossentropy",
                                 topt.get("sgd", 0.05),
                                 tstrat.get("dynsgd", learning_rate=0.05),
                                 2, device="cpu", max_degraded_windows=64)
    try:
        center, hist, stal, end_clock = runner.run(like, [shards] * 2,
                                                   ps=fleet)
        assert len(runner.merged_windows) == 24 and len(hist) == 48
        assert services[-1].standby.promoted
        assert _counter("elastic.failover.kills") == 1
        assert _counter("elastic.failover.promotions") == 1
        assert _counter("elastic.failover.resolves") >= 1
        assert fleet.num_updates == end_clock >= 1
        killed = []
        for path in flight_recorder.find_bundles(str(tmp_path)):
            with open(path) as f:
                bundle = json.load(f)
            killed += [e for e in bundle.get("events", [])
                       if e.get("kind") == "failover"
                       and e.get("fields", {}).get("transition") == "killed"]
        assert killed, "postmortem bundle must carry the failover event"
    finally:
        fault.clear_chaos()
        fleet.close()
        _stop(services)
