"""The port's sharded parameter-server fleet against the JAX package's,
over ``127.0.0.1:0``.

- ``shard_assignment``, ``split_tree``, ``join_tree`` and
  ``shard_placement``/``standby_process`` equal JAX's for the same
  trees (the port flattens dicts in jax's order, so the maps agree);
- a port N=2 fleet and a single port service under one DynSGD commit
  schedule (a stale commit included) end on the same center (bitwise)
  and the same fold weights; a JAX sharded client against the port's
  fleet gives the fleet's own answers;
- the elastic wire, with counters asserted and never elapsed time: an
  evicted worker's commit late-folds at the DynSGD weight on a Delta
  fleet (scripted lease clock) and readmits it; a reply lost after the
  send dedups to one fold; a reset before the send reconnects; retry
  exhaustion raises a typed ``PSUnavailable``; the history barrier's
  timeout is typed; a K = 2 runner over the fleet counts every window;
- the trainer's ``ps_shards`` validation is JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.parallel import elastic as jelastic
from distkeras_tpu_torch import DOWNPOUR, telemetry
from distkeras_tpu_torch.comms import RetryPolicy
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.ops import optimizers as topt
from distkeras_tpu_torch.parallel import elastic
from distkeras_tpu_torch.parallel import host_async as tha
from distkeras_tpu_torch.parallel import strategies as tstrat
from distkeras_tpu_torch.parallel.remote_ps import (HistoryBarrierTimeout,
                                                    ParameterServerService,
                                                    PSUnavailable,
                                                    RemoteParameterServer)
from distkeras_tpu_torch.parameter_servers import (DeltaParameterServer,
                                                   DynSGDParameterServer)
from distkeras_tpu_torch.utils import fault
from distkeras_tpu_torch.utils.trees import tree_flatten, tree_map

PARAMS = {"w": np.ones((4, 3), np.float32),
          "b": np.zeros((3,), np.float32),
          "s": np.full((2,), 2.0, np.float32)}
FAST = dict(retry=RetryPolicy(max_retries=3, base_s=0.01, max_s=0.05),
            op_timeout=5.0)


@pytest.fixture(autouse=True)
def fresh_state():
    telemetry.reset()
    fault.clear_chaos()
    yield
    fault.clear_chaos()
    telemetry.reset()


def _counter(name: str) -> int:
    snap = telemetry.get_registry().snapshot()
    return sum(v for k, v in snap["counters"].items()
               if k.split("{", 1)[0] == name)


def _tensors(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _fleet(num_shards=2, ps_cls=DynSGDParameterServer, like=PARAMS, **kw):
    return elastic.make_ps_fleet(lambda part: ps_cls(_tensors(part)), like,
                                 num_shards, host="127.0.0.1", **kw)


def _stop(services):
    for svc in services:
        if svc.replicator is not None:
            svc.replicator.close(timeout=0.5)
        svc.stop()


def _one(like=PARAMS):
    return tree_map(lambda l: np.ones(np.shape(l), np.float32), like)


TREES = [
    {"a": np.zeros((4,), np.float32), "b": np.zeros((2,), np.float32),
     "c": np.zeros((2,), np.float32)},
    PARAMS,
    {"x": np.zeros((2, 3), np.float32),
     "y": {"z": np.zeros((5,), np.float32), "q": np.zeros((1,), np.int32)},
     "k": [np.zeros((7,), np.float16), np.zeros((3, 3), np.float64)]},
]


@pytest.mark.parametrize("tree", range(len(TREES)))
def test_shard_map_split_and_join_equal_jax(tree):
    like = TREES[tree]
    n_leaves = len(jax.tree.leaves(like))
    for shards in range(1, n_leaves + 1):
        mine = elastic.shard_assignment(like, shards)
        assert mine == jelastic.shard_assignment(like, shards)
        parts = elastic.split_tree(like, mine)
        jparts = jelastic.split_tree(like, mine)
        assert [[id(x) for x in p] for p in parts] == \
            [[id(x) for x in p] for p in jparts]
        back = elastic.join_tree(parts, mine,
                                 tree_flatten(like)[1])
        assert jax.tree.structure(back) == jax.tree.structure(like)
        jax.tree.map(lambda a, b: a is b or pytest.fail("leaf moved"),
                     back, like)
    for mod in (elastic, jelastic):
        with pytest.raises(ValueError, match="num_shards"):
            mod.shard_assignment(like, 0)
        with pytest.raises(ValueError, match="no parameters"):
            mod.shard_assignment(like, n_leaves + 1)


def test_placement_policies_equal_jax():
    for args in ((4, 3, "process0"), (5, 3, "spread"), (4, 1, "spread"),
                 (7, 4, "spread")):
        assert elastic.shard_placement(*args) == \
            jelastic.shard_placement(*args)
    for placement in ([0, 1, 2], [0], [0, 0]):
        assert elastic.standby_process(placement) == \
            jelastic.standby_process(placement)
    assert elastic.PLACEMENT_POLICIES == jelastic.PLACEMENT_POLICIES
    with pytest.raises(ValueError, match="ps_placement"):
        elastic.shard_placement(2, 2, "nope")


def test_sharded_fleet_matches_single_server_dynsgd():
    svc1 = ParameterServerService(DynSGDParameterServer(_tensors(PARAMS)),
                                  PARAMS, host="127.0.0.1")
    svc1.start()
    services = _fleet(2)
    one = _one()
    single = fleet = None
    try:
        single = RemoteParameterServer(f"127.0.0.1:{svc1.port}", PARAMS,
                                       **FAST)
        fleet = elastic.ShardedRemoteParameterServer(
            [svc.advertised for svc in services], PARAMS, **FAST)
        for cli in (single, fleet):
            assert cli.pull()[1] == 0
            assert cli.commit_ex(one, last_update=0) == (0, 1.0)
            assert cli.commit_ex(one, last_update=0) == (1, 0.5)
            assert cli.commit_ex(one, last_update=0) == (2, 1 / 3)
            assert cli.num_updates == 3
        c_single, _ = single.pull()
        c_fleet, clock = fleet.pull()
        assert clock == 3
        for k in PARAMS:
            assert c_fleet[k].tobytes() == c_single[k].tobytes()
        np.testing.assert_allclose(c_fleet["w"][0, 0], 1 + 1 + 0.5 + 1 / 3,
                                   rtol=1e-6)
        # a JAX sharded client against the port's fleet: the same answers
        jcli = jelastic.ShardedRemoteParameterServer(
            [svc.advertised for svc in services], PARAMS)
        try:
            jc, jclock = jcli.pull()
            assert jclock == 3
            for k in PARAMS:
                assert np.asarray(jc[k]).tobytes() == c_fleet[k].tobytes()
            assert jcli.commit_ex(one, last_update=3) == (3, 1.0)
        finally:
            jcli.close()
    finally:
        for cli in (single, fleet):
            if cli is not None:
                cli.close()
        svc1.stop()
        _stop(services)


def test_evicted_worker_late_fold_is_dynsgd_weighted_on_any_flavor():
    clock = [0.0]
    services = _fleet(2, ps_cls=DeltaParameterServer, lease_s=5.0,
                      time_fn=lambda: clock[0])
    one = _one()
    fleet = elastic.ShardedRemoteParameterServer(
        [svc.advertised for svc in services], PARAMS, **FAST)
    try:
        assert fleet.register(3) == 5.0
        fleet.commit_ex(one, last_update=0, worker=3)  # clock -> 1
        clock[0] = 6.0  # the lease lapses
        at, w = fleet.commit_ex(one, last_update=0, worker=3)
        assert (at, w) == (1, 0.5)
        assert _counter("elastic.late_folds") == 1
        assert _counter("elastic.evictions") == 1
        assert _counter("elastic.readmissions") == 1
        center, _ = fleet.pull()
        np.testing.assert_allclose(center["w"][0, 0], 2.5)
        np.testing.assert_allclose(center["s"][0], 3.5)
        _, w3 = fleet.commit_ex(one, last_update=2, worker=3)
        assert w3 == 1.0
        fleet.deregister(3)
        assert fleet.shard_map()["num_shards"] == 2
    finally:
        fleet.close()
        _stop(services)


@pytest.mark.parametrize("action", ["reset_after_send", "reset"])
def test_transport_resets_fold_once(action):
    svc = ParameterServerService(DeltaParameterServer(_tensors(PARAMS)),
                                 PARAMS, host="127.0.0.1")
    svc.start()
    cli = RemoteParameterServer(f"127.0.0.1:{svc.port}", PARAMS, **FAST)
    try:
        fault.inject_chaos("remote_ps.send", action, count=1)
        assert cli.commit(_one(), last_update=0) == 0
        assert cli.num_updates == 1
        center, _ = cli.pull()
        np.testing.assert_allclose(center["w"][0, 0], 2.0)
        assert _counter("remote_ps.client.retries") >= 1
        assert _counter("remote_ps.client.reconnects") >= 1
        assert _counter("remote_ps.server.dedup_hits") == \
            (1 if action == "reset_after_send" else 0)
    finally:
        cli.close()
        svc.stop()


def test_retry_exhaustion_then_recovery_and_typed_barrier_timeout():
    svc = ParameterServerService(DeltaParameterServer(_tensors(PARAMS)),
                                 PARAMS, host="127.0.0.1",
                                 expected_processes=2)
    svc.start()
    cli = RemoteParameterServer(f"127.0.0.1:{svc.port}", PARAMS, **FAST)
    try:
        fault.inject_chaos("remote_ps.send", "reset", count=None)
        with pytest.raises(PSUnavailable):
            cli.commit(_one(), last_update=0)
        assert _counter("remote_ps.client.unavailable") == 1
        fault.clear_chaos()
        assert cli.commit(_one(), last_update=0) == 0
        with pytest.raises(HistoryBarrierTimeout, match="barrier"):
            cli.get_history(timeout=0.2)
        assert issubclass(HistoryBarrierTimeout, TimeoutError)
        assert issubclass(HistoryBarrierTimeout, RuntimeError)
    finally:
        cli.close()
        svc.stop()


def test_runner_over_a_fleet_counts_every_window():
    model = MLP(features=(8,), num_classes=4, in_features=12)
    like = {n: p.detach().clone() for n, p in model.named_parameters()}
    services = _fleet(2, like=like)
    fleet = elastic.ShardedRemoteParameterServer(
        [svc.advertised for svc in services], like, **FAST)
    rng = np.random.default_rng(0)
    shards = [[{"features": rng.standard_normal((2, 8, 12)).astype(
                   np.float32),
                "labels": np.eye(4, dtype=np.float32)[
                    rng.integers(0, 4, (2, 8))]} for _ in range(3)]
              for _ in range(2)]
    runner = tha.HostAsyncRunner(model, "categorical_crossentropy",
                                 topt.get("sgd", 0.05),
                                 tstrat.get("dynsgd", learning_rate=0.05),
                                 2, device="cpu")
    try:
        center, hist, stal, clock = runner.run(like, [shards], ps=fleet)
        assert clock == fleet.num_updates == 6
        assert len(runner.merged_windows) == 6 and len(hist) == 12
        assert sorted(runner.window_clocks) == list(range(6))
        assert set(center) == set(like)
    finally:
        fleet.close()
        _stop(services)


def test_trainer_ps_shards_validation():
    model = MLP(features=(8,))
    with pytest.raises(ValueError, match="ps_shards"):
        DOWNPOUR(model, mode="host_async", num_workers=2, ps_shards=0,
                 device="cpu")
    with pytest.raises(ValueError, match="sync mode"):
        DOWNPOUR(model, num_workers=1, ps_shards=2, device="cpu")
    t = DOWNPOUR(model, mode="host_async", num_workers=2, ps_shards=2,
                 device="cpu")
    assert t.ps_shards == 2
