"""The port's parameter service and client against the JAX package's,
over ``127.0.0.1:0``.

- Cross-package: a JAX ``RemoteParameterServer`` against a port
  ``ParameterServerService`` and a port client against a JAX service,
  each beside the all-JAX pair, under one scripted DynSGD commit
  sequence: the pull replies' blobs are byte-equal, and the fold clocks,
  the applied weights and the ``clock``/``version`` ops equal, for the
  raw codec and a negotiated int8 wire.
- The service alone, as JAX's tests hold it: pull/commit/clock, DynSGD
  staleness over the wire, concurrent clients serializing at the center,
  the history barrier (merged by clock; a typed timeout), unknown ops,
  the shared token (every request needs it; a bad one drops the
  connection), handler-thread pruning, commit dedup by ``(cid, seq)``
  with a reply lost after the send (folds once), retry exhaustion
  raising a typed ``PSUnavailable``, ``kill``, ``fence``, the collector's
  ``telemetry_put``/``telemetry_merged`` ops, and the client's control
  connection answering while a commit is held.

Counters and events are asserted, never elapsed time; every blocking
wait has a timeout and op timeouts are at least 5 s.
"""

import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import parameter_servers as jps
from distkeras_tpu.parallel import remote_ps as jrps
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.comms import RetryPolicy
from distkeras_tpu_torch.health.collector import TelemetryCollector
from distkeras_tpu_torch.parallel import remote_ps as rps
from distkeras_tpu_torch.utils import fault

LIKE = {"dense_0": {"kernel": np.zeros((6, 4), np.float32),
                    "bias": np.zeros((4,), np.float32)},
        "head": {"kernel": np.zeros((4, 3), np.float32)}}
FAST = dict(retry=RetryPolicy(max_retries=2, base_s=0.01, max_s=0.05),
            op_timeout=10.0)


@pytest.fixture(autouse=True)
def fresh():
    telemetry.reset()
    fault.clear_chaos()
    yield
    fault.clear_chaos()
    telemetry.reset()


def _start(seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (rng.integers(-8, 8, x.shape) / 8).astype(np.float32),
        LIKE)


def _port_service(start=None, cls=tps.DynSGDParameterServer, **kw):
    start = _start() if start is None else start
    ps = cls(jax.tree.map(lambda x: torch.from_numpy(np.array(x)), start))
    svc = rps.ParameterServerService(ps, start, host="127.0.0.1", **kw)
    svc.start()
    return svc


def _jax_service(start=None, **kw):
    start = _start() if start is None else start
    ps = jps.DynSGDParameterServer(jax.tree.map(jnp.asarray, start))
    svc = jrps.ParameterServerService(ps, start, host="127.0.0.1", **kw)
    svc.start()
    return svc


def _addr(svc):
    return f"127.0.0.1:{svc.port}"


def _deltas(n=5):
    rng = np.random.default_rng(7)
    return [jax.tree.map(lambda x: (rng.integers(-16, 16, x.shape) / 16)
                         .astype(np.float32), LIKE) for _ in range(n)]


SCHEDULE = (0, 0, 1, 0, 3)  # last_update of each commit


def _drive(client):
    """The scripted sequence through one client: (at_fold, weight) per
    commit, the raw pull blobs, the clock and version ops."""
    folds = [client.commit_ex(d, last_update=u)
             for d, u in zip(_deltas(), SCHEDULE)]
    resp, blobs = client._roundtrip({"op": "pull"})
    return (folds, [bytes(b) for b in blobs], resp["clock"],
            client.num_updates, client.model_version)


@pytest.mark.parametrize("codec", ["raw", "int8"])
@pytest.mark.parametrize("pair", ["jax_client_port_service",
                                  "port_client_jax_service"])
def test_cross_package_pull_bytes_clocks_and_weights(pair, codec):
    ref_svc = _jax_service()
    svc = _port_service() if pair == "jax_client_port_service" \
        else _jax_service()
    client_cls = jrps.RemoteParameterServer \
        if pair == "jax_client_port_service" else rps.RemoteParameterServer
    ref = jrps.RemoteParameterServer(_addr(ref_svc), LIKE, codec=codec)
    client = client_cls(_addr(svc), LIKE, codec=codec)
    try:
        assert client.negotiated == ref.negotiated == codec
        got, want = _drive(client), _drive(ref)
        assert got == want
        folds = got[0]
        assert [f[0] for f in folds] == [0, 1, 2, 3, 4]
        assert [f[1] for f in folds] == [1.0, 0.5, 0.5, 0.25, 0.5]
    finally:
        client.close()
        ref.close()
        svc.stop()
        ref_svc.stop()


def test_pull_commit_clock_and_dynsgd_staleness():
    svc = _port_service(cls=tps.DynSGDParameterServer)
    c = rps.RemoteParameterServer(_addr(svc), LIKE, **FAST)
    try:
        center, clock = c.pull()
        assert clock == 0
        np.testing.assert_array_equal(center["head"]["kernel"],
                                      _start()["head"]["kernel"])
        one = jax.tree.map(np.ones_like, LIKE)
        assert c.commit_ex(one, last_update=0) == (0, 1.0)
        assert c.commit_ex(one, last_update=0) == (1, 0.5)
        assert c.commit(one, last_update=2) == 2
        center, clock = c.pull()
        assert clock == c.num_updates == 3
        np.testing.assert_array_equal(center["dense_0"]["bias"],
                                      _start()["dense_0"]["bias"] + 2.5)
        c.set_model_version(4)
        assert c.model_version == 4 and svc.ps.model_version == 4
        with pytest.raises(RuntimeError, match="monotone"):
            c.set_model_version(4)
        assert c.pull_versioned()[1:] == (3, 4)
    finally:
        c.close()
        svc.stop()


def test_concurrent_clients_serialize_at_the_center():
    svc = _port_service(cls=tps.DeltaParameterServer,
                        start=jax.tree.map(np.zeros_like, LIKE))
    clients = [rps.RemoteParameterServer(_addr(svc), LIKE, **FAST)
               for _ in range(4)]
    one = jax.tree.map(np.ones_like, LIKE)
    folds = []

    def work(c):
        for _ in range(5):
            folds.append(c.commit(one))

    try:
        threads = [threading.Thread(target=work, args=(c,))
                   for c in clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert sorted(folds) == list(range(20))
        center, clock = clients[0].pull()
        assert clock == 20
        assert np.all(center["head"]["kernel"] == 20.0)
    finally:
        for c in clients:
            c.close()
        svc.stop()


def test_history_barrier_merges_by_clock_and_times_out_typed():
    svc = _port_service(expected_processes=2)
    c = rps.RemoteParameterServer(_addr(svc), LIKE, **FAST)
    try:
        c.put_history(1, [[3, 1.0, [{"loss": 0.3}]],
                          [0, 0.0, [{"loss": 0.9}]]])
        with pytest.raises(rps.HistoryBarrierTimeout):
            c.get_history(timeout=0.2)
        with pytest.raises(rps.HistoryBarrierTimeout):
            svc.get_history_blocking(timeout=0.2)
        svc.put_history(0, [(1, 0.0, [{"loss": 0.5}])])
        windows, center, clock = c.get_history(timeout=5.0)
        assert [w[0] for w in windows] == [0, 1, 3]
        assert clock == 0
        merged, host_center, _ = svc.get_history_blocking(timeout=5.0)
        assert [w[0] for w in merged] == [0, 1, 3]
        np.testing.assert_array_equal(host_center["head"]["kernel"],
                                      center["head"]["kernel"])
    finally:
        c.close()
        svc.stop()


def test_unknown_op_and_token_auth():
    svc = _port_service(token="s3cret")
    good = rps.RemoteParameterServer(_addr(svc), LIKE, token="s3cret",
                                     **FAST)
    try:
        with pytest.raises(RuntimeError, match="unknown op"):
            good._roundtrip({"op": "frobnicate"})
        assert good.num_updates == 0
        for token in (None, "wrong"):
            sock = socket.create_connection(("127.0.0.1", svc.port),
                                            timeout=10)
            with sock:
                header = {"op": "clock"}
                if token is not None:
                    header["token"] = token
                rps.send_message(sock, header)
                resp, _ = rps.recv_message(sock)
                assert resp == {"error": "authentication failed",
                                "blob_lens": []}
                # the connection is dropped, not just the request
                assert sock.recv(1) == b""
        snap = telemetry.get_registry().snapshot()["counters"]
        assert snap["remote_ps.server.auth_failures"] == 2
    finally:
        good.close()
        svc.stop()


def test_handler_threads_are_pruned():
    svc = _port_service()
    try:
        for _ in range(6):
            c = rps.RemoteParameterServer(_addr(svc), LIKE, **FAST)
            assert c.num_updates == 0
            c.close()
        # a finished handler leaves the list at the next accept
        for t in list(svc._threads[1:]):
            t.join(timeout=10)
        c = rps.RemoteParameterServer(_addr(svc), LIKE, **FAST)
        assert c.num_updates == 0
        alive = [t for t in svc._threads if t.is_alive()]
        assert len(svc._threads) <= len(alive) + 1
        assert len(svc._threads) < 6
        c.close()
    finally:
        svc.stop()


def test_reply_lost_after_send_is_deduped_to_one_fold():
    svc = _port_service(cls=tps.DeltaParameterServer,
                        start=jax.tree.map(np.zeros_like, LIKE))
    c = rps.RemoteParameterServer(_addr(svc), LIKE, **FAST)
    try:
        fault.inject_chaos("remote_ps.send", "reset_after_send", count=1)
        assert c.commit(jax.tree.map(np.ones_like, LIKE)) == 0
        center, clock = c.pull()
        assert clock == 1 and np.all(center["head"]["kernel"] == 1.0)
        snap = telemetry.get_registry().snapshot()["counters"]
        assert snap["remote_ps.server.dedup_hits"] == 1
        assert snap["remote_ps.client.reconnects"] >= 1
    finally:
        c.close()
        svc.stop()


def test_retry_exhaustion_raises_typed_psunavailable():
    svc = _port_service()
    c = rps.RemoteParameterServer(_addr(svc), LIKE, **FAST)
    try:
        fault.inject_chaos("remote_ps.send", "reset", count=10)
        with pytest.raises(rps.PSUnavailable, match="unavailable"):
            c.pull()
        fault.clear_chaos()
        assert c.pull()[1] == 0  # the client recovers on the next op
    finally:
        c.close()
        svc.stop()
    c.close()  # idempotent


def test_kill_drops_live_connections_and_fence_redirects():
    svc = _port_service()
    c = rps.RemoteParameterServer(_addr(svc), LIKE, **FAST)
    try:
        svc.fence(3, coordinator="127.0.0.1:1")
        with pytest.raises(rps.CoordinatorFenced) as err:
            c.pull()
        assert err.value.epoch == 3
        assert err.value.coordinator == "127.0.0.1:1"
        assert svc.coordinator_view()["epoch"] == 3
        svc.kill(reason="test")
        with pytest.raises(rps.PSUnavailable):
            c.num_updates
        snap = telemetry.get_registry().snapshot()["counters"]
        assert snap["elastic.failover.kills"] == 1
    finally:
        c.close()
        svc.stop()


def test_telemetry_ops_over_the_collector():
    bare = _port_service()
    svc = _port_service(collector=TelemetryCollector())
    c = rps.RemoteParameterServer(_addr(svc), LIKE, **FAST)
    b = rps.RemoteParameterServer(_addr(bare), LIKE, **FAST)
    rows = [{"kind": "counter", "name": "trainer.steps", "value": 3}]
    try:
        res = c.put_telemetry(1, rows)
        assert res["ok"] and res["accepted"] == 1
        merged = c.get_merged_telemetry()
        assert [r["pid"] for r in merged] == [1]
        assert b.put_telemetry(1, rows) == {"ok": False, "accepted": 0,
                                            "dropped": 0,
                                            "blob_lens": []}
        assert b.get_merged_telemetry() == []
    finally:
        c.close()
        b.close()
        svc.stop()
        bare.stop()


def test_clock_poll_answers_while_a_commit_is_held():
    """The control connection has its own handler: a clock poll answers
    while the data connection's commit is held inside the fold."""
    svc = _port_service(cls=tps.DeltaParameterServer)
    c = rps.RemoteParameterServer(_addr(svc), LIKE, **FAST)
    entered, release = threading.Event(), threading.Event()
    orig = svc.ps.commit_ex

    def slow_commit(*a, **kw):
        entered.set()
        assert release.wait(timeout=30)
        return orig(*a, **kw)

    svc.ps.commit_ex = slow_commit
    out = []
    t = threading.Thread(target=lambda: out.append(
        c.commit(jax.tree.map(np.ones_like, LIKE))))
    try:
        t.start()
        assert entered.wait(timeout=30)
        assert c.num_updates == 0  # answered with the commit in flight
        release.set()
        t.join(timeout=30)
        assert out == [0] and c.num_updates == 1
    finally:
        release.set()
        c.close()
        svc.stop()
