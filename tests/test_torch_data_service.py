"""The port's streaming data service against the JAX package's.

Twins of tests/test_data_service.py's single-process tests run on the
port alone: leased ranges, the resumable seeded shuffle, exactly-once
retirement, the chaos drills (a worker killed mid-epoch, a torn
coordinator restart, a lost ack reply), the health plane's DATA digest
and the trainer's ``data_service=`` path on ``device="cpu"``. Then the
two packages side by side, on the same seeded numpy rows:

- ``epoch_stream`` of the two coordinators is equal for the same
  ``(seed, epoch, range_size)``;
- ``stream_worker_rounds`` yields bitwise the same round dicts as
  JAX's, against either package's coordinator;
- a client of one package drains a coordinator of the other, with the
  same ranges and rows (one wire format);
- ``ADAG(MLP)`` ``host_async`` at K = 1 from a data service, with
  bridged weights, gives JAX's loss history and final center at rtol
  1e-5 / atol 1e-6 (tests/test_torch_host_async.py's K = 1 bounds);
- the runner's per-window FLOP count, forced with a given peak, takes
  no round from a lease-driven source: every range is trained once.

Every coordinator binds 127.0.0.1's port 0 and is stopped in a
``finally``; leases are at most 0.2 s.
"""

import contextlib
import threading
import time

import numpy as np
import pytest

from distkeras_tpu_torch import comms
from distkeras_tpu_torch.data.dataset import Dataset, synthetic_mnist
from distkeras_tpu_torch.data.global_shards import GlobalShards, ShardingError
from distkeras_tpu_torch.data.prefetch import prefetch
from distkeras_tpu_torch.data.service import (DataCoordinator,
                                              DataServiceClient,
                                              DataServiceUnavailable,
                                              stream_ranges)
from distkeras_tpu_torch.utils import fault

FAST_RETRY = comms.RetryPolicy(max_retries=2, base_s=0.01, max_s=0.02)


@pytest.fixture(autouse=True)
def _clean_chaos():
    fault.clear_chaos()
    yield
    fault.clear_chaos()


@contextlib.contextmanager
def serving(*coords):
    """Start each coordinator; stop every one, whatever happens."""
    try:
        for c in coords:
            c.start()
        yield coords[0] if len(coords) == 1 else coords
    finally:
        for c in coords:
            c.stop()


def _columns(n=100):
    return {"features": np.arange(2 * n, dtype=np.float32).reshape(n, 2),
            "label": np.arange(n, dtype=np.int64)}


def _dataset(n=100):
    return Dataset(_columns(n))


def _drain(coord, worker=0, max_ranges=1, dataset=None, pkg=None):
    """One worker drains the whole stream; returns the consumed
    (epoch, pos, start, stop) tuples in consumption order."""
    client_cls, ranges = (DataServiceClient, stream_ranges) if pkg is None \
        else (pkg.DataServiceClient, pkg.stream_ranges)
    out = []
    with client_cls(coord.address, worker=worker, retry=FAST_RETRY) as c:
        for e, pos, start, stop, rows in ranges(
                c, dataset=dataset, max_ranges=max_ranges):
            out.append((e, pos, start, stop))
    return out


# -- deterministic shuffle & exactly-once accounting -----------------------

def test_unequal_last_range_and_full_coverage():
    coord = DataCoordinator(total_rows=103, range_size=10, seed=7)
    try:
        assert coord.num_ranges == 11
        stream = coord.epoch_stream(0)
        sizes = sorted(t - s for _, s, t in stream)
        assert sizes == [3] + [10] * 10
        covered = np.zeros(103, bool)
        for _, s, t in stream:
            assert not covered[s:t].any()  # no overlap
            covered[s:t] = True
        assert covered.all()
    finally:
        coord.stop()


def test_epoch_stream_seeded_and_epoch_varied():
    a = DataCoordinator(total_rows=96, range_size=8, seed=3)
    b = DataCoordinator(total_rows=96, range_size=8, seed=3)
    c = DataCoordinator(total_rows=96, range_size=8, seed=4)
    try:
        assert a.epoch_stream(0) == b.epoch_stream(0)
        assert a.epoch_stream(0) != a.epoch_stream(1)  # reshuffle per epoch
        assert a.epoch_stream(0) != c.epoch_stream(0)
    finally:
        for x in (a, b, c):
            x.stop()


def test_single_worker_drains_exactly_once_in_stream_order():
    with serving(DataCoordinator(dataset=_dataset(90), range_size=16,
                                 seed=5)) as coord:
        seen = _drain(coord, max_ranges=2)
        assert sorted(p for _, p, _, _ in seen) \
            == list(range(coord.num_ranges))
        assert [(p, s, t) for _, p, s, t in sorted(seen)] \
            == coord.epoch_stream(0)
        assert list(coord.cursor_carry()) == [1, coord.num_ranges]


def test_worker_count_does_not_reorder_global_stream():
    """1 -> 3 -> 2 workers: the recovered global stream is identical."""
    ds = _dataset(120)
    orders = []
    for workers in (1, 3, 2):
        with serving(DataCoordinator(dataset=ds, range_size=16,
                                     seed=11)) as coord:
            lock = threading.Lock()
            seen = []

            def run(w):
                with DataServiceClient(coord.address, worker=w,
                                       retry=FAST_RETRY) as c:
                    for item in stream_ranges(c):
                        with lock:
                            seen.append(item[:4])

            threads = [threading.Thread(target=run, args=(w,))
                       for w in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert sorted(p for _, p, _, _ in seen) \
                == list(range(coord.num_ranges))
            orders.append(sorted(seen))
    assert orders[0] == orders[1] == orders[2]


def test_multi_epoch_streaming():
    with serving(DataCoordinator(dataset=_dataset(48), range_size=16,
                                 seed=2, num_epochs=3)) as coord:
        seen = _drain(coord)
        assert sorted(e for e, _, _, _ in seen) == [0] * 3 + [1] * 3 + [2] * 3
        by_epoch = {e: [(p, s, t) for ee, p, s, t in sorted(seen)
                        if ee == e] for e in range(3)}
        for e in range(3):
            assert by_epoch[e] == coord.epoch_stream(e)
        assert by_epoch[0] != by_epoch[1]  # reshuffled between epochs


# -- fetch plane -----------------------------------------------------------

def test_wire_fetch_roundtrips_exact_rows():
    ds = _dataset(40)
    with serving(DataCoordinator(dataset=ds, range_size=8)) as coord:
        c = DataServiceClient(coord.address, worker=0, retry=FAST_RETRY)
        c.register()
        assert c.meta["serves_data"] is True
        rows = c.fetch(5, 19)
        np.testing.assert_array_equal(rows["features"], ds["features"][5:19])
        np.testing.assert_array_equal(rows["label"], ds["label"][5:19])
        assert rows["features"].dtype == np.float32
        with pytest.raises(RuntimeError, match="bad_range|outside"):
            c.fetch(30, 50)
        c.close()


def test_order_only_coordinator_requires_local_rows():
    with serving(DataCoordinator(total_rows=32, range_size=8)) as coord:
        c = DataServiceClient(coord.address, worker=0, retry=FAST_RETRY)
        c.register()
        assert c.meta["serves_data"] is False
        with pytest.raises(ValueError, match="one side must hold the rows"):
            next(stream_ranges(c))
        # local-slice mode works against the same coordinator
        assert len(list(stream_ranges(c, dataset=_dataset(32)))) == 4
        c.close()


def test_token_auth_rejects_bad_client():
    with serving(DataCoordinator(total_rows=16, range_size=8,
                                 token="secret")) as coord:
        bad = DataServiceClient(coord.address, worker=0, token="wrong",
                                retry=FAST_RETRY)
        with pytest.raises(RuntimeError, match="authentication"):
            bad.register()
        bad.close()
        good = DataServiceClient(coord.address, worker=0, token="secret",
                                 retry=FAST_RETRY)
        assert good.register()["num_ranges"] == 2
        good.close()


# -- chaos acceptance ------------------------------------------------------

def test_worker_killed_mid_epoch_zero_lost_zero_duplicated():
    """Worker A leases three ranges, lands and acks one, dies holding two.
    After its lease lapses the survivor inherits them: every range lands
    exactly once."""
    with serving(DataCoordinator(dataset=_dataset(80), range_size=8,
                                 seed=9, lease_s=0.15)) as coord:
        landed = []
        a = DataServiceClient(coord.address, worker=0, retry=FAST_RETRY)
        a.register()
        grant = a.lease(max_ranges=3)
        assert len(grant["ranges"]) == 3
        pos0, s0, t0 = grant["ranges"][0]
        a.fetch(s0, t0)
        landed.append(("A", pos0))
        assert a.ack(grant["epoch"], [pos0])["retired"] == 1
        a.close()  # dies: no deregister
        time.sleep(0.25)  # > lease_s: A's lease lapses
        with DataServiceClient(coord.address, worker=1,
                               retry=FAST_RETRY) as b:
            for e, pos, s, t, rows in stream_ranges(b, max_ranges=2):
                landed.append(("B", pos))
        assert sorted(p for _, p in landed) == list(range(coord.num_ranges))
        abandoned = {p for p, _, _ in grant["ranges"][1:]}
        assert {p for who, p in landed if who == "B"} >= abandoned
        assert list(coord.cursor_carry()) == [1, coord.num_ranges]
        assert coord.status_digest()["data"]["releases"] == 2


def test_coordinator_kill_restart_resumes_cursor_bitwise():
    """Chaos-kill the coordinator mid-epoch, bring up a fresh one from
    the checkpointed cursor: the consumed stream equals an uninterrupted
    run's, bit for bit."""
    ds = _dataset(112)

    def mk():
        return DataCoordinator(dataset=ds, range_size=16, seed=13)

    coord, fresh = mk(), mk()
    try:
        reference = coord.epoch_stream(0)
        coord.start()
        consumed, carry = [], coord.cursor_carry()
        # the 8th dispatch dies mid-serve (register + 3x(lease, ack))
        fault.inject_chaos("data.lease", "kill", after=7)
        with pytest.raises(DataServiceUnavailable):
            c = DataServiceClient(coord.address, worker=0, retry=FAST_RETRY)
            c.register()
            for item in stream_ranges(c):
                consumed.append(item[:4])
                carry = coord.cursor_carry()  # the trainer's snapshot
        fault.clear_chaos()
        assert 0 < len(consumed) < coord.num_ranges
        assert not coord._running
        fresh.restore_cursor(carry)
        fresh.start()
        resumed = _drain(fresh)
        w = int(carry[1])
        assert [(p, s, t) for _, p, s, t in resumed] == reference[w:]
        assert [(p, s, t) for _, p, s, t in consumed[:w]] \
            + [(p, s, t) for _, p, s, t in resumed] == reference
        assert list(fresh.cursor_carry()) == [1, fresh.num_ranges]
    finally:
        coord.stop()
        fresh.stop()


def test_ack_applied_but_reply_lost_dedups_on_retry():
    """reset_after_send on the ack: the retried (cid, seq) replays the
    cached reply; the range is retired once."""
    with serving(DataCoordinator(total_rows=32, range_size=8,
                                 seed=1)) as coord:
        c = DataServiceClient(coord.address, worker=0, retry=FAST_RETRY)
        c.register()
        grant = c.lease()
        pos = grant["ranges"][0][0]
        fault.inject_chaos("data.fetch", "reset_after_send", after=0)
        reply = c.ack(grant["epoch"], [pos])
        fault.clear_chaos()
        assert reply == {"retired": 1, "stale": 0, "epoch_done": False,
                         "epoch": 0, "blob_lens": []}
        assert int(coord.cursor_carry()[1]) == 1
        c.close()


def test_lease_request_survives_connection_reset():
    with serving(DataCoordinator(total_rows=32, range_size=8)) as coord:
        c = DataServiceClient(coord.address, worker=0, retry=FAST_RETRY)
        c.register()
        fault.inject_chaos("data.fetch", "reset", after=0)  # before send
        assert len(c.lease()["ranges"]) == 1  # retried, granted once
        c.close()


def test_client_raises_typed_unavailable_when_coordinator_gone():
    with serving(DataCoordinator(total_rows=16, range_size=8)) as coord:
        c = DataServiceClient(coord.address, worker=0, retry=FAST_RETRY)
        c.register()
        coord.kill()
        with pytest.raises(DataServiceUnavailable):
            c.lease()
        c.close()


# -- cursor carry edge cases ----------------------------------------------

def test_cursor_carry_validation_and_exhausted_restore():
    coord = DataCoordinator(total_rows=16, range_size=8, num_epochs=2)
    try:
        with pytest.raises(ValueError, match="epoch, watermark"):
            coord.restore_cursor(np.zeros(3, np.int64))
        with pytest.raises(ValueError, match="outside"):
            coord.restore_cursor(np.array([0, 99], np.int64))
        coord.restore_cursor(np.array([2, 2], np.int64))  # past num_epochs
        coord.start()
        assert _drain(coord, dataset=_dataset(16)) == []
    finally:
        coord.stop()


def test_restore_mid_epoch_serves_exact_suffix():
    coord = DataCoordinator(total_rows=64, range_size=8, seed=21)
    try:
        coord.restore_cursor(np.array([0, 5], np.int64))
        coord.start()
        seen = _drain(coord, dataset=_dataset(64))
        assert [(p, s, t) for _, p, s, t in seen] \
            == coord.epoch_stream(0)[5:]
    finally:
        coord.stop()


# -- satellites ------------------------------------------------------------

def test_global_shards_typed_sharding_error(tmp_path):
    paths = []
    for i in range(3):
        p = tmp_path / f"s{i}.npy"
        np.save(p, np.zeros((4, 2), np.float32))
        paths.append(str(p))
    gs = GlobalShards({"features": paths})
    with pytest.raises(ShardingError) as e:
        gs.epoch_assignment(0, process_count=2)
    assert isinstance(e.value, ValueError)
    assert "3 shard files" in str(e.value) and "2 processes" in str(e.value)
    assert "DataCoordinator" in str(e.value)
    bad = tmp_path / "s3.npy"
    np.save(bad, np.zeros((5, 2), np.float32))
    with pytest.raises(ShardingError, match="SAME row count"):
        GlobalShards({"features": paths + [str(bad)]})


def test_global_shards_streaming_dataset_bridges_to_service(tmp_path):
    rows = np.arange(24, dtype=np.float32).reshape(12, 2)
    paths = []
    for i in range(3):
        p = tmp_path / f"f{i}.npy"
        np.save(p, rows[i * 4:(i + 1) * 4])
        paths.append(str(p))
    ds = GlobalShards({"features": paths}).streaming_dataset()
    assert len(ds) == 12
    with serving(DataCoordinator(dataset=ds, range_size=5)) as coord:
        seen = _drain(coord)  # 5 does not divide 12: fine
    got = np.concatenate([ds["features"][s:t] for _, _, s, t in sorted(seen)])
    np.testing.assert_array_equal(np.sort(got.ravel()), np.sort(rows.ravel()))


def test_prefetch_reraises_with_producer_traceback():
    def producer():
        yield 1
        raise RuntimeError("disk on fire")

    it = prefetch(producer(), depth=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="disk on fire") as e:
        list(it)
    tb = e.value.producer_traceback
    assert "producer" in tb and "disk on fire" in tb


def test_fleet_data_line_in_watch_table():
    from distkeras_tpu_torch.health.cli import _fleet_data, _watch_table

    rows = [
        {"kind": "gauge", "name": "data.service.cursor", "value": 7.0},
        {"kind": "gauge", "name": "data.service.epoch", "value": 1.0},
        {"kind": "gauge", "name": "data.service.leased_ranges",
         "value": 3.0},
        {"kind": "gauge", "name": "data.service.ranges", "value": 20.0},
        {"kind": "counter", "name": "data.service.releases",
         "labels": {"reason": "lease"}, "value": 2.0},
        {"kind": "counter", "name": "data.service.releases",
         "labels": {"reason": "deregister"}, "value": 1.0},
    ]
    digest = _fleet_data(rows)
    assert digest == {"cursor": 7, "epoch": 1, "leased": 3, "ranges": 20,
                      "releases": 3}
    table = _watch_table({}, {}, 0.0, fleet_data=digest)
    line = [ln for ln in table.splitlines() if "DATA:" in ln]
    assert line and "cursor=7" in line[0] and "releases=3" in line[0]
    assert _fleet_data([{"kind": "gauge", "name": "x.y", "value": 1}]) == {}
    assert "DATA:" not in _watch_table({}, {}, 0.0)


def test_status_digest_on_health_plane():
    from distkeras_tpu_torch.health.endpoints import HealthClient

    with serving(DataCoordinator(total_rows=40, range_size=8)) as coord:
        c = DataServiceClient(coord.address, worker=0, retry=FAST_RETRY)
        c.register()
        c.lease(max_ranges=2)
        hc = HealthClient(coord.address)
        status = hc.status()
        assert status["data"]["ranges"] == 5
        assert status["data"]["leased"] == 2
        assert status["data"]["cursor"] == 0
        hc.close()
        c.close()


# -- trainer integration ---------------------------------------------------

def test_stream_worker_rounds_matches_staged_shapes():
    from distkeras_tpu_torch.parallel import host_async

    with serving(DataCoordinator(dataset=synthetic_mnist(n=128),
                                 range_size=32, seed=4)) as coord:
        rounds = list(host_async.stream_worker_rounds(
            coord.address, worker=0, features_col="features",
            label_col="label", batch_size=8, window=2)())
    assert len(rounds) == 128 // 16
    for r in rounds:
        assert r["features"].shape == (2, 8, 784)
        assert r["labels"].shape == (2, 8, 10)


def test_adag_host_async_trains_from_data_service(tmp_path):
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.checkpoint import Checkpointer
    from distkeras_tpu_torch.models.mlp import MLP

    ds = synthetic_mnist(n=256)
    with serving(DataCoordinator(dataset=ds, range_size=64, seed=0,
                                 num_epochs=2)) as coord:
        t = ADAG(MLP(features=(16,)), learning_rate=0.05, batch_size=16,
                 num_workers=2, communication_window=2, mode="host_async",
                 data_service=coord, checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_folds=2, device="cpu")
        t.train(ds)
        # 2 epochs x 256 rows / 16-row batches = 32 steps landed
        assert len(t.history) == 32
        assert list(coord.cursor_carry()) == [2, coord.num_ranges]
        with pytest.raises(ValueError, match="global shuffle"):
            t.train(ds, shuffle=True)
    # the shuffle cursor rode the snapshot next to the center
    ck = Checkpointer(str(tmp_path / "ck"))
    snap = ck.restore(step=ck.latest_step())
    assert list(np.asarray(snap["data_cursor"])) == [2, coord.num_ranges]


def test_data_service_cursor_restores_on_resume(tmp_path):
    """``resume=True`` puts the snapshot's cursor back on the coordinator:
    a fresh coordinator at a cursor of ``[1, 0]`` streams epoch 1 only."""
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.checkpoint import Checkpointer
    from distkeras_tpu_torch.models.mlp import MLP

    ds = synthetic_mnist(n=128)
    kw = dict(learning_rate=0.05, batch_size=16, num_workers=1,
              communication_window=2, mode="host_async", device="cpu",
              checkpoint_dir=str(tmp_path))
    first = DataCoordinator(dataset=ds, range_size=32, num_epochs=1)
    with serving(first):
        ADAG(MLP(features=(8,)), data_service=first, **kw).train(ds)
    ck = Checkpointer(str(tmp_path))
    step = ck.latest_step()
    ck.save(step + 1, {**ck.restore(step=step),
                       "data_cursor": np.array([1, 0], np.int64)})
    second = DataCoordinator(dataset=ds, range_size=32, num_epochs=2)
    with serving(second):
        t = ADAG(MLP(features=(8,)), data_service=second, **kw)
        t.train(ds, resume=True)
        assert len(t.history) == 128 // 16  # epoch 1 alone
        assert list(second.cursor_carry()) == [2, second.num_ranges]


def test_data_service_kwarg_validation():
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.models.mlp import MLP

    with pytest.raises(ValueError, match="host_async"):
        ADAG(MLP(features=(8,)), num_workers=1, device="cpu",
             data_service="127.0.0.1:1")
    with pytest.raises(ValueError, match="data_layout"):
        ADAG(MLP(features=(8,)), num_workers=2, mode="host_async",
             data_layout="host_sharded", device="cpu",
             data_service="127.0.0.1:1")


def test_window_flop_count_trains_every_range_once():
    """The per-window FLOP count, forced with a given peak, counts on a
    round a worker trains: no range is leased for the count alone. Two
    ranges make one round here, so a round taken for the count would ack
    one range untrained and release another."""
    from distkeras_tpu_torch.models.mlp import MLP
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.parallel import host_async, strategies

    ds = synthetic_mnist(n=192)
    with serving(DataCoordinator(dataset=ds, range_size=8, seed=3,
                                 num_epochs=2)) as coord:
        model = MLP(features=(8,))
        runner = host_async.HostAsyncRunner(
            model, "categorical_crossentropy", optimizers.get("sgd", 0.05),
            strategies.get("adag", learning_rate=0.05), window=2,
            device="cpu")
        runner.mfu_peak_flops = 1e12
        sources = [host_async.stream_worker_rounds(
            coord.address, k, "features", "label", batch_size=8, window=2)
            for k in range(2)]
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        _, history, _, clock = runner.run(start, [sources])
        assert list(coord.cursor_carry()) == [2, coord.num_ranges]
        digest = coord.status_digest()["data"]
        assert digest["releases"] == 0
    assert runner._window_flops > 0
    # 2 epochs x 192 rows / 8-row steps; a window is 2 steps
    assert len(history) == 2 * 192 // 8 and clock == len(history) // 2


# -- the two packages side by side -------------------------------------------

def _jax_service():
    from distkeras_tpu.data import dataset as jdataset
    from distkeras_tpu.data import service as jservice

    return jservice, jdataset


@pytest.mark.parametrize("rows,range_size,seed", [(103, 10, 7), (4096, 512, 1),
                                                  (96, 8, 123456)])
def test_epoch_stream_equals_jax(rows, range_size, seed):
    jservice, _ = _jax_service()
    port = DataCoordinator(total_rows=rows, range_size=range_size,
                           seed=seed)
    jax_coord = jservice.DataCoordinator(total_rows=rows,
                                         range_size=range_size, seed=seed)
    try:
        for epoch in range(3):
            assert port.epoch_stream(epoch) == jax_coord.epoch_stream(epoch)
    finally:
        port.stop()
        jax_coord.stop()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_stream_worker_rounds_bitwise_equal_jax(server):
    from distkeras_tpu.parallel import host_async as jha
    from distkeras_tpu_torch.parallel import host_async as tha

    jservice, jdataset = _jax_service()
    src = synthetic_mnist(n=200, seed=2)
    cols = {c: np.asarray(src[c]) for c in src.columns}
    if server == "port":
        coords = [DataCoordinator(dataset=Dataset(cols), range_size=24,
                                  seed=5, num_epochs=2) for _ in range(2)]
    else:
        coords = [jservice.DataCoordinator(
            dataset=jdataset.Dataset(cols), range_size=24, seed=5,
            num_epochs=2) for _ in range(2)]
    with serving(*coords):
        got = {}
        for name, mod, coord in (("jax", jha, coords[0]),
                                 ("port", tha, coords[1])):
            got[name] = list(mod.stream_worker_rounds(
                coord.address, 0, "features", "label", batch_size=8,
                window=2)())
    assert len(got["port"]) == len(got["jax"]) > 0
    for a, b in zip(got["jax"], got["port"]):
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_client_of_one_package_drains_the_other(client, server):
    """One wire format: register, lease, fetch, ack, cursor and
    deregister between the packages give the stream and rows of the
    coordinator's own ``epoch_stream``."""
    jservice, jdataset = _jax_service()
    cols = _columns(90)
    coord = DataCoordinator(dataset=Dataset(cols), range_size=16, seed=8,
                            num_epochs=2) if server == "port" else \
        jservice.DataCoordinator(dataset=jdataset.Dataset(cols),
                                 range_size=16, seed=8, num_epochs=2)
    pkg = jservice if client == "jax" else None
    client_cls = jservice.DataServiceClient if client == "jax" \
        else DataServiceClient
    ranges = jservice.stream_ranges if client == "jax" else stream_ranges
    with serving(coord):
        seen = []
        with client_cls(coord.address, worker=3, retry=None) as c:
            assert c.meta["num_ranges"] == coord.num_ranges
            for e, pos, s, t, rows in ranges(c, max_ranges=2):
                seen.append((e, pos, s, t))
                for name, col in cols.items():
                    assert rows[name].dtype == col.dtype
                    np.testing.assert_array_equal(rows[name], col[s:t])
            assert c.cursor()["cursor"] == [2, coord.num_ranges]
        for e in range(2):
            assert [(p, s, t) for ee, p, s, t in sorted(seen) if ee == e] \
                == coord.epoch_stream(e)
        assert _drain(coord, pkg=pkg) == []  # exhausted for everyone


def test_adag_k1_from_data_service_matches_jax():
    """K = 1 is deterministic: the same seeded rows leased in the same
    order give JAX's loss history and final center."""
    import jax

    import distkeras_tpu as jdk
    from distkeras_tpu.models.mlp import MLP as JMLP
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.models.mlp import MLP
    from distkeras_tpu_torch.utils import bridge

    jservice, jdataset = _jax_service()
    src = synthetic_mnist(n=192, seed=4)
    cols = {c: np.asarray(src[c]) for c in src.columns}
    kw = dict(learning_rate=0.05, batch_size=16, num_workers=1,
              communication_window=2, mode="host_async",
              worker_optimizer="sgd", metrics=("accuracy",), seed=0)
    jmodel = JMLP(features=(16,), dropout_rate=0.0)
    params = jmodel.init(jax.random.key(0), np.zeros((1, 784), np.float32),
                         train=False)["params"]
    jcoord = jservice.DataCoordinator(dataset=jdataset.Dataset(cols),
                                      range_size=48, seed=6, num_epochs=2)
    tcoord = DataCoordinator(dataset=Dataset(cols), range_size=48, seed=6,
                             num_epochs=2)
    with serving(jcoord, tcoord):
        jt = jdk.ADAG(jmodel, data_service=jcoord, **kw)
        jt.train(jdataset.Dataset(cols))
        tt = ADAG(bridge.load_flax_params(MLP(features=(16,)), params),
                  data_service=tcoord, device="cpu", **kw)
        tt.train(None)
    assert len(tt.history) == len(jt.history) == 2 * 192 // 16
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose([h[key] for h in tt.history],
                                   [h[key] for h in jt.history],
                                   rtol=1e-5, atol=1e-6)
    got = bridge.state_dict_to_flax(tt.params)
    for mod, leaves in jt.params.items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(got[mod][leaf], np.asarray(want),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{mod}/{leaf}")
    assert tt.num_updates == jt.num_updates
