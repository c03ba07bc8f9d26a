"""The port's multi-process plane: two real processes in a gloo group.

The twin of ``tests/test_multihost.py``. A module fixture starts two
pairs of ranks of ``tests/torch_multiprocess_worker.py`` at once (each
pair a two-process ``torch.distributed`` group on ``127.0.0.1``, every
rank on ``device="cpu"`` with one intra-op thread, a 150 s timeout, and
killed in a ``finally``): the sync pair runs the deterministic scenarios,
the async pair the live-center ones. Each rank prints one line a
scenario; each test reads its own. While they run, the JAX package's
one-process oracles run in this process on conftest's CPU devices, from
the same start: the port's MLP is loaded with JAX's
``init(jax.random.key(0))`` through ``utils/bridge.py``.

Bounds, where a scenario is deterministic:

- the two ranks agree bit for bit (lines and saved arrays);
- the cross-process ADAG epoch (8 workers, 4 a process): the mean loss
  rtol 1e-5 and the center rtol 1e-5 / atol 1e-6 against JAX's epoch.
  The fold adds each process's partial (workers 0-3, then 4-7) where
  JAX's psum adds in its own order: float32 reassociation only;
- the public trainers (ADAG over the two-process mesh, host-sharded
  halves, ``GlobalShards``; ``PjitTrainer`` host-sharded, with an MLP
  and with BERT's masked_lm, whose token mean is the global batch's):
  every history entry rtol 1e-4 / atol 1e-5 and the final parameters
  rtol 1e-4 / atol 1e-5 against JAX's one-process trainer, the bounds
  of ``tests/test_torch_trainers.py``'s twins;
- ``GlobalShards``' epoch assignments equal JAX's ``epoch_assignment(e,
  process_count=2)`` exactly;
- host-sharded scoring: each half's predictions rtol 1e-5 / atol 1e-6 of
  JAX's full scoring, ``across_processes`` accuracy exactly JAX's and
  loss atol 1e-5.

The asynchronous scenarios hold ``tests/test_multihost.py``'s invariants
(192 commits and 384 history rows for the live center, 32 for
``GlobalShards`` with a live center, 64 then 128 across a resume, a
stale directory raising on both ranks) and the ranks' agreement. A sync
run resumed from epoch 0's checkpoint (process 0 writes the center and
every worker's carry, gathered) ends bit for bit where the
uninterrupted two-epoch run ends. ``AveragingTrainer`` and
``EnsembleTrainer`` over the two processes return what they return on a
one-process 8-worker mesh: the members bitwise, the average within 1e-6.

Also: process 0's service cannot bind its port and process 1 raises
``RuntimeError`` within 5 s; a spread two-shard fleet's addresses are
gathered equal on both ranks; ``num_workers < process_count`` raises on
both, and so does a process too short of rows (sync and ``host_async``);
``share_service_address``'s payload bytes equal JAX's for the same
ports and token; ``telemetry.process_index()`` is the rank.
"""

import json
import os
import re
import socket
import subprocess
import sys
import time
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu_torch.utils import bridge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multiprocess_worker.py")
TIMEOUT_S = 150


def _flax(params):
    return jax.tree.map(np.asarray, params)


def _jax_start():
    from distkeras_tpu.models.mlp import MLP as JMLP

    sample = np.zeros((1, 784), np.float32)
    return _flax(JMLP(features=(16,)).init(jax.random.key(0),
                                           sample)["params"])


def _jbert():
    from distkeras_tpu.models import bert_tiny

    return bert_tiny(num_segments=0)


def _bert_mlm_case():
    """``tests/test_torch_tensor_parallel.py``'s masked_lm case: 32 rows
    of 16 tokens, each row masking a different share of its tokens (1 to
    12 of 16), so the mean of per-process means is not the global mean;
    and the JAX init."""
    rng = np.random.default_rng(2)
    x = rng.integers(1, 256, (32, 16)).astype(np.int32)
    keep = rng.random((32, 16)) < rng.uniform(0.05, 0.75, (32, 1))
    keep[:, 0] = True
    y = np.where(keep, x, -1).astype(np.int32)
    init = _flax(jax.jit(lambda k: _jbert().init(k, x[:1], train=False))(
        jax.random.key(0))["params"])
    return x, y, init


def _make_pool(directory, seed):
    """8 shard files x 64 rows (``tests/test_multihost.py``'s pools)."""
    rng = np.random.default_rng(seed)
    directory.mkdir()
    for i in range(8):
        np.save(directory / f"f{i}.npy",
                rng.standard_normal((64, 784)).astype(np.float32))
        np.save(directory / f"l{i}.npy",
                np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)])
    return directory


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _jax_oracles(pool7):
    """The JAX package's one-process runs of every deterministic
    scenario."""
    import jax.numpy as jnp

    import distkeras_tpu as jdk
    from distkeras_tpu import engine
    from distkeras_tpu.data import GlobalShards
    from distkeras_tpu.evaluators import AccuracyEvaluator, LossEvaluator
    from distkeras_tpu.models.mlp import MLP as JMLP
    from distkeras_tpu.ops import optimizers as opt_lib
    from distkeras_tpu.parallel import mesh as mesh_lib
    from distkeras_tpu.parallel import strategies, substrate

    out = {}
    mesh = mesh_lib.make_mesh(num_workers=8)
    model = JMLP(features=(16,))
    tx = opt_lib.get("sgd", 0.05)
    strategy = strategies.get("adag", learning_rate=0.05)
    state = engine.create_train_state(
        model, jax.random.key(0),
        {"features": jnp.zeros((8, 784), jnp.float32)}, tx)
    center, carries = substrate.init_center_and_carries(
        state.params, tx, strategy, mesh, 8)
    epoch_fn = substrate.build_epoch_fn(
        model, "categorical_crossentropy", tx, strategy, mesh,
        num_workers=8, window=2, metrics=())
    data, _ = substrate.stage_epoch_data(
        jdk.synthetic_mnist(n=512).repartition(8), "features", "label",
        batch_size=8, window=2, mesh=mesh)
    center, carries, ms = epoch_fn(center, carries, data, np.int32(0))
    out["adag_epoch"] = (float(np.asarray(ms["loss"]).mean()),
                         _flax(center))

    def adag(m, ds, **kw):
        t = jdk.ADAG(m, worker_optimizer="sgd", learning_rate=0.05,
                     metrics=(), batch_size=8, communication_window=2,
                     num_epoch=2, num_workers=8, **kw)
        t.train(ds)
        return [h["loss"] for h in t.history], _flax(t.params)

    out["adag"] = adag(JMLP(features=(16,)), jdk.synthetic_mnist(n=512))
    t = jdk.PjitTrainer(JMLP(features=(16,), dropout_rate=0.0),
                        worker_optimizer="sgd", learning_rate=0.1,
                        metrics=(), batch_size=32, num_epoch=2,
                        num_workers=8)
    t.train(jdk.synthetic_mnist(n=512))
    out["pjit"] = ([h["loss"] for h in t.history], _flax(t.params))

    x, y, _ = _bert_mlm_case()
    jm = _jbert()
    t = jdk.PjitTrainer(jm, loss="masked_lm", worker_optimizer="sgd",
                        learning_rate=0.1, batch_size=16, num_workers=2,
                        metrics=())
    t.train(jdk.Dataset({"features": x, "label": y}))
    out["pjit_bert_mlm"] = ([h["loss"] for h in t.history],
                            {n: v.numpy() for n, v in
                             bridge.flax_to_state_dict(_flax(t.params))
                             .items()})

    def pool(seed):
        return GlobalShards({
            "features": [str(pool7 / f"f{i}.npy") for i in range(8)],
            "label": [str(pool7 / f"l{i}.npy") for i in range(8)]},
            seed=seed)

    gs = pool(5)
    out["assignments"] = [[sorted(map(int, a)) for a in
                           gs.epoch_assignment(e, process_count=2)]
                          for e in (0, 1)]
    out["global_shards"] = adag(JMLP(features=(16,), dropout_rate=0.0),
                                pool(5), data_layout="host_sharded")
    full = jdk.synthetic_mnist(n=512)
    jmodel = JMLP(features=(16,), dropout_rate=0.0)
    params = jmodel.init(jax.random.key(0), np.zeros((1, 784), np.float32),
                         train=False)["params"]
    scored = jdk.ModelPredictor(jmodel, params, batch_size=64).predict(full)
    out["predict"] = (
        np.asarray(scored["prediction"]),
        AccuracyEvaluator(label_col="label_index").evaluate(scored),
        LossEvaluator().evaluate(scored))
    return out


class Runs:
    """Both pairs' parsed lines, their saved arrays and the oracles."""

    def __init__(self, directory, outs, oracles):
        self.dir = directory
        self.outs = outs
        self.oracles = oracles
        self.lines = {}
        for (role, rank), text in outs.items():
            for m in re.finditer(r"^SCEN (\S+) (OK|FAIL) (.*)$", text, re.M):
                self.lines[(role, rank, m.group(1))] = (m.group(2),
                                                        m.group(3))

    def get(self, role, name):
        """Both ranks' payloads of scenario ``name`` (failing on FAIL)."""
        got = []
        for rank in (0, 1):
            key = (role, rank, name)
            assert key in self.lines, self.outs[(role, rank)][-3000:]
            status, payload = self.lines[key]
            assert status == "OK", f"rank {rank}: {payload}\n" + \
                self.outs[(role, rank)][-3000:]
            got.append(json.loads(payload))
        return got

    def arrays(self, name, rank):
        with np.load(self.dir / f"{name}.r{rank}.npz") as f:
            return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multiprocess")
    sd = bridge.flax_to_state_dict(_jax_start())
    np.savez(d / "mlp16.npz",
             **{n: np.asarray(v) for n, v in sd.items()})
    from distkeras_tpu_torch.models import bert_tiny

    x, y, init = _bert_mlm_case()
    tm = bert_tiny(num_segments=0)
    bridge.load_flax_params(tm, init)
    np.savez(d / "bert_mlm.npz", x=x, y=y,
             **{f"p/{n}": p.detach().numpy()
                for n, p in tm.named_parameters()})
    pool7 = _make_pool(d / "pool7", seed=7)
    _make_pool(d / "pool11", seed=11)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = {}
    t0 = time.perf_counter()
    try:
        for role in ("sync", "async"):
            port = _free_port()
            for rank in (0, 1):
                procs[(role, rank)] = subprocess.Popen(
                    [sys.executable, WORKER, role, str(rank), port, str(d)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, env=env, cwd=str(d))
        oracles = _jax_oracles(pool7)
        outs = {}
        for key, p in procs.items():
            left = max(1.0, TIMEOUT_S - (time.perf_counter() - t0))
            outs[key] = p.communicate(timeout=left)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for key, p in procs.items():
        assert p.returncode == 0, outs[key][-3000:]
    return Runs(d, outs, oracles)


def _same_on_both_ranks(runs, role, name, arrays=None, lines=True):
    a, b = runs.get(role, name)
    a.pop("_s"), b.pop("_s")
    if lines:
        assert a == b
    if arrays is not None:
        x, y = runs.arrays(arrays, 0), runs.arrays(arrays, 1)
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    return a, b


def _close_tree(port_arrays, flax_params, rtol, atol):
    got = bridge.state_dict_to_flax(
        {n: torch.from_numpy(v) for n, v in port_arrays.items()
         if n not in ("history", "loss", "staleness")})
    for mod, leaves in flax_params.items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(got[mod][leaf], want, rtol=rtol,
                                       atol=atol, err_msg=f"{mod}/{leaf}")


def test_cross_process_psum_over_gloo(runs):
    a, b = runs.get("sync", "psum")
    # 4 positions of 1.0 (process 0) + 4 of 2.0 (process 1)
    assert a["psum"] == b["psum"] == 12.0
    assert a["backend"] == b["backend"] == "gloo"  # no card: the gloo fold
    assert (a["count"], a["index"], b["index"]) == (2, 0, 1)


def test_two_process_adag_epoch_matches_jax(runs):
    a, b = _same_on_both_ranks(runs, "sync", "adag_epoch", "adag_epoch")
    assert a["local_carries"] == 4 and a["rounds"] == 4
    loss, center = runs.oracles["adag_epoch"]
    np.testing.assert_allclose(a["loss"], loss, rtol=1e-5)
    _close_tree(runs.arrays("adag_epoch", 0), center, 1e-5, 1e-6)


@pytest.mark.parametrize("name,oracle", [
    ("full_trainer", "adag"), ("host_sharded", "adag"), ("pjit", "pjit")])
def test_two_process_trainer_matches_jax(runs, name, oracle):
    a, _ = _same_on_both_ranks(runs, "sync", name, name)
    hist, params = runs.oracles[oracle]
    got = runs.arrays(name, 0)
    assert a["n"] == len(hist) == len(got["history"])
    np.testing.assert_allclose(got["history"], hist, rtol=1e-4, atol=1e-5)
    _close_tree(got, params, 1e-4, 1e-5)


@pytest.mark.parametrize("family", ["moe_ep", "bert_mlm"])
def test_two_process_pjit_global_batch_objectives(runs, family):
    """The two-process twins of ``tests/test_torch_tensor_parallel.py::
    test_pjit_global_batch_objectives_match_jax`` (model axis 1: the
    model axis over processes is item 16 part 4). masked_lm over the two
    processes' rows is JAX's one-process PjitTrainer on the global batch:
    every step's loss and the final params rtol 1e-4 / atol 1e-5. The
    capacity-routed MoE, and masked_lm under accum_steps 2, raise naming
    item 16 part 4 on both ranks."""
    a, _ = _same_on_both_ranks(runs, "sync", "pjit_refused")
    if family == "moe_ep":
        assert a["moe_ep"] is True
        return
    assert a["bert_mlm_accum"] is True
    b, _ = _same_on_both_ranks(runs, "sync", "pjit_bert_mlm",
                               "pjit_bert_mlm")
    hist, params = runs.oracles["pjit_bert_mlm"]
    got = runs.arrays("pjit_bert_mlm", 0)
    assert b["n"] == len(hist) == len(got["history"]) == 2
    np.testing.assert_allclose(got["history"], hist, rtol=1e-4, atol=1e-5)
    for n, want in params.items():
        np.testing.assert_allclose(got[n], want, rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_two_process_sync_resume_continues_bitwise(runs):
    a, b = runs.get("sync", "sync_resume")
    assert (a["n"], a["updates"], a["checksum"]) == \
        (b["n"], b["updates"], b["checksum"])
    assert a["n"] == 8 and a["updates"] == 64  # epoch 1: 4 rounds x 8
    assert a["on_disk"] and b["on_disk"] == []  # process 0 writes
    resumed, full = runs.arrays("sync_resume", 1), \
        runs.arrays("full_trainer", 1)
    for n, want in full.items():
        if n != "history":
            np.testing.assert_array_equal(resumed[n], want, err_msg=n)


def test_two_process_averaging_and_ensemble_match_one_process(runs):
    a, _ = _same_on_both_ranks(runs, "sync", "averaging_ensemble")
    # the ensemble's 8 members train alone: bitwise; the average adds
    # each process's 4 replicas, then the two partials (rtol 1e-6 of
    # the one-process sum's order)
    assert a["EnsembleTrainer"] == {"members": 8, "max_abs": 0.0,
                                    "bitwise": True}
    assert a["AveragingTrainer"]["members"] == 1
    assert a["AveragingTrainer"]["max_abs"] <= 1e-6


def test_two_process_global_shards_matches_jax(runs):
    a, b = runs.get("sync", "global_shards")
    want = runs.oracles["assignments"]
    for got in (a, b):
        assert [sorted(x) for x in got["a0"]] == want[0]
        assert [sorted(x) for x in got["a1"]] == want[1]
    assert a["e0"] != a["e1"]  # host 0 re-dealt between epochs
    assert sorted(a["e0"] + b["e0"]) == list(range(8))
    assert sorted(a["e1"] + b["e1"]) == list(range(8))
    _same_on_both_ranks(runs, "sync", "global_shards", "global_shards",
                        lines=False)
    assert (a["n"], a["checksum"]) == (b["n"], b["checksum"])
    hist, params = runs.oracles["global_shards"]
    assert a["n"] == len(hist)
    _close_tree(runs.arrays("global_shards", 0), params, 1e-4, 1e-5)


def test_two_process_host_sharded_inference_matches_jax(runs):
    a, b = runs.get("sync", "predict")
    pred, acc, loss = runs.oracles["predict"]
    for rank, half in ((0, pred[:256]), (1, pred[256:])):
        np.testing.assert_allclose(
            runs.arrays("predict", rank)["prediction"], half, rtol=1e-5,
            atol=1e-6)
    for got in (a, b):
        assert got["acc_global"] == pytest.approx(acc, abs=1e-6)
        np.testing.assert_allclose(got["loss_global"], loss, atol=1e-5)
    assert a["acc_global"] == b["acc_global"]
    assert a["loss_global"] == b["loss_global"]
    assert a["acc_local"] != b["acc_local"]  # the halves differ


def test_process_index_is_the_rank(runs):
    a, b = runs.get("sync", "process_index")
    assert (a["process_index"], b["process_index"]) == (0, 1)


def test_num_workers_below_process_count_raises_on_both(runs):
    a, b = runs.get("sync", "too_few_workers")
    assert a["raised"] and b["raised"]


def test_short_peer_raises_on_both(runs):
    a, b = _same_on_both_ranks(runs, "sync", "short_peer")
    # rank 1's rows cannot form a round: the round (sync) and row
    # (host_async) agreements make both ranks raise
    assert a == {"sync": True, "host_async": True}


def test_spread_fleet_addresses_gathered_on_both(runs):
    a, b = runs.get("sync", "spread_fleet")
    assert a["placement"] == [0, 1] and (a["mine"], b["mine"]) == ([0], [1])
    assert a["addresses"] == b["addresses"]
    assert a["addresses"] == a["own"] + b["own"]
    assert a["token"] == b["token"] == "t0k"  # the token went first


def test_failed_service_start_raises_on_the_peer(runs):
    a, b = runs.get("sync", "failed_start")
    assert a["error"] == "OSError"  # process 0's own bind error
    assert b["error"] == "RuntimeError"
    assert "never came up" in b["message"]
    assert b["seconds"] < 5.0


def _jax_payload(ports, token, error):
    from distkeras_tpu.parallel import remote_ps as jrps

    seen = {}

    def broadcast(payload):
        seen["p"] = np.asarray(payload).copy()
        return payload

    with mock.patch.object(jax, "process_count", lambda: 2), \
            mock.patch.object(jax, "process_index", lambda: 0), \
            mock.patch("jax.experimental.multihost_utils."
                       "broadcast_one_to_all", broadcast), \
            mock.patch("distkeras_tpu.parallel.distributed."
                       "determine_host_address", lambda: "10.1.2.3"):
        jrps.share_service_address(ports, token=token, error=error)
    return seen["p"]


def _port_payload(ports, token, error):
    from distkeras_tpu_torch.parallel import distributed
    from distkeras_tpu_torch.parallel import remote_ps as trps

    seen = {}

    def broadcast(payload):
        seen["p"] = np.asarray(payload).copy()
        return payload

    with mock.patch.object(distributed, "process_count", lambda: 2), \
            mock.patch.object(distributed, "process_index", lambda: 0), \
            mock.patch.object(distributed, "broadcast_one_to_all",
                              broadcast), \
            mock.patch.object(distributed, "determine_host_address",
                              lambda: "10.1.2.3"):
        trps.share_service_address(ports, token=token, error=error)
    return seen["p"]


@pytest.mark.parametrize("ports,token,error", [
    (5000, "abc", False), ([5000, 5001], "tok", False),
    (["10.0.0.9:7000", 7001, "~10.0.0.8:7002"], "t", False),
    ([], "first", False), (5000, None, False), (None, None, True)])
def test_share_service_address_payload_bytes_equal_jax(ports, token, error):
    got = _port_payload(ports, token, error)
    want = _jax_payload(ports, token, error)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (512,)
    np.testing.assert_array_equal(got, want)


def test_two_process_true_async_live_center(runs):
    a, _ = _same_on_both_ranks(runs, "async", "live_center", "live_center")
    # 2 workers a process x 8 rounds an epoch x 6 epochs x 2 processes
    assert a["updates"] == 192 and a["stal_n"] == 192
    assert a["n"] == 384  # window=2 steps a commit
    assert a["stal_sum"] > 0  # commits interleaved across processes
    assert a["heldout"] < 2.3 and a["heldout"] < a["init"] - 0.25


def test_two_process_global_shards_with_live_center(runs):
    a, _ = _same_on_both_ranks(runs, "async", "gs_live_center")
    assert a["updates"] == 32  # 4 workers x 4 rounds x 2 epochs
    assert a["redealt"] and a["union"]


def test_two_process_host_async_resume(runs):
    a, b = runs.get("async", "resume")
    for key in ("updates1", "h0_1", "updates2", "h0_2", "stale_raised"):
        assert a[key] == b[key], key
    assert a["updates1"] == 64  # 4 workers x 8 rounds x 2 epochs
    assert a["updates2"] == 128  # the clock continued
    assert a["h0_2"] < a["h0_1"] - 0.3  # from the trained center
    assert a["stale_raised"] is True
    # process 0 alone writes the snapshots
    assert a["steps_on_disk"] and a["steps_on_disk"][-1] == 128
    assert b["steps_on_disk"] == []


@pytest.mark.parametrize("fleet", ["process0_shards2", "spread_standby"])
def test_two_process_shard_fleets(runs, fleet):
    a, _ = _same_on_both_ranks(runs, "async", "fleet_runs")
    assert a[fleet]["updates"] == 32 and a[fleet]["n"] == 64
