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

A third pair, the axes pair (its own fixture, below), runs the model,
sequence and pipeline axes over the two processes in two layouts (a row
a process, and one row over both), against JAX's one-process runs and
the port's own.
"""

import json
import os
import re
import socket
import subprocess
import sys
import threading
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


def _bert_rows():
    """``tests/test_torch_tensor_parallel.py``'s masked_lm case: 32 rows
    of 16 tokens, each row masking a different share of its tokens (1 to
    12 of 16), so the mean of per-process means is not the global mean."""
    rng = np.random.default_rng(2)
    x = rng.integers(1, 256, (32, 16)).astype(np.int32)
    keep = rng.random((32, 16)) < rng.uniform(0.05, 0.75, (32, 1))
    keep[:, 0] = True
    return x, np.where(keep, x, -1).astype(np.int32)


def _bert_mlm_case():
    """:func:`_bert_rows` and the JAX init."""
    x, y = _bert_rows()
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
    outs, oracles = _run_pairs(d, ("sync", "async"),
                               lambda: _jax_oracles(pool7))
    return Runs(d, outs, oracles)


def _run_pairs(d, roles, oracles_fn):
    """Start a pair of worker ranks a role (each pair its own gloo group),
    run ``oracles_fn()`` meanwhile, and return every rank's output and
    the oracles; every rank is killed in a ``finally``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = {}
    t0 = time.perf_counter()
    try:
        for role in roles:
            port = _free_port()
            for rank in (0, 1):
                procs[(role, rank)] = subprocess.Popen(
                    [sys.executable, WORKER, role, str(rank), port, str(d)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, env=env, cwd=str(d))
        oracles = oracles_fn()
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
    return outs, oracles


def _same_on_both_ranks(runs, role, name, arrays=None, lines=True,
                        own=()):
    """Both ranks' payloads of ``name``, equal but for the keys ``own``
    (each rank's own view), and their saved ``arrays`` equal."""
    a, b = runs.get(role, name)
    a.pop("_s"), b.pop("_s")
    if lines:
        assert {k: v for k, v in a.items() if k not in own} == \
            {k: v for k, v in b.items() if k not in own}
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
def test_two_process_pjit_global_batch_objectives(runs, axes, family):
    """The two-process twins of ``tests/test_torch_tensor_parallel.py::
    test_pjit_global_batch_objectives_match_jax``, on the workers 2 x
    model 2 mesh with a row a process: the capacity-routed MoE under
    ``ep_partition_rules()``, and BERT's masked_lm under accum_steps 2,
    gather the global batch on each rank and take the one-process step:
    every step's loss and the final params bitwise the port's
    one-process run (checked on each rank), equal on both ranks, and
    rtol 1e-4 / atol 1e-5 of JAX's PjitTrainer on the same mesh shape.
    masked_lm at accum_steps 1 over the two processes' rows (model axis
    1, host-sharded) folds their token sums: JAX's one-process run on the
    global batch within the same bounds."""
    a, _ = _same_on_both_ranks(axes, "axes", "pjit_coupled",
                               f"coupled_{family}")
    assert a[family]["n"] == 2 and a[family]["bitwise"] is True
    hist, params = axes.oracles[f"coupled_{family}"]
    got = axes.arrays(f"coupled_{family}", 0)
    np.testing.assert_allclose(got["history"], hist, rtol=1e-4, atol=1e-5)
    for n, want in params.items():
        np.testing.assert_allclose(got[n], want, rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    if family == "moe_ep":
        return
    b, _ = _same_on_both_ranks(runs, "sync", "pjit_bert_mlm",
                               "pjit_bert_mlm")
    hist, params = runs.oracles["pjit_bert_mlm"]
    got = runs.arrays("pjit_bert_mlm", 0)
    assert b["n"] == len(hist) == len(got["history"]) == 2
    np.testing.assert_allclose(got["history"], hist, rtol=1e-4, atol=1e-5)
    for n, want in params.items():
        np.testing.assert_allclose(got[n], want, rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_two_process_pjit_quantized_precision_is_one_process_bitwise(axes):
    """``PjitTrainer(gpt_tiny(num_layers=1), precision="int8")`` on the
    workers 2 x model 2 mesh with a row a process: the activation scale is
    the global batch's ``amax``, so each rank gathers the global batch
    (int16 ids, carried as bytes) and every step's loss and the final
    params are the port's one-process run's bit for bit, on both
    ranks."""
    a, _ = _same_on_both_ranks(axes, "axes", "pjit_coupled",
                               "coupled_gpt_int8")
    assert a["gpt_int8"]["n"] == 2 and a["gpt_int8"]["bitwise"] is True


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


# -- the axes pair: the model, sequence and pipeline axes over processes ------
#
# A third pair of ranks (its own fixture, started at its first test) runs
# the worker's axes scenarios on two layouts: rows inside a process (each
# rank passes two ``cpu`` devices) and a row spanning both ranks (each
# passes one). Its JAX oracles run in this process meanwhile, from the
# same starts (JAX's inits, bridged). Bounds: ``PjitTrainer`` rtol 1e-4 /
# atol 1e-5 (``tests/test_torch_tensor_parallel.py``'s); the sequence step
# and the pipelines, the loss rtol 1e-5 and the parameters rtol 5e-5 /
# atol 5e-6 (``tests/test_torch_sequence.py``'s and
# ``tests/test_torch_pipeline.py``'s); the ranks bit for bit; the spanning
# ring forward, the coupled objectives and both pipelines bit for bit the
# port's one-process runs (checked on each rank).

PP_LM = dict(vocab_size=64, max_len=32, num_layers=4, num_heads=2, width=32,
             mlp_dim=64, num_stages=4)
#: ``gpt_tiny``'s widths at one layer (the worker's ``GPT``): the JAX
#: oracles' compiles are the group's cost
GPT = dict(num_layers=1)


def _gpt_rows():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (32, 16)).astype(np.int32)
    return x, _shift(x)


def _shift(ids):
    from distkeras_tpu.parallel import sequence as jseq

    return jseq.shift_labels(ids)


def _flax_stages():
    import flax.linen as nn

    class ConvPool(nn.Module):
        channels: int

        @nn.compact
        def __call__(self, x):
            y = nn.relu(nn.Conv(self.channels, (3, 3), name="conv")(x))
            return nn.avg_pool(y, (2, 2), strides=(2, 2))

    class DenseRelu(nn.Module):
        width: int

        @nn.compact
        def __call__(self, x):
            return nn.relu(nn.Dense(self.width, name="fc")(x))

    class Head(nn.Module):
        classes: int

        @nn.compact
        def __call__(self, x):
            return nn.Dense(self.classes, name="out")(
                x.reshape((x.shape[0], -1)))

    return [ConvPool(8), ConvPool(16), DenseRelu(32), Head(5)]


def _axes_starts(d):
    """The axes pair's start weights and batches, written under ``d``:
    seeded port inits (no JAX init; the oracles start from the same
    weights, bridged). Returns what the oracles need."""
    from distkeras_tpu_torch.models import bert_tiny, gpt, moe
    from distkeras_tpu_torch.parallel import pipeline

    def sd(model, prefix="p/"):
        return {f"{prefix}{n}": v.detach().numpy().copy()
                for n, v in model.state_dict().items()}

    def seeded(build, seed):
        with torch.random.fork_rng():
            torch.manual_seed(seed)
            return build()

    x, y = _gpt_rows()
    gpt0 = sd(gpt.init_params(gpt.gpt_tiny(**GPT),
                              torch.Generator().manual_seed(0)))
    np.savez(d / "axes_gpt.npz", x=x, y=y, **gpt0)
    ids = np.random.default_rng(0).integers(0, 256, (4, 64)).astype(np.int32)
    np.savez(d / "axes_sp.npz", ids=ids, labels=_shift(ids), **gpt0)
    rng = np.random.default_rng(2)
    xm = rng.standard_normal((32, 8, 16)).astype(np.float32)
    ym = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 32)]
    moe_kw = dict(num_layers=1, num_heads=2, num_experts=4, mlp_dim=32,
                  capacity_factor=0.5)
    moe0 = sd(seeded(lambda: moe.MoEClassifier(
        4, dtype=torch.float32, width=16, **moe_kw), 1))
    np.savez(d / "axes_moe.npz", x=xm, y=ym, **moe0)
    xb, yb = _bert_rows()
    bert0 = sd(seeded(lambda: bert_tiny(num_segments=0), 2))
    np.savez(d / "axes_bert.npz", x=xb, y=yb, **bert0)
    lm_ids = np.random.default_rng(0).integers(0, 64, (8, 16)).astype(
        np.int32)
    lm0 = sd(pipeline.PipelinedLM(**PP_LM, device="cpu").init(0), "")
    np.savez(d / "axes_pp_lm.npz", ids=lm_ids, labels=_shift(lm_ids),
             **{f"p/{n}": v for n, v in lm0.items()})
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((8, 8, 8, 3)).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 8)]
    gp0 = seeded(lambda: [
        {"conv.weight": torch.randn(8, 3, 3, 3) * 0.2,
         "conv.bias": torch.zeros(8)},
        {"conv.weight": torch.randn(16, 8, 3, 3) * 0.1,
         "conv.bias": torch.zeros(16)},
        {"fc.weight": torch.randn(32, 16) * 0.25, "fc.bias": torch.zeros(32)},
        {"out.weight": torch.randn(5, 128) * 0.09,
         "out.bias": torch.zeros(5)}], 3)
    np.savez(d / "axes_pp_generic.npz", features=feats, labels=labels,
             **{f"p{k}/{n}": v.numpy() for k, st in enumerate(gp0)
                for n, v in st.items()})

    def flax(arrays):
        return bridge.state_dict_to_flax(
            {n[2:]: torch.from_numpy(v) for n, v in arrays.items()})

    return {"moe_kw": moe_kw, "gpt0": flax(gpt0), "moe0": flax(moe0),
            "bert0": flax(bert0),
            "lm0": bridge.state_dict_to_pipelined_lm(
                {n: torch.from_numpy(v) for n, v in lm0.items()}),
            "gp0": bridge.state_dicts_to_pipeline_stages(tuple(gp0)),
            "lm_ids": lm_ids, "feats": feats, "labels": labels, "ids": ids,
            "x": x, "y": y, "xm": xm, "ym": ym, "xb": xb, "yb": yb}


def _port_arrays(flax_params):
    """A flax tree as the port's name -> numpy array state dict."""
    return {n: v.numpy() for n, v in
            bridge.flax_to_state_dict(_flax(flax_params)).items()}


def _axes_trainer_oracles(st):
    """JAX's one-process ``PjitTrainer`` runs of the axes pair's
    scenarios, from the pair's start weights (JAX's trainers take them in
    place of their init)."""
    import jax.numpy as jnp

    import distkeras_tpu as jdk
    from distkeras_tpu import engine as jengine
    from distkeras_tpu.models.gpt import gpt_tiny as jgpt
    from distkeras_tpu.models.moe import MoEClassifier as JMoE
    from distkeras_tpu.models.moe import ep_partition_rules as jep

    def started(params):
        return lambda model, key, batch, tx: jengine.TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            opt_state=tx.init(params))

    out = {}
    runs = [(name, st["gpt0"], jgpt(**GPT), (st["x"], st["y"]),
             dict(loss="masked_lm", worker_optimizer="momentum",
                  num_workers=workers, num_epoch=epochs))
            for name, workers, epochs in (("pjit_rows", 2, 1),
                                          ("pjit_span", 1, 2))]
    runs += [("coupled_moe_ep", st["moe0"], JMoE(
        num_classes=4, dtype=jnp.float32, **st["moe_kw"]),
        (st["xm"], st["ym"]), dict(loss="categorical_crossentropy",
                                   partition_rules=jep(),
                                   worker_optimizer="sgd", num_workers=2)),
             ("coupled_bert_mlm", st["bert0"], _jbert(), (st["xb"], st["yb"]),
              dict(loss="masked_lm", accum_steps=2, worker_optimizer="sgd",
                   num_workers=2))]
    for name, start, model, (x, y), kw in runs:
        with mock.patch.object(jengine, "create_train_state",
                               started(start)):
            t = jdk.PjitTrainer(model, learning_rate=0.1, batch_size=16,
                                metrics=(), model_parallelism=2, **kw)
            t.train(jdk.Dataset({"features": x, "label": y}))
        out[name] = ([h["loss"] for h in t.history], _port_arrays(t.params))
    return out


def _axes_step_oracles(st):
    """JAX's one-process sequence-parallel and pipeline steps of the axes
    pair's scenarios, from the pair's start weights."""
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from distkeras_tpu import engine as jengine
    from distkeras_tpu.models.gpt import gpt_tiny as jgpt
    from distkeras_tpu.parallel import mesh as jmesh
    from distkeras_tpu.parallel import pipeline as jpp
    from distkeras_tpu.parallel import sequence as jseq

    out = {}
    mesh = jseq.make_sp_mesh(num_workers=2, seq_parallelism=2)
    model = jgpt(attention="ring", **GPT)
    tx = optax.sgd(0.1)
    state = jmesh.put_global(jengine.TrainState(
        step=jnp.zeros((), jnp.int32), params=st["gpt0"],
        opt_state=tx.init(st["gpt0"])), NamedSharding(mesh, JP()))
    step_fn, _, place_batch = jseq.build_sp_train_step(model, tx, mesh)
    state, ms = step_fn(state, place_batch(
        {"input_ids": st["ids"], "labels": _shift(st["ids"])}))
    out["sp"] = ({k: float(v) for k, v in ms.items()},
                 _port_arrays(jax.device_get(state.params)))
    model = jpp.PipelinedLM(**PP_LM)
    step_fn, place_params, place_batch = model.build_train_step(
        tx, jpp.make_pp_mesh(4), num_microbatches=4)
    p = place_params(st["lm0"])
    p, _, ms = step_fn(p, tx.init(p), place_batch(
        {"input_ids": st["lm_ids"], "labels": _shift(st["lm_ids"])}))
    out["pp_lm"] = ({k: float(v) for k, v in ms.items()},
                    {n: v.numpy() for n, v in
                     bridge.pipelined_lm_to_state_dict(
                         _flax(jax.device_get(p))).items()})
    pipe = jpp.GenericPipeline(_flax_stages(), num_microbatches=2)
    jax.jit(lambda k: pipe.init(k, st["feats"][:4]))(jax.random.key(0))
    step, place_params, place_batch = pipe.build_train_step(
        tx, jpp.make_pp_mesh(4))
    p = place_params(st["gp0"])
    p, _, ms = step(p, tx.init(p), place_batch(
        {"features": st["feats"], "labels": st["labels"]}))
    out["pp_generic"] = ({"loss": float(ms["loss"])}, {
        f"{k}/{n}": v.numpy() for k, stage in enumerate(
            bridge.pipeline_stages_to_state_dicts(_flax(jax.device_get(p))))
        for n, v in stage.items()})
    return out


def _axes_oracles(st):
    """Both oracle groups at once (the steps' on a thread of their own:
    the XLA compiles are the group's cost)."""
    box = {}

    def steps():
        try:
            box["out"] = _axes_step_oracles(st)
        except BaseException as e:  # re-raised in the fixture's thread
            box["error"] = e

    thread = threading.Thread(target=steps)
    thread.start()
    try:
        out = _axes_trainer_oracles(st)
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return {**out, **box["out"]}


@pytest.fixture(scope="module")
def axes(tmp_path_factory):
    d = tmp_path_factory.mktemp("axes")
    starts = _axes_starts(d)
    outs, oracles = _run_pairs(d, ("axes",), lambda: _axes_oracles(starts))
    return Runs(d, outs, oracles)


MESHES = {  # scenario key -> (shape, device_owners, local positions a rank)
    "rows": ({"workers": 2, "model": 2}, [[0, 0], [1, 1]], ([0], [1]), 1),
    "span": ({"workers": 1, "model": 2}, [[0, 1]], ([0], [0]), 2),
    "sp_rows": ({"workers": 2, "seq": 2}, [[0, 0], [1, 1]], ([0], [1]), 1),
    "sp_span": ({"workers": 1, "seq": 2}, [[0, 1]], ([0], [0]), 2),
    "pp": ({"workers": 1, "stages": 4}, [[0, 0, 1, 1]], ([0], [0]), 2),
}


@pytest.mark.parametrize("key", sorted(MESHES))
def test_two_process_meshes_over_processes(axes, key):
    """``multihost_mesh``/``make_mesh`` at model 2 with a row a process
    (each rank passes two devices) and with one row over both ranks
    (each passes one), the sequence meshes in both layouts and a
    4-stage pipeline mesh over two ranks: the shape, each device's owner,
    each row's lead, the positions each rank runs and its home."""
    a, b = axes.get("axes", "meshes")
    shape, owners, local, span = MESHES[key]
    for rank, got in enumerate((a[key], b[key])):
        assert got["shape"] == shape
        assert got["device_owners"] == owners
        assert got["owners"] == [row[0] for row in owners]
        assert got["local"] == local[rank]
        assert got["spans"] is True and got["home"] == "cpu"
        assert got["row_processes"] == span


def test_two_process_hop_forward_and_backward(axes):
    """The hop Function alone: each rank sends a tensor and receives its
    peer's bit for bit, and its backward returns to each rank the
    gradient its peer took of what it received (``(got * w).sum()``: the
    peer's ``w``); a send-only rank 0 runs its backward off the token and
    gets rank 1's gradient of ``(2 y) ** 2`` by ``y`` (``8 y``)."""
    a, b = axes.get("axes", "hop")
    for got in (a, b):
        assert got["forward"] is True and got["backward"] is True
    assert a["one_way"] == (8 * np.arange(6.0).reshape(2, 3)).tolist()


@pytest.mark.parametrize("layout", ["pjit_rows", "pjit_span"])
def test_two_process_pjit_model_axis_matches_jax(axes, layout):
    """``PjitTrainer(gpt_tiny(num_layers=1), loss="masked_lm")`` under
    the tensor rules on workers 2 x model 2 (a row a process) and on
    workers 1 x model 2 over both ranks: every step's loss and the final
    params against JAX's one-process PjitTrainer on the same mesh shape,
    and the ranks bit for bit."""
    a, _ = _same_on_both_ranks(axes, "axes", layout, layout,
                               own=("on_disk",))
    hist, params = axes.oracles[layout]
    got = axes.arrays(layout, 0)
    assert a["n"] == len(hist) == len(got["history"])
    np.testing.assert_allclose(got["history"], hist, rtol=1e-4, atol=1e-5)
    for n, want in params.items():
        np.testing.assert_allclose(got[n], want, rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    assert a["sharded"] == 6  # qkv, out, fc1, fc2, embed, head


def test_two_process_pjit_span_holds_half_and_resumes(axes):
    """On the row over both ranks each holds half of every sharded
    parameter's bytes and half of its optimizer state (momentum), where a
    row a process holds them whole; process 0 alone writes the
    checkpoint, gathered, and a run resumed from epoch 0's ends bit for
    bit where the uninterrupted run ends; under LAMB (its trust ratio
    over the whole tensor, whose shards two ranks hold) the run is the
    one-process run's bits."""
    a, b = axes.get("axes", "pjit_span")
    rows, _ = axes.get("axes", "pjit_rows")
    for got in (a, b):
        assert 2 * got["held"] == got["whole"] > 0
        assert 2 * got["opt_held"] == got["opt_whole"] == got["whole"]
        assert got["resumed_bitwise"] is True and got["resumed_n"] == 2
        assert got["lamb_bitwise"] is True
    assert rows["held"] == rows["whole"] == a["whole"]
    assert a["on_disk"] == ["0", "1"] and b["on_disk"] == []


@pytest.mark.parametrize("layout", ["sp_rows", "sp_span"])
def test_two_process_sp_step_matches_jax(axes, layout):
    """``build_sp_train_step`` at workers 2 x seq 2 (a row a process) and
    workers 1 x seq 2 over both ranks, one sgd step of ``gpt_tiny(
    attention="ring", num_layers=1)``: the loss and accuracy rtol 1e-5
    and the params rtol 5e-5 / atol 5e-6 of JAX's step at workers 2 x
    seq 2 (the step is the global batch's whatever the mesh), the ranks
    bit for bit."""
    a, _ = _same_on_both_ranks(axes, "axes", layout, layout,
                               own=("remote",))
    jms, params = axes.oracles["sp"]
    np.testing.assert_allclose(a["loss"], jms["loss"], rtol=1e-5)
    np.testing.assert_allclose(a["accuracy"], jms["accuracy"], rtol=1e-5)
    got = axes.arrays(layout, 0)
    for n, want in params.items():
        np.testing.assert_allclose(got[n], want, rtol=5e-5, atol=5e-6,
                                   err_msg=n)


def test_two_process_sp_span_forward_is_the_one_process_ring(axes):
    """Over the spanning row each rank holds its own block (the other a
    ``Remote``) and its logits are the bits of the one-process ring's
    block; the step's loss is the one-process step's."""
    a, b = axes.get("axes", "sp_span")
    assert a["remote"] == ["Tensor", "Remote"]
    assert b["remote"] == ["Remote", "Tensor"]
    for got in (a, b):
        assert got["forward_bitwise"] is True
        assert got["loss"] == got["one_process_loss"]


@pytest.mark.parametrize("name", ["pp_lm", "pp_generic"])
def test_two_process_pipelines_match_jax(axes, name):
    """``PipelinedLM`` (4 stages x 1 layer, M = 4) and ``GenericPipeline``
    (4 heterogeneous stages, M = 2) with stages 0-1 on rank 0 and 2-3 on
    rank 1, one sgd step: each rank holds only its stages, their params
    are bit for bit the port's one-process pipeline's, both ranks return
    the same metrics, and the loss (rtol 1e-5) and params (rtol 5e-5 /
    atol 5e-6) are JAX's pipeline's."""
    a, b = axes.get("axes", name)
    assert a["metrics"] == b["metrics"]
    assert a["bitwise"] is True and b["bitwise"] is True
    jms, params = axes.oracles[name]
    for k, v in jms.items():
        np.testing.assert_allclose(a["metrics"][k], v, rtol=1e-5, atol=1e-6)
    assert not set(a["owned"]) & set(b["owned"])
    assert sorted(a["owned"] + b["owned"]) == sorted(params)
    for rank in (0, 1):
        for n, v in axes.arrays(name, rank).items():
            np.testing.assert_allclose(v, params[n], rtol=5e-5, atol=5e-6,
                                       err_msg=n)
