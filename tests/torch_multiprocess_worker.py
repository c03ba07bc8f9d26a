"""One rank of the two-process runs of ``tests/test_torch_multiprocess.py``.

Usage: ``python torch_multiprocess_worker.py {sync,async,axes} RANK PORT
DIR``.
The rank joins a two-process gloo group on ``127.0.0.1:PORT`` through
``distributed.initialize`` and runs its pair's scenarios in order, on
``device="cpu"`` with one intra-op thread. Each scenario prints one line,
``SCEN <name> OK <json>`` or ``SCEN <name> FAIL <error>``; arrays too long
for a line are saved under ``DIR`` as ``<name>.r<RANK>.npz``. The start
weights (``DIR/mlp16.npz``, a JAX init bridged to a state_dict) and the
shard pools (``DIR/pool7``, ``DIR/pool11``) are the test's, and so are
the axes pair's start weights and batches (``DIR/axes_*.npz``). Imports
no JAX.
"""

import json
import os
import socket
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

torch.set_num_threads(1)

ROLE, RANK, PORT, DIR = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]

import distkeras_tpu_torch as dk  # noqa: E402
from distkeras_tpu_torch import telemetry  # noqa: E402
from distkeras_tpu_torch.data import GlobalShards  # noqa: E402
from distkeras_tpu_torch.models.mlp import MLP, init_params  # noqa: E402
from distkeras_tpu_torch.ops import losses as losses_lib  # noqa: E402
from distkeras_tpu_torch.ops import optimizers as opt_lib  # noqa: E402
from distkeras_tpu_torch.parallel import (collectives, distributed,  # noqa
                                          elastic, host_async, remote_ps,
                                          strategies, substrate)

distributed.initialize(coordinator_address=f"127.0.0.1:{PORT}",
                       num_processes=2, process_id=RANK, timeout_s=60)


def mlp16(dropout_rate=None):
    kw = {} if dropout_rate is None else {"dropout_rate": dropout_rate}
    model = MLP(features=(16,), **kw)
    sd = np.load(os.path.join(DIR, "mlp16.npz"))
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(sd[n]))
    return model


def mlp32(seed, dropout_rate=None):
    kw = {} if dropout_rate is None else {"dropout_rate": dropout_rate}
    return init_params(MLP(features=(32,), **kw),
                       torch.Generator().manual_seed(seed))


def mesh8():
    # 4 worker positions a process, 8 in all (JAX's multihost_mesh over
    # 4 CPU devices a process)
    return distributed.multihost_mesh(num_workers=8, devices=["cpu"] * 4)


def save(name, **arrays):
    np.savez(os.path.join(DIR, f"{name}.r{RANK}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def params_np(params):
    return {n: t.detach().cpu().numpy() for n, t in params.items()}


def checksum(params):
    return float(sum(np.abs(p.detach().cpu().numpy()).astype(np.float64)
                     .sum() for p in params.values()))


def history(trainer):
    return np.array([h["loss"] for h in trainer.history], np.float64)


# -- the sync pair ------------------------------------------------------------

def s_psum():
    # 4 positions of value rank + 1 folded locally, then across
    local = [torch.full((1,), float(RANK + 1)) for _ in range(4)]
    part = collectives.bucketed_psum([{"x": t} for t in local])
    total = collectives.cross_process_sum(part)["x"]
    _, backend = distributed.fold_group()
    return {"psum": float(total[0]), "backend": backend,
            "count": distributed.process_count(),
            "index": distributed.process_index()}


def s_adag_epoch():
    mesh = mesh8()
    model = mlp16()
    tx = opt_lib.get("sgd", 0.05)
    strategy = strategies.get("adag", learning_rate=0.05)
    params = {n: p.detach() for n, p in model.named_parameters()}
    center, carries = substrate.init_center_and_carries(
        params, tx, strategy, mesh, 8)
    epoch_fn = substrate.build_epoch_fn(
        model, "categorical_crossentropy", tx, strategy, mesh,
        num_workers=8, window=2, metrics=())
    data, rounds = substrate.stage_epoch_data(
        dk.synthetic_mnist(n=512).repartition(8), "features", "label",
        batch_size=8, window=2, mesh=mesh)
    center, carries, ms = epoch_fn(center, carries, data, 0)
    save("adag_epoch", loss=ms["loss"].numpy(), **params_np(center))
    return {"loss": float(ms["loss"].mean()), "checksum": checksum(center),
            "local_carries": len(carries), "rounds": rounds}


def _adag(model, num_epoch=2, **kw):
    return dk.ADAG(model, worker_optimizer="sgd", learning_rate=0.05,
                   metrics=(), batch_size=8, communication_window=2,
                   num_epoch=num_epoch, **kw)


def s_full_trainer():
    t = _adag(mlp16(), mesh=mesh8())
    params = t.train(dk.synthetic_mnist(n=512))
    save("full_trainer", history=history(t), **params_np(params))
    return {"n": len(t.history), "checksum": checksum(params)}


def s_sync_resume():
    # epoch 0, then a resumed run for epoch 1: process 0 writes the
    # center and every worker's carry, every process reads them back
    ckdir = os.path.join(DIR, "sync_ck")
    ds = dk.synthetic_mnist(n=512)
    _adag(mlp16(), num_epoch=1, mesh=mesh8(), checkpoint_dir=ckdir).train(ds)
    t = _adag(mlp16(), mesh=mesh8(), checkpoint_dir=ckdir)
    params = t.train(ds, resume=True)
    save("sync_resume", **params_np(params))
    steps = sorted(os.listdir(ckdir)) if RANK == 0 else []
    return {"n": len(t.history), "updates": t.num_updates,
            "checksum": checksum(params),
            "on_disk": [x for x in steps if x.isdigit()]}


def s_averaging_ensemble():
    # the two non-exchanging trainers over the two-process mesh against
    # the same trainers on a one-process 8-worker mesh built by hand
    # (owned by this rank alone: no collective)
    ds = dk.synthetic_mnist(n=512)
    out = {}
    for name in ("AveragingTrainer", "EnsembleTrainer"):
        got = {}
        for key, mesh in (("multi", mesh8()),
                          ("one", dk.parallel.mesh.Mesh(["cpu"] * 8))):
            t = getattr(dk, name)(mlp16(), worker_optimizer="sgd",
                                  learning_rate=0.05, metrics=(),
                                  batch_size=8, communication_window=2,
                                  num_epoch=1, mesh=mesh)
            got[key] = t.train(ds)
        pairs = list(zip(got["multi"], got["one"])) \
            if isinstance(got["one"], list) else [(got["multi"], got["one"])]
        out[name] = {
            "members": len(pairs),
            "max_abs": max(float((a[n] - b[n]).abs().max())
                           for a, b in pairs for n in b),
            "bitwise": all(torch.equal(a[n], b[n])
                           for a, b in pairs for n in b)}
    return out


def s_process_index():
    # set by the trainers' start (the full trainer ran before)
    return {"process_index": telemetry.process_index()}


def s_host_sharded():
    full = dk.synthetic_mnist(n=512)
    lo, hi = (0, 256) if RANK == 0 else (256, 512)
    d = tempfile.mkdtemp(dir=DIR)
    paths = {}
    for col in ("features", "label"):
        paths[col] = os.path.join(d, f"{col}.npy")
        np.save(paths[col], np.asarray(full[col][lo:hi]))
    t = _adag(mlp16(), mesh=mesh8(), data_layout="host_sharded")
    params = t.train(dk.Dataset.from_files(paths))
    save("host_sharded", history=history(t), **params_np(params))
    return {"n": len(t.history), "checksum": checksum(params)}


def s_pjit():
    full = dk.synthetic_mnist(n=512)
    b, half = 32, 16
    rows = np.concatenate([np.arange(s * b + RANK * half,
                                     s * b + (RANK + 1) * half)
                           for s in range(512 // b)])
    ds = dk.Dataset({c: np.asarray(full[c])[rows] for c in full.columns})
    t = dk.PjitTrainer(mlp16(dropout_rate=0.0), worker_optimizer="sgd",
                       learning_rate=0.1, metrics=(), batch_size=b,
                       num_epoch=2, mesh=mesh8(),
                       data_layout="host_sharded")
    params = t.train(ds)
    save("pjit", history=history(t), **params_np(params))
    return {"n": len(t.history), "checksum": checksum(params)}


def _bert_mlm():
    from distkeras_tpu_torch.models import bert_tiny

    model = bert_tiny(num_segments=0)
    with np.load(os.path.join(DIR, "bert_mlm.npz")) as f:
        data = {k: f[k] for k in f.files}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(data[f"p/{n}"]))
    # each step's 16 rows: rows 0-7 on process 0, 8-15 on process 1
    rows = np.concatenate([np.arange(s * 16 + RANK * 8, s * 16 + RANK * 8 + 8)
                           for s in range(len(data["x"]) // 16)])
    return model, dk.Dataset({"features": data["x"][rows],
                              "label": data["y"][rows]})


def _pjit2(model, **kw):
    return dk.PjitTrainer(model, worker_optimizer="sgd", learning_rate=0.1,
                          batch_size=16, metrics=(),
                          mesh=distributed.multihost_mesh(
                              num_workers=2, devices=["cpu"]),
                          data_layout="host_sharded", **kw)


def s_pjit_bert_mlm():
    # masked_lm over the two processes' rows: the global token mean
    model, ds = _bert_mlm()
    t = _pjit2(model, loss="masked_lm")
    params = t.train(ds)
    save("pjit_bert_mlm", history=history(t), **params_np(params))
    return {"n": len(t.history), "checksum": checksum(params)}


def s_global_shards():
    pool = os.path.join(DIR, "pool7")
    gs = GlobalShards({
        "features": [os.path.join(pool, f"f{i}.npy") for i in range(8)],
        "label": [os.path.join(pool, f"l{i}.npy") for i in range(8)]},
        seed=5)
    a = [gs.epoch_assignment(e) for e in (0, 1)]
    t = _adag(mlp16(dropout_rate=0.0), mesh=mesh8(),
              data_layout="host_sharded")
    params = t.train(gs)
    save("global_shards", **params_np(params))
    return {"e0": sorted(a[0][RANK]), "e1": sorted(a[1][RANK]),
            "a0": [list(map(int, x)) for x in a[0]],
            "a1": [list(map(int, x)) for x in a[1]],
            "n": len(t.history), "checksum": checksum(params)}


def s_predict():
    from distkeras_tpu_torch.evaluators import (AccuracyEvaluator,
                                                LossEvaluator)

    full = dk.synthetic_mnist(n=512)
    lo, hi = (0, 256) if RANK == 0 else (256, 512)
    ds = dk.Dataset({c: np.asarray(full[c])[lo:hi] for c in full.columns})
    scored = dk.ModelPredictor(mlp16(dropout_rate=0.0), batch_size=64,
                               device="cpu").predict(ds)
    pred = np.asarray(scored["prediction"])
    save("predict", prediction=pred)
    return {
        "acc_local": AccuracyEvaluator(
            label_col="label_index").evaluate(scored),
        "acc_global": AccuracyEvaluator(
            label_col="label_index", across_processes=True).evaluate(scored),
        "loss_global": LossEvaluator(
            across_processes=True).evaluate(scored)}


def s_too_few_workers():
    t = dk.ADAG(mlp16(), num_workers=1, mode="host_async", device="cpu",
                batch_size=8, communication_window=2)
    try:
        t.train(dk.synthetic_mnist(n=64))
    except ValueError as e:
        return {"raised": "process_count=2" in str(e)}
    return {"raised": False}


def s_short_peer():
    # rank 1 holds 8 rows: no round of window 2 x batch 8 for its
    # workers; both ranks must raise, sync and host_async
    full = dk.synthetic_mnist(n=512)
    rows = 256 if RANK == 0 else 8
    ds = dk.Dataset({c: np.asarray(full[c])[:rows] for c in full.columns})
    out = {}
    for name, build in (
            ("sync", lambda: _adag(mlp16(), mesh=mesh8(),
                                   data_layout="host_sharded")),
            ("host_async", lambda: _adag(mlp16(), num_workers=2,
                                         mode="host_async", device="cpu",
                                         data_layout="host_sharded"))):
        try:
            build().train(ds)
            out[name] = None
        except ValueError as e:
            out[name] = "cannot form" in str(e)
    distributed.barrier()
    return out


def s_spread_fleet():
    like = {"w": np.ones((4, 3), np.float32), "b": np.zeros((3,), np.float32)}
    placement = elastic.shard_placement(2, 2, "spread")
    mine = [s for s in range(2) if placement[s] == RANK]
    if RANK == 0:  # the token travels first
        _, token = remote_ps.share_service_address([], token="t0k")
    else:
        _, token = remote_ps.share_service_address(None)
    services = elastic.make_ps_fleet(
        lambda part: host_async.server_for(
            strategies.get("adag", learning_rate=0.05),
            [torch.from_numpy(np.array(x)) for x in part]),
        like, 2, host="127.0.0.1", token=token, expected_processes=2,
        advertise_host="127.0.0.1", local_shards=mine)
    try:
        addresses, standby = elastic.gather_fleet_addresses(services, 2)
        distributed.barrier()
    finally:
        for svc in services:
            svc.stop()
    return {"placement": placement, "mine": mine, "addresses": addresses,
            "standby": standby, "token": token,
            "own": [svc.advertised for svc in services]}


def s_failed_start():
    runner = host_async.HostAsyncRunner(
        mlp16(), "categorical_crossentropy", opt_lib.get("sgd", 0.05),
        strategies.get("adag", learning_rate=0.05), 2, device="cpu")
    blocker = None
    port = 0
    if RANK == 0:
        # process 0's service cannot bind: its port is taken
        blocker = socket.socket()
        blocker.bind(("0.0.0.0", 0))
        blocker.listen(1)
        port = blocker.getsockname()[1]
    params = {n: p.detach() for n, p in runner.model.named_parameters()}
    distributed.barrier()
    t0 = time.perf_counter()
    try:
        host_async.run_cross_process(runner, params, [[[]]],
                                     worker_offset=RANK, service_port=port)
    except RuntimeError as e:
        return {"error": "RuntimeError", "message": str(e),
                "seconds": time.perf_counter() - t0}
    except OSError as e:
        return {"error": "OSError", "message": str(e),
                "seconds": time.perf_counter() - t0}
    finally:
        if blocker is not None:
            blocker.close()
    return {"error": None}


SYNC = [("psum", s_psum), ("adag_epoch", s_adag_epoch),
        ("full_trainer", s_full_trainer), ("process_index", s_process_index),
        ("sync_resume", s_sync_resume),
        ("averaging_ensemble", s_averaging_ensemble),
        ("host_sharded", s_host_sharded),
        ("pjit", s_pjit), ("pjit_bert_mlm", s_pjit_bert_mlm),
        ("global_shards", s_global_shards),
        ("predict", s_predict), ("too_few_workers", s_too_few_workers),
        ("short_peer", s_short_peer),
        ("spread_fleet", s_spread_fleet), ("failed_start", s_failed_start)]


# -- the async pair -----------------------------------------------------------

def _heldout_loss(model, params, heldout):
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.as_tensor(params[n]))
        model.eval()
        logits = model(torch.from_numpy(np.asarray(heldout["features"])))
        return float(losses_lib.get("categorical_crossentropy")(
            logits, torch.from_numpy(np.asarray(heldout["label"]))))


def a_live_center():
    full = dk.synthetic_mnist(n=2304)
    lo, hi = (0, 1024) if RANK == 0 else (1024, 2048)
    ds = dk.Dataset({c: np.asarray(full[c])[lo:hi] for c in full.columns})
    heldout = dk.Dataset({c: np.asarray(full[c])[2048:]
                          for c in full.columns})
    model = mlp32(seed=3)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    probe = mlp32(seed=3)
    init_l = _heldout_loss(probe, init, heldout)
    t = dk.ADAG(model, worker_optimizer="sgd", learning_rate=0.05,
                metrics=(), batch_size=32, communication_window=2,
                num_epoch=6, num_workers=4, mode="host_async",
                data_layout="host_sharded", device="cpu")
    params = t.train(ds, shuffle=True)
    stal = t.staleness_history
    save("live_center", history=history(t), staleness=np.array(stal),
         **params_np(params))
    return {"n": len(t.history), "updates": t.num_updates,
            "stal_n": len(stal), "stal_sum": float(sum(stal)),
            "init": init_l, "heldout": _heldout_loss(probe, params, heldout),
            "checksum": checksum(params)}


def a_global_shards():
    pool = os.path.join(DIR, "pool11")
    gs = GlobalShards({
        "features": [os.path.join(pool, f"f{i}.npy") for i in range(8)],
        "label": [os.path.join(pool, f"l{i}.npy") for i in range(8)]},
        seed=9)
    a = [gs.epoch_assignment(e) for e in (0, 1)]
    t = dk.ADAG(mlp32(seed=4, dropout_rate=0.0), worker_optimizer="sgd",
                learning_rate=0.05, metrics=(), batch_size=16,
                communication_window=2, num_epoch=2, num_workers=4,
                mode="host_async", data_layout="host_sharded", device="cpu")
    params = t.train(gs)
    return {"updates": t.num_updates,
            "redealt": set(a[0][RANK]) != set(a[1][RANK]),
            "union": sorted(a[0][0] + a[0][1]) == list(range(8)) and
            sorted(a[1][0] + a[1][1]) == list(range(8)),
            "checksum": checksum(params)}


def a_resume():
    ckdir = os.path.join(DIR, "ck")
    full = dk.synthetic_mnist(n=1024)
    lo, hi = (0, 512) if RANK == 0 else (512, 1024)
    ds = dk.Dataset({c: np.asarray(full[c])[lo:hi] for c in full.columns})

    def trainer():
        return dk.ADAG(mlp32(seed=5, dropout_rate=0.0),
                       worker_optimizer="sgd", learning_rate=0.05,
                       metrics=(), batch_size=16, communication_window=2,
                       num_epoch=2, num_workers=4, mode="host_async",
                       data_layout="host_sharded", checkpoint_dir=ckdir,
                       checkpoint_folds=8, device="cpu")

    t1 = trainer()
    t1.train(ds)
    t2 = trainer()
    t2.train(ds, resume=True)
    stale = None
    try:  # a stale directory with resume=False: every process raises
        trainer().train(ds)
    except ValueError as e:
        stale = "resume=True" in str(e) or "see their logs" in str(e)
    steps = sorted(int(s) for s in os.listdir(ckdir) if s.isdigit()) \
        if RANK == 0 else []
    return {"updates1": t1.num_updates, "h0_1": t1.history[0]["loss"],
            "updates2": t2.num_updates, "h0_2": t2.history[0]["loss"],
            "stale_raised": stale, "steps_on_disk": steps}


def a_spread_standby():
    full = dk.synthetic_mnist(n=1024)
    lo, hi = (0, 512) if RANK == 0 else (512, 1024)
    ds = dk.Dataset({c: np.asarray(full[c])[lo:hi] for c in full.columns})
    out = {}
    for name, kw in (("process0_shards2", dict(ps_shards=2)),
                     ("spread_standby", dict(ps_shards=2,
                                             ps_placement="spread",
                                             ps_standby=True))):
        t = dk.ADAG(mlp32(seed=6, dropout_rate=0.0), worker_optimizer="sgd",
                    learning_rate=0.05, metrics=(), batch_size=16,
                    communication_window=2, num_epoch=1, num_workers=4,
                    mode="host_async", data_layout="host_sharded",
                    device="cpu", **kw)
        params = t.train(ds)
        out[name] = {"updates": t.num_updates, "n": len(t.history),
                     "checksum": checksum(params)}
    return out


ASYNC = [("live_center", a_live_center), ("gs_live_center", a_global_shards),
         ("resume", a_resume), ("fleet_runs", a_spread_standby)]


# -- the axes pair: the model, sequence and pipeline axes over processes ------

#: ``gpt_tiny``'s widths at one layer (the test's ``GPT``)
GPT = dict(num_layers=1)


def load(name):
    with np.load(os.path.join(DIR, f"axes_{name}.npz")) as f:
        return {k: f[k] for k in f.files}


def into(model, arrays, prefix=""):
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(arrays[prefix + n]))
    return model


def mesh_info(mesh):
    from distkeras_tpu_torch.parallel import mesh as mesh_lib

    return {"shape": mesh.shape, "owners": mesh.owners,
            "device_owners": mesh.device_owners,
            "local": mesh_lib.local_worker_positions(mesh),
            "home": str(mesh.home), "spans": mesh.spans_processes,
            "row_processes": mesh.row_processes}


def x_meshes():
    from distkeras_tpu_torch.parallel import mesh as mesh_lib
    from distkeras_tpu_torch.parallel import pipeline, sequence

    return {
        "rows": mesh_info(distributed.multihost_mesh(
            num_workers=2, model_parallelism=2, devices=["cpu"] * 2)),
        "span": mesh_info(mesh_lib.make_mesh(model_parallelism=2,
                                             devices=["cpu"])),
        "sp_rows": mesh_info(sequence.make_sp_mesh(2, 2, ["cpu"] * 2)),
        "sp_span": mesh_info(sequence.make_sp_mesh(1, 2, ["cpu"])),
        "pp": mesh_info(pipeline.make_pp_mesh(4, ["cpu"] * 2))}


def x_hop():
    # the hop alone: a symmetric exchange (each rank sends x, receives the
    # peer's), then a send-only rank 0 whose backward runs off its token
    peer = 1 - RANK
    x = torch.from_numpy(np.random.default_rng(10 + RANK).standard_normal(
        (3, 5)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(np.random.default_rng(20 + RANK).standard_normal(
        (3, 5)).astype(np.float32))
    _, (got,) = collectives.hop([(x, peer)],
                                [(peer, (3, 5), torch.float32, "cpu")])
    (got * w).sum().backward()
    collectives.flush_hops()
    want_x = np.random.default_rng(10 + peer).standard_normal(
        (3, 5)).astype(np.float32)
    want_g = np.random.default_rng(20 + peer).standard_normal(
        (3, 5)).astype(np.float32)
    out = {"forward": bool(np.array_equal(got.detach().numpy(), want_x)),
           "backward": bool(np.array_equal(x.grad.numpy(), want_g))}
    y = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_()
    if RANK == 0:
        token, _ = collectives.hop([(y * 2, 1)])
        token.backward()
    else:
        _, (r,) = collectives.hop((), [(0, (2, 3), torch.float32, "cpu")])
        (r ** 2).sum().backward()
    collectives.flush_hops()
    out["one_way"] = y.grad.tolist() if RANK == 0 else None
    return out


def _gpt_pjit(mesh, worker_optimizer="momentum", learning_rate=0.1, **kw):
    from distkeras_tpu_torch.models import gpt

    data = load("gpt")
    model = into(gpt.gpt_tiny(**GPT), data, "p/")
    t = dk.PjitTrainer(model, loss="masked_lm",
                       worker_optimizer=worker_optimizer,
                       learning_rate=learning_rate, batch_size=16,
                       metrics=(), mesh=mesh, **kw)
    return t, dk.Dataset({"features": data["x"], "label": data["y"]})


def _held(t):
    from distkeras_tpu_torch.parallel import tensor

    opt = t.state.opt_state.state
    out = {"held": 0, "whole": 0, "opt_held": 0, "opt_whole": 0,
           "sharded": 0}
    for p in t.state.params.values():
        if not isinstance(p, tensor.Sharded):
            continue
        out["sharded"] += 1
        out["held"] += sum(s.nbytes for s in p.shards)
        out["whole"] += int(np.prod(p.shape)) * p.shards[0].element_size()
        held = sum(v.nbytes for s in p.shards for v in opt[s].values()
                   if torch.is_tensor(v))
        out["opt_held"] += held
        out["opt_whole"] += held * p.count // len(p.shards)
    return out


def x_pjit_rows():
    t, ds = _gpt_pjit(distributed.multihost_mesh(
        num_workers=2, model_parallelism=2, devices=["cpu"] * 2))
    params = t.train(ds)
    save("pjit_rows", history=history(t), **params_np(params))
    return {"n": len(t.history), "checksum": checksum(params), **_held(t)}


def x_pjit_span():
    from distkeras_tpu_torch.parallel.mesh import Mesh

    def span():
        return distributed.multihost_mesh(model_parallelism=2,
                                          devices=["cpu"])

    t, ds = _gpt_pjit(span(), num_epoch=2)
    params = t.train(ds)
    save("pjit_span", history=history(t), **params_np(params))
    held = _held(t)
    ckdir = os.path.join(DIR, "axes_ck")
    _gpt_pjit(span(), num_epoch=1, checkpoint_dir=ckdir)[0].train(ds)
    t2, _ = _gpt_pjit(span(), num_epoch=2, checkpoint_dir=ckdir)
    resumed = t2.train(ds, resume=True)
    # LAMB's trust ratio spans the whole tensor: its shards' norms join
    # across the row's processes
    lamb = {}
    for key, mesh in (("multi", span()),
                      ("one", Mesh(["cpu"] * 2, model_parallelism=2))):
        lt, _ = _gpt_pjit(mesh, worker_optimizer="lamb", learning_rate=1e-2)
        lamb[key] = (lt.train(ds), history(lt))
    return {"n": len(t.history), "checksum": checksum(params), **held,
            "resumed_bitwise": all(torch.equal(resumed[n], params[n])
                                   for n in params),
            "resumed_n": len(t2.history),
            "lamb_bitwise": bool(np.array_equal(lamb["multi"][1],
                                                lamb["one"][1])) and all(
                torch.equal(lamb["multi"][0][n], lamb["one"][0][n])
                for n in params),
            "on_disk": sorted(x for x in os.listdir(ckdir) if x.isdigit())
            if RANK == 0 else []}


def x_pjit_coupled():
    # batch-coupled objectives on the 2 x 2 mesh (rows in a process):
    # each rank gathers the global batch and takes the one-process step
    from distkeras_tpu_torch.models import bert_tiny, gpt, moe
    from distkeras_tpu_torch.parallel.mesh import Mesh

    out = {}
    cases = {"moe_ep": lambda: (
        into(moe.MoEClassifier(4, num_layers=1, num_heads=2, num_experts=4,
                               mlp_dim=32, capacity_factor=0.5,
                               dtype=torch.float32, width=16), load("moe"),
             "p/"), load("moe"),
        dict(loss="categorical_crossentropy",
             partition_rules=moe.ep_partition_rules())),
        "bert_mlm": lambda: (
            into(bert_tiny(num_segments=0), load("bert"), "p/"),
            load("bert"), dict(loss="masked_lm", accum_steps=2)),
        # int8's activation scale is the global batch's amax; int16 ids
        # cross as bytes
        "gpt_int8": lambda: (
            into(gpt.gpt_tiny(**GPT), load("gpt"), "p/"),
            {**load("gpt"), "x": load("gpt")["x"].astype(np.int16)},
            dict(loss="masked_lm", precision="int8"))}
    for name, build in cases.items():
        got = {}
        for key, mesh in (
                ("multi", distributed.multihost_mesh(
                    num_workers=2, model_parallelism=2,
                    devices=["cpu"] * 2)),
                ("one", Mesh(["cpu"] * 4, model_parallelism=2))):
            model, data, kw = build()
            t = dk.PjitTrainer(model, worker_optimizer="sgd",
                               learning_rate=0.1, batch_size=16, metrics=(),
                               mesh=mesh, **kw)
            got[key] = (t.train(dk.Dataset({"features": data["x"],
                                            "label": data["y"]})),
                        history(t))
        (pm, hm), (po, ho) = got["multi"], got["one"]
        save(f"coupled_{name}", history=hm, **params_np(pm))
        out[name] = {"n": len(hm),
                     "bitwise": bool(np.array_equal(hm, ho)) and all(
                         torch.equal(pm[n], po[n]) for n in po),
                     "checksum": checksum(pm)}
    return out


def _sp(mesh):
    from distkeras_tpu_torch.models import gpt
    from distkeras_tpu_torch.parallel import sequence

    data = load("sp")
    model = gpt.gpt_tiny(attention="ring", **GPT)
    tx = opt_lib.get("sgd", 0.1)
    state = sequence.init_sp_state(model, tx, mesh)
    into(model, data, "p/")
    step_fn, place_state, place_batch = sequence.build_sp_train_step(
        model, tx, mesh)
    return data, model, state, step_fn, place_batch


def x_sp_rows():
    from distkeras_tpu_torch.parallel import sequence

    data, model, state, step_fn, _ = _sp(sequence.make_sp_mesh(
        2, 2, ["cpu"] * 2))
    state, ms = step_fn(state, {"input_ids": data["ids"],
                                "labels": data["labels"]})
    save("sp_rows", **params_np(dict(model.named_parameters())))
    return {"loss": float(ms["loss"]), "accuracy": float(ms["accuracy"]),
            "checksum": checksum(dict(model.named_parameters()))}


def x_sp_span():
    from distkeras_tpu_torch.parallel import sequence
    from distkeras_tpu_torch.parallel.mesh import Mesh

    mesh = sequence.make_sp_mesh(1, 2, ["cpu"])
    data, model, state, step_fn, place_batch = _sp(mesh)
    batch = {"input_ids": data["ids"], "labels": data["labels"]}
    placed = place_batch(batch)
    ids = torch.from_numpy(data["ids"])
    with torch.no_grad():
        mine = model(placed["input_ids"][0])[RANK]
        # the same weights' one-process ring, every block in this process
        alone = model(list(ids.chunk(2, dim=1)))[RANK]
    state, ms = step_fn(state, placed)
    save("sp_span", **params_np(dict(model.named_parameters())))
    # this process's one-process step for the update's bits
    ref = _sp(Mesh(["cpu"] * 2, model_parallelism=2,
                   axis_names=("workers", "seq")))
    _, ref_ms = ref[3](ref[2], batch)
    return {"forward_bitwise": bool(torch.equal(mine, alone)),
            "remote": [type(b).__name__ for b in placed["input_ids"][0]],
            "loss": float(ms["loss"]), "accuracy": float(ms["accuracy"]),
            "one_process_loss": float(ref_ms["loss"]),
            "max_param_diff": max(float((a - b).abs().max()) for a, b in zip(
                model.parameters(), ref[1].parameters())),
            "checksum": checksum(dict(model.named_parameters()))}


LM = dict(vocab_size=64, max_len=32, num_layers=4, num_heads=2, width=32,
          mlp_dim=64, num_stages=4)


def _owned(module):
    return {n: p.detach().numpy() for n, p in module.named_parameters()
            if not p.is_meta}


def x_pp_lm():
    from distkeras_tpu_torch.parallel import pipeline
    from distkeras_tpu_torch.parallel.mesh import Mesh

    data = load("pp_lm")
    params = {n[2:]: torch.from_numpy(v) for n, v in data.items()
              if n.startswith("p/")}
    batch = {"input_ids": data["ids"], "labels": data["labels"]}
    out = {}
    for key, mesh in (("multi", pipeline.make_pp_mesh(4, ["cpu"] * 2)),
                      ("one", Mesh(["cpu"] * 4, model_parallelism=4,
                                   axis_names=("workers", "stages")))):
        model = pipeline.PipelinedLM(**LM, device="cpu")
        step_fn, place_params, place_batch = model.build_train_step(
            opt_lib.get("sgd", 0.1), mesh, num_microbatches=4)
        state = place_params(params)
        _, ms = step_fn(state, place_batch(batch))
        out[key] = (_owned(model), {k: float(v) for k, v in ms.items()})
    (pm, mm), (po, mo) = out["multi"], out["one"]
    save("pp_lm", **pm)
    return {"metrics": mm, "owned": sorted(pm),
            "bitwise": mm == mo and all(np.array_equal(pm[n], po[n])
                                        for n in pm)}


class ConvPool(torch.nn.Module):
    """NHWC in and out: SAME 3x3 conv, relu, 2x2 mean pool (the stages of
    ``tests/test_torch_pipeline.py``)."""

    def __init__(self, fan_in, channels):
        super().__init__()
        self.conv = torch.nn.Conv2d(fan_in, channels, 3, padding=1)

    def forward(self, x):
        y = torch.relu(self.conv(x.float().permute(0, 3, 1, 2)))
        return torch.nn.functional.avg_pool2d(y, 2).permute(0, 2, 3, 1)


class DenseRelu(torch.nn.Module):
    def __init__(self, fan_in, width):
        super().__init__()
        self.fc = torch.nn.Linear(fan_in, width)

    def forward(self, x):
        return torch.relu(self.fc(x.float()))


class Head(torch.nn.Module):
    def __init__(self, fan_in, classes):
        super().__init__()
        self.out = torch.nn.Linear(fan_in, classes)

    def forward(self, x):
        return self.out(x.float().reshape(x.shape[0], -1))


def x_pp_generic():
    from distkeras_tpu_torch.parallel import pipeline
    from distkeras_tpu_torch.parallel.mesh import Mesh

    data = load("pp_generic")
    params = tuple({n[len(f"p{k}/"):]: torch.from_numpy(v)
                    for n, v in data.items() if n.startswith(f"p{k}/")}
                   for k in range(4))
    batch = {"features": data["features"], "labels": data["labels"]}
    out = {}
    for key, mesh in (("multi", pipeline.make_pp_mesh(4, ["cpu"] * 2)),
                      ("one", Mesh(["cpu"] * 4, model_parallelism=4,
                                   axis_names=("workers", "stages")))):
        pipe = pipeline.GenericPipeline(
            [ConvPool(3, 8), ConvPool(8, 16), DenseRelu(16, 32),
             Head(2 * 2 * 32, 5)], num_microbatches=2, device="cpu")
        pipe.init(batch["features"][:4])
        step_fn, place_params, place_batch = pipe.build_train_step(
            opt_lib.get("sgd", 0.1), mesh)
        state = place_params(params)
        _, ms = step_fn(state, place_batch(batch))
        out[key] = ({f"{k}/{n}": v for k, stage in enumerate(pipe.stages)
                     for n, v in _owned(stage).items()},
                    {k: float(v) for k, v in ms.items()})
    (pm, mm), (po, mo) = out["multi"], out["one"]
    save("pp_generic", **pm)
    return {"metrics": mm, "owned": sorted(pm),
            "bitwise": mm == mo and all(np.array_equal(pm[n], po[n])
                                        for n in pm)}


AXES = [("meshes", x_meshes), ("hop", x_hop), ("pjit_rows", x_pjit_rows),
        ("pjit_span", x_pjit_span), ("pjit_coupled", x_pjit_coupled),
        ("sp_rows", x_sp_rows), ("sp_span", x_sp_span), ("pp_lm", x_pp_lm),
        ("pp_generic", x_pp_generic)]


def main():
    for name, fn in {"sync": SYNC, "async": ASYNC, "axes": AXES}[ROLE]:
        t0 = time.perf_counter()
        try:
            out = fn()
            out["_s"] = time.perf_counter() - t0
            print(f"SCEN {name} OK {json.dumps(out)}", flush=True)
        except Exception as e:  # reported per scenario
            traceback.print_exc()
            msg = f"{type(e).__name__}: {e}".replace("\n", " ")[:500]
            print(f"SCEN {name} FAIL {msg}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
