"""The multi-process plane on a card: two ranks on ``cuda:0`` over gloo.

Skipped without a CUDA device. This file imports no JAX, so it runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_multiprocess_cuda.py

Two child processes join a two-process group (``distributed.initialize``
on ``127.0.0.1``, a 120 s collective timeout; each child has a hard
timeout and is killed in a ``finally``) and train ``ADAG`` on a mesh
over both processes, one worker a process on ``cuda:0`` (MLP, sgd 0.05,
``synthetic_mnist(n=512)``, batch 16, window 2, one epoch, TF32 off).
Two ranks on one card: the fold backend must be gloo, and each round's
fold is staged through a pinned host buffer. The center both ranks hold
must equal, bit for bit, the one-process K = 2 run (``parallelism_factor
=2`` on ``cuda:0``) from the same weights: with one worker a process the
cross-process fold adds the same two commits in the same order.

The twin of ``chip_smoke.py`` phase 34 (a)'s spanning case runs the same
way: ``PjitTrainer(gpt_tiny(), precision="int8", loss="masked_lm")``
(the int8 product's kernel on every block Dense) on a workers 1 x model 2
mesh whose row spans both ranks (one ``cuda:0`` device each), adam,
two steps of 16 rows. Each rank holds half of every sharded parameter's
bytes, and both return the losses and parameters of the one-process run
on ``Mesh(["cuda:0"] * 2, model_parallelism=2)`` bit for bit (a
quantizing precision takes the global batch's step on every rank).
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, sys.argv[4])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.models.mlp import MLP, init_params
    from distkeras_tpu_torch.parallel import distributed
    distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=rank,
                           local_device_ids=[0], timeout_s=120)
    _, backend = distributed.fold_group("cuda:0")
    model = init_params(MLP(features=(64,)),
                        torch.Generator().manual_seed(0))
    t = dk.ADAG(model, worker_optimizer="sgd", learning_rate=0.05,
                metrics=(), batch_size=16, communication_window=2,
                num_epoch=1,
                mesh=distributed.multihost_mesh(devices=["cuda:0"]))
    params = t.train(dk.synthetic_mnist(n=512))
    np.savez(os.path.join(out, f"center.r{rank}.npz"),
             **{n: p.cpu().numpy() for n, p in params.items()})
    with open(os.path.join(out, f"info.r{rank}.json"), "w") as f:
        json.dump({"backend": backend, "owners": t.mesh.owners,
                   "updates": t.num_updates, "steps": len(t.history)}, f)
    torch.distributed.destroy_process_group()
""")


def _run_children(tmp_path, child):
    """Two ranks of ``child`` on ``cuda:0`` (a hard timeout each, killed
    in a ``finally``); fails unless both exit 0."""
    script = tmp_path / "child.py"
    script.write_text(child)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), port, str(tmp_path), REPO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


SPAN_CHILD = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, sys.argv[4])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.models import gpt
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8
    from distkeras_tpu_torch.parallel import distributed, tensor
    distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=rank,
                           local_device_ids=[0], timeout_s=120)
    ids = np.random.default_rng(0).integers(0, 256, (32, 16)).astype(
        np.int32)
    labels = np.full_like(ids, -1)
    labels[:, :-1] = ids[:, 1:]
    model = gpt.init_params(gpt.gpt_tiny(), torch.Generator().manual_seed(0))
    t = dk.PjitTrainer(model, loss="masked_lm", precision="int8",
                       worker_optimizer="adam", learning_rate=1e-3,
                       batch_size=16, metrics=(),
                       mesh=distributed.multihost_mesh(
                           model_parallelism=2, devices=["cuda:0"]))
    i8.int8_matmul_dequant.launches = 0
    params = t.train(dk.Dataset({"features": ids, "label": labels}))
    sharded = [p for p in t.state.params.values()
               if isinstance(p, tensor.Sharded)]
    np.savez(os.path.join(out, f"span.r{rank}.npz"),
             **{n: p.cpu().numpy() for n, p in params.items()})
    with open(os.path.join(out, f"span.r{rank}.json"), "w") as f:
        json.dump({"losses": [h["loss"] for h in t.history],
                   "owners": t.mesh.device_owners,
                   "launches": i8.int8_matmul_dequant.launches,
                   "held": sum(s.nbytes for p in sharded for s in p.shards),
                   "whole": sum(int(np.prod(p.shape)) * 4 for p in sharded)},
                  f)
    torch.distributed.destroy_process_group()
""")


@pytest.mark.cuda
def test_two_ranks_model_axis_over_processes_is_one_process_bitwise(
        tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.models import gpt
    from distkeras_tpu_torch.parallel.mesh import Mesh

    _run_children(tmp_path, SPAN_CHILD)
    infos = [json.loads((tmp_path / f"span.r{r}.json").read_text())
             for r in (0, 1)]
    assert infos[0]["owners"] == infos[1]["owners"] == [[0, 1]]
    assert infos[0]["losses"] == infos[1]["losses"]
    for info in infos:
        assert 2 * info["held"] == info["whole"] > 0
        assert info["launches"] > 0  # the int8 kernel ran
    got = [dict(np.load(tmp_path / f"span.r{r}.npz")) for r in (0, 1)]
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ids = np.random.default_rng(0).integers(0, 256, (32, 16)).astype(
            np.int32)
        labels = np.full_like(ids, -1)
        labels[:, :-1] = ids[:, 1:]
        model = gpt.init_params(gpt.gpt_tiny(),
                                torch.Generator().manual_seed(0))
        t = dk.PjitTrainer(model, loss="masked_lm", precision="int8",
                           worker_optimizer="adam", learning_rate=1e-3,
                           batch_size=16, metrics=(),
                           mesh=Mesh(["cuda:0"] * 2, model_parallelism=2))
        ref = {n: p.cpu().numpy() for n, p in t.train(dk.Dataset(
            {"features": ids, "label": labels})).items()}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert infos[0]["losses"] == [h["loss"] for h in t.history]
    for n, want in ref.items():
        for params in got:
            np.testing.assert_array_equal(params[n], want, err_msg=n)


@pytest.mark.cuda
def test_two_ranks_on_one_card_fold_like_one_process(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.models.mlp import MLP, init_params

    _run_children(tmp_path, CHILD)
    infos = [json.loads((tmp_path / f"info.r{r}.json").read_text())
             for r in (0, 1)]
    assert infos[0] == infos[1]
    assert infos[0]["backend"] == "gloo"  # two ranks share one card
    assert infos[0]["owners"] == [0, 1]
    centers = [dict(np.load(tmp_path / f"center.r{r}.npz")) for r in (0, 1)]

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = init_params(MLP(features=(64,)),
                            torch.Generator().manual_seed(0))
        t = dk.ADAG(model, worker_optimizer="sgd", learning_rate=0.05,
                    metrics=(), batch_size=16, communication_window=2,
                    num_epoch=1, num_workers=1, parallelism_factor=2,
                    device="cuda:0")
        ref = {n: p.cpu().numpy()
               for n, p in t.train(dk.synthetic_mnist(n=512)).items()}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert infos[0]["updates"] == t.num_updates
    assert infos[0]["steps"] == len(t.history)
    for n, want in ref.items():
        for center in centers:
            np.testing.assert_array_equal(center[n], want, err_msg=n)
