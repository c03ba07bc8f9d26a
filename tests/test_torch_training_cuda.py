"""The training core on a card: the substrate's epoch on ``cuda:0``
against the same epoch on the CPU, and where a trainer's state lives.

Skipped without a CUDA device. This file imports no JAX, so it runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_training_cuda.py

Bounds: float32 with TF32 off, K = 4 replicas on one card against K = 4
on the CPU from the same weights and data (2 rounds of window 3, batch
16, ``MLP(features=(64,))``): center, carries, loss, accuracy and
staleness within rtol 1e-5 / atol 1e-6 (cuBLAS and the CPU's BLAS sum in
other orders). Placement: after ``train()`` every carry, the center, the
returned parameters, the model and the staged chunks are on ``cuda:0``.
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import ADAG, DynSGD, EAMSGD, synthetic_mnist
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.ops import optimizers
from distkeras_tpu_torch.parallel import mesh as mesh_lib
from distkeras_tpu_torch.parallel import strategies, substrate

K, WINDOW, BATCH, ROUNDS = 4, 3, 16, 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _epoch(device, name, kw, opt, start):
    mesh = mesh_lib.make_mesh(devices=[device])
    strategy = strategies.get(name, learning_rate=0.05, **kw)
    tx = optimizers.get(opt, 0.05)
    model = MLP(features=(64,))
    model.load_state_dict(start)
    model.to(device)
    epoch = substrate.build_epoch_fn(model, "categorical_crossentropy", tx,
                                     strategy, mesh, K, WINDOW,
                                     ("accuracy",))
    center, carries = substrate.init_center_and_carries(
        {n: p.detach() for n, p in model.named_parameters()}, tx, strategy,
        mesh, K)
    ds = synthetic_mnist(n=K * ROUNDS * WINDOW * BATCH, seed=3)
    data, _ = substrate.stage_epoch_data(ds.repartition(K), "features",
                                         "label", BATCH, WINDOW, mesh)
    center, carries, ms = epoch(center, carries, data, 0)
    return ({n: x.cpu() for n, x in center.items()},
            [{n: x.detach().cpu() for n, x in c.params.items()}
             for c in carries],
            {n: x.cpu() for n, x in ms.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,opt", [
    ("downpour", {}, "momentum"), ("adag", {}, "sgd"), ("dynsgd", {}, "sgd"),
    ("aeasgd", {"rho": 2.0}, "sgd"),
    ("eamsgd", {"rho": 2.0, "momentum": 0.9}, "sgd"),
    ("independent", {}, "sgd")])
def test_epoch_on_the_card_matches_the_cpu(cuda_device, name, kw, opt):
    torch.manual_seed(0)
    start = MLP(features=(64,)).state_dict()
    got = _epoch(cuda_device, name, kw, opt, start)
    want = _epoch(torch.device("cpu"), name, kw, opt, start)
    for n in want[0]:
        torch.testing.assert_close(got[0][n], want[0][n], rtol=1e-5,
                                   atol=1e-6)
    for g, w in zip(got[1], want[1]):
        for n in w:
            torch.testing.assert_close(g[n], w[n], rtol=1e-5, atol=1e-6)
    for n in want[2]:
        torch.testing.assert_close(got[2][n], want[2][n], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("cls,staging", [(ADAG, None), (DynSGD, 1),
                                         (EAMSGD, None)])
def test_trainer_state_lives_on_the_card(cuda_device, cls, staging):
    trainer = cls(MLP(features=(32,)), num_workers=1, parallelism_factor=K,
                  communication_window=2, batch_size=16,
                  staging_rounds=staging)
    seen = []
    orig = substrate.stage_epoch_chunks

    def spy(*args, **kwargs):
        for chunk, rounds in orig(*args, **kwargs):
            seen.append(chunk)
            yield chunk, rounds

    substrate.stage_epoch_chunks = spy
    try:
        params = trainer.train(synthetic_mnist(n=1024))
    finally:
        substrate.stage_epoch_chunks = orig
    assert trainer.mesh.devices == [cuda_device]
    assert all(x.device == cuda_device for x in params.values())
    assert all(x.device == cuda_device for x in trainer._center.values())
    assert len(trainer._carries) == K
    for carry in trainer._carries:
        assert all(x.device == cuda_device for x in carry.params.values())
    assert all(p.device == cuda_device for p in trainer.model.parameters())
    assert seen and all(t.device == cuda_device for chunk in seen
                        for cols in chunk.values() for t in cols)
    assert np.isfinite(trainer.get_history()[-1]["loss"])
