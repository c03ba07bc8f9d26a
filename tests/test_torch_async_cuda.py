"""The true-async plane on a card: ``mode="host_async"`` trainers,
the runner, the parameter service and the rollout publisher with the
center on ``cuda:0``.

Skipped without a CUDA device. This file imports no JAX, so it runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_async_cuda.py

Bounds: a K = 1 run on the card against the same run on the CPU, the
centers within 1e-5 absolute (float32, TF32 off); a K = 4 DynSGD run's
final center against a float64 replay of its logged ``(delta, weight)``
folds within 1e-6 of each leaf's largest magnitude; a service's pull
bytes from a card center equal a CPU center's (the same folds of
dyadic deltas are exact in float32); commit counts equal the windows
scheduled.
"""

import numpy as np
import pytest
import torch

import distkeras_tpu_torch as tdk
from distkeras_tpu_torch.models.mlp import MLP, init_params
from distkeras_tpu_torch.ops import optimizers as topt
from distkeras_tpu_torch.parallel import host_async as tha
from distkeras_tpu_torch.parallel import strategies as tstrat
from distkeras_tpu_torch.parallel.remote_ps import (ParameterServerService,
                                                    RemoteParameterServer)
from distkeras_tpu_torch.parameter_servers import DynSGDParameterServer
from distkeras_tpu_torch.serving.rollout import WeightPublisher


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda:0")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _model(seed=0):
    return init_params(MLP(features=(64,)),
                       torch.Generator().manual_seed(seed))


def _shards(workers, rounds, window, batch, seed=0):
    rng = np.random.default_rng(seed)
    return [[{"features": rng.standard_normal(
                (window, batch, 784)).astype(np.float32),
              "labels": np.eye(10, dtype=np.float32)[
                  rng.integers(0, 10, (window, batch))]}
             for _ in range(rounds)] for _ in range(workers)]


@pytest.mark.cuda
def test_single_worker_card_equals_cpu(cuda_device):
    ds = tdk.synthetic_mnist(n=1024)
    start = _model().state_dict()
    out = {}
    for device in (cuda_device, "cpu"):
        model = MLP(features=(64,))
        model.load_state_dict(start)
        t = tdk.ADAG(model, mode="host_async", num_workers=1,
                     worker_optimizer="sgd", learning_rate=0.05,
                     batch_size=32, communication_window=4, device=device)
        out[str(device)] = (t.train(ds), t.num_updates)
    (card, n_card), (cpu, n_cpu) = out.values()
    assert n_card == n_cpu == 8
    for n in cpu:
        assert card[n].device.type == "cuda"
        assert (card[n].cpu() - cpu[n]).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_dynsgd_center_equals_a_float64_replay_of_its_folds(cuda_device):
    model = _model(1).to(cuda_device)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    strategy = tstrat.get("dynsgd", learning_rate=0.05)
    ps = tha.server_for(strategy, {n: x.clone() for n, x in start.items()})
    log, orig = [], ps.commit_ex

    def commit_ex(delta, last_update=0, weight=None):
        at_fold, w = orig(delta, last_update=last_update, weight=weight)
        log.append((at_fold, w, {n: x.double() for n, x in delta.items()}))
        return at_fold, w

    ps.commit_ex = commit_ex
    runner = tha.HostAsyncRunner(model, "categorical_crossentropy",
                                 topt.get("sgd", 0.05), strategy, 4,
                                 devices=[cuda_device])
    center, _, stal, clock = runner.run(start, [_shards(4, 3, 4, 32)], ps=ps)
    assert clock == len(log) == 12 and len(stal) == 12
    ref = {n: x.double() for n, x in start.items()}
    for _, w, delta in sorted(log, key=lambda r: r[0]):
        w32 = float(np.float32(w))
        for n in ref:
            ref[n] += w32 * delta[n]
    for n, r in ref.items():
        scale = max(r.abs().max().item(), 1e-30)
        assert (center[n].double() - r).abs().max().item() / scale <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(codec="int8", comms_overlap=True),
                                dict(codec="bf16"), dict()])
def test_every_window_commits_on_the_card(cuda_device, kw):
    t = tdk.DynSGD(_model(2), mode="host_async", num_workers=2,
                   worker_optimizer="sgd", learning_rate=0.05,
                   batch_size=32, communication_window=2, device=cuda_device,
                   **kw)
    params = t.train(tdk.synthetic_mnist(n=1024))
    assert t.num_updates == len(t.staleness_history) == 16
    assert all(np.isfinite(h["loss"]) for h in t.get_history())
    assert all(x.device.type == "cuda" and torch.isfinite(x).all()
               for x in params.values())


@pytest.mark.cuda
def test_service_pull_bytes_from_a_card_center_equal_a_cpu_center(
        cuda_device):
    like = {"w": np.ones((64, 32), np.float32),
            "b": np.zeros((32,), np.float32)}
    rng = np.random.default_rng(3)
    deltas = [{k: (rng.integers(-8, 8, v.shape) / 8).astype(np.float32)
               for k, v in like.items()} for _ in range(4)]
    got = []
    for device in (cuda_device, torch.device("cpu")):
        ps = DynSGDParameterServer({k: torch.from_numpy(v.copy()).to(device)
                                    for k, v in like.items()})
        svc = ParameterServerService(ps, like, host="127.0.0.1")
        svc.start()
        client = RemoteParameterServer(f"127.0.0.1:{svc.port}", like,
                                       op_timeout=30.0)
        try:
            folds = [client.commit_ex(d, last_update=0) for d in deltas]
            _, blobs = client._roundtrip({"op": "pull"})
            pub = WeightPublisher(ps=client, device=device)
            seen = []
            pub.subscribe(lambda v, p, c: seen.append(p))
            assert pub.publish() == 1 and client.model_version == 1
            assert all(x.device.type == device.type
                       for x in seen[0].values())
            got.append((folds, [bytes(b) for b in blobs]))
        finally:
            client.close()
            svc.stop()
    assert got[0] == got[1]
