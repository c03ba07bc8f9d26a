"""The one-process data plane on a card: ``chip_smoke.py`` phase 31's
drills at MLP size with the center and the workers on ``cuda:0``.

Skipped without a CUDA device. This file imports no JAX, so it runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_data_cuda.py

- Streaming with a dead worker: before the trainer starts, a bare
  client leases three ranges, acks one and vanishes; ADAG
  ``mode="host_async"`` with two workers then trains from
  ``data_service=`` through two epochs. The cursor ends at ``[2,
  num_ranges]``, the two abandoned ranges are re-leased once each, no
  ack is stale, the landed steps are every range's but the dead
  worker's one, and the last snapshot's ``data_cursor`` is the final
  cursor.
- ``run_with_retries``: a ``SingleTrainer`` on the card that crashes
  after epoch 0's checkpoint resumes to a clean run's parameters within
  rtol 1e-6 / atol 1e-7 (TF32 off).
"""

import numpy as np
import pytest
import torch

import distkeras_tpu_torch as tdk
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.checkpoint import Checkpointer
from distkeras_tpu_torch.comms import RetryPolicy
from distkeras_tpu_torch.data.service import (DataCoordinator,
                                              DataServiceClient)
from distkeras_tpu_torch.models.mlp import MLP, init_params
from distkeras_tpu_torch.utils.fault import run_with_retries


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


def _counter(name):
    reg = telemetry.get_registry()
    return sum(v for k, v in reg.snapshot()["counters"].items()
               if k.split("{")[0] == name)


@pytest.mark.cuda
def test_streaming_with_a_dead_worker(cuda_device, tmp_path):
    # the lease outlasts a live worker's hold (two rounds and the first
    # window's warm-up); the epoch's tail waits out the dead one's once
    batch, window, range_rows, lease_s = 32, 2, 64, 5.0
    ds = tdk.synthetic_mnist(n=1024, seed=3)
    coord = DataCoordinator(dataset=ds, range_size=range_rows, seed=7,
                            num_epochs=2, lease_s=lease_s)
    coord.start()
    try:
        releases0 = _counter("data.service.releases")
        stale0 = _counter("data.service.stale_acks")
        dead = DataServiceClient(coord.address, worker=99,
                                 retry=RetryPolicy(max_retries=2,
                                                   base_s=0.01, max_s=0.02))
        dead.register()
        grant = dead.lease(max_ranges=3)
        pos, start, stop = grant["ranges"][0]
        dead.fetch(start, stop)
        assert dead.ack(grant["epoch"], [pos])["retired"] == 1
        dead.close()  # no deregister: its two leases lapse
        t = tdk.ADAG(_model(), learning_rate=0.05, batch_size=batch,
                     num_workers=2, communication_window=window,
                     mode="host_async", data_service=coord,
                     checkpoint_dir=str(tmp_path), checkpoint_folds=2)
        t.train(None)
        assert list(coord.cursor_carry()) == [2, coord.num_ranges]
        moved = (_counter("data.service.releases") - releases0,
                 _counter("data.service.stale_acks") - stale0)
        assert moved == (2, 0), moved
        steps_per_range = range_rows // batch
        assert len(t.history) == \
            (2 * coord.num_ranges - 1) * steps_per_range
        assert np.isfinite([h["loss"] for h in t.history]).all()
        assert all(p.device.type == cuda_device.type
                   for p in t.params.values())
        ckpt = Checkpointer(str(tmp_path))
        snap = ckpt.restore(step=ckpt.latest_step())
        assert list(np.asarray(snap["data_cursor"])) == \
            [2, coord.num_ranges]
    finally:
        coord.stop()


@pytest.mark.cuda
def test_run_with_retries_on_the_card(cuda_device, tmp_path):
    class Crashing(tdk.SingleTrainer):
        crashes_left = 1

        def train(self, dataset, shuffle=False, resume=False):
            if type(self).crashes_left > 0 and not resume:
                real_epochs = self.num_epoch
                self.num_epoch = 1
                super().train(dataset, shuffle=shuffle, resume=resume)
                self.num_epoch = real_epochs
                type(self).crashes_left -= 1
                raise RuntimeError("injected failure after epoch 0")
            return super().train(dataset, shuffle=shuffle, resume=resume)

    ds = tdk.synthetic_mnist(n=512)
    kw = dict(worker_optimizer="sgd", learning_rate=0.05, batch_size=64,
              num_epoch=3, seed=5)
    clean = tdk.SingleTrainer(_model(), **kw).train(ds)
    retried = run_with_retries(
        Crashing(_model(), checkpoint_dir=str(tmp_path), **kw), ds,
        max_restarts=2, backoff_s=0.0)
    for name, want in clean.items():
        torch.testing.assert_close(retried[name], want, rtol=1e-6,
                                   atol=1e-7)
