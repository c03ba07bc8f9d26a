"""The port's ``run_with_retries`` against the JAX package's.

Twins of tests/test_fault.py on ``device="cpu"``: a ``SingleTrainer``
that crashes once after epoch 0's checkpoint resumes under
``run_with_retries`` to the clean run's parameters (rtol 1e-6 / atol
1e-7, the JAX test's bounds); configuration errors surface at once; the
runner gives up after ``max_restarts``; a trainer without
``checkpoint_dir`` logs a warning. Both packages start from JAX's
``MLP(features=(16,))`` init, bridged into the port, and the port's
retried run gives JAX's retried parameters within
tests/test_torch_trainers.py's bounds (rtol 1e-4 / atol 1e-5).
"""

import logging

import jax
import numpy as np
import pytest

import distkeras_tpu as jdk
from distkeras_tpu.models.mlp import MLP as JMLP
from distkeras_tpu.utils import fault as jfault
from distkeras_tpu_torch import SingleTrainer, synthetic_mnist
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.utils import bridge
from distkeras_tpu_torch.utils.fault import run_with_retries

KW = dict(worker_optimizer="sgd", learning_rate=0.05, batch_size=64,
          num_epoch=3, seed=5)


def _crashing(base):
    """``base`` that crashes once after the first epoch's checkpoint."""

    class Crashing(base):
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

    return Crashing


def _jax_start():
    return JMLP(features=(16,)).init(
        jax.random.key(5), np.zeros((1, 784), np.float32))["params"]


def _port_model():
    return bridge.load_flax_params(MLP(features=(16,)), _jax_start())


def test_run_with_retries_resumes_and_matches(tmp_path):
    ds = synthetic_mnist(n=512)
    clean = SingleTrainer(_port_model(), device="cpu", **KW)
    p_clean = clean.train(ds)
    crashy = _crashing(SingleTrainer)(
        _port_model(), device="cpu", checkpoint_dir=str(tmp_path / "ck"),
        **KW)
    p_retried = run_with_retries(crashy, ds, max_restarts=2, backoff_s=0.0)
    assert type(crashy).crashes_left == 0
    assert sorted(p_clean) == sorted(p_retried)
    for name, want in p_clean.items():
        np.testing.assert_allclose(p_retried[name].numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_config_errors_not_retried():
    calls = []

    class BadConfig(SingleTrainer):
        def train(self, dataset, shuffle=False, resume=False):
            calls.append(1)
            raise ValueError("bad config")

    t = BadConfig(MLP(features=(16,)), batch_size=64, device="cpu")
    with pytest.raises(ValueError, match="bad config"):
        run_with_retries(t, synthetic_mnist(n=128), max_restarts=3,
                         backoff_s=0.0)
    assert len(calls) == 1


def test_run_with_retries_gives_up():
    calls = []

    class AlwaysCrash(SingleTrainer):
        def train(self, dataset, shuffle=False, resume=False):
            calls.append(resume)
            raise RuntimeError("boom")

    t = AlwaysCrash(MLP(features=(16,)), batch_size=64, device="cpu")
    with pytest.raises(RuntimeError, match="boom"):
        run_with_retries(t, synthetic_mnist(n=128), max_restarts=2,
                         backoff_s=0.0)
    assert calls == [False, True, True]  # the first try, then 2 resumes


def test_no_checkpoint_dir_warns(caplog):
    t = SingleTrainer(MLP(features=(8,)), batch_size=64, num_epoch=1,
                      device="cpu")
    with caplog.at_level(logging.WARNING, logger="distkeras_tpu_torch.fault"):
        run_with_retries(t, synthetic_mnist(n=128), backoff_s=0.0)
    assert any("no checkpoint_dir" in r.message for r in caplog.records)


def test_retried_run_matches_jax(tmp_path):
    """The same crash and resume in both packages, from the same start."""
    jds = jdk.synthetic_mnist(n=256)
    jt = _crashing(jdk.SingleTrainer)(
        JMLP(features=(16,)), checkpoint_dir=str(tmp_path / "jax"), **KW)
    j_params = jfault.run_with_retries(jt, jds, max_restarts=2,
                                       backoff_s=0.0)
    tt = _crashing(SingleTrainer)(
        _port_model(), device="cpu", checkpoint_dir=str(tmp_path / "port"),
        **KW)
    t_params = run_with_retries(tt, synthetic_mnist(n=256), max_restarts=2,
                                backoff_s=0.0)
    got = bridge.state_dict_to_flax(t_params)
    for mod, leaves in jax.tree.map(np.asarray, j_params).items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(got[mod][leaf], want, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{mod}/{leaf}")
