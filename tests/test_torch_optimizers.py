"""The optimizers the port took over in this slice (adagrad, rmsprop,
adadelta, nadam, lamb) against optax at its defaults, as the JAX
package's registry builds them.

Bounds (float32): parameters after 5 steps on the same parameters and
gradients within rtol 1e-6 (lamb 1e-5: its per-tensor norms sum in
another order), atol 1e-7; a zero parameter tensor and a zero gradient
are among the leaves (adagrad's ``where(sum > 0)``, lamb's zero-norm
trust ratio). Then one ``SingleTrainer`` run with each against the JAX
package's from the same bridged start: parameters and history within
rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as tdk
from distkeras_tpu.models.mlp import MLP as JMLP
from distkeras_tpu.ops import optimizers as jopt
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.ops import optimizers as topt
from distkeras_tpu_torch.utils import bridge

NEW = ("adagrad", "rmsprop", "adadelta", "nadam", "lamb")


def _tree(seed, zero=False):
    rng = np.random.default_rng(seed)
    out = {"w": rng.standard_normal((5, 3)).astype(np.float32),
           "b": rng.standard_normal((3,)).astype(np.float32),
           "z": np.zeros((4,), np.float32)}
    if zero:  # a gradient that is zero on one leaf
        out["b"] = np.zeros((3,), np.float32)
    return out


@pytest.mark.parametrize("name", NEW)
def test_new_optimizer_matches_optax_over_five_steps(name):
    params = _tree(0)
    jtx = jopt.get(name, 0.05)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    jst, opt = jtx.init(jp), topt.get(name, 0.05)(tp.values())
    rtol = 1e-5 if name == "lamb" else 1e-6
    for i in range(5):
        grads = _tree(i + 1, zero=i == 2)
        ju, jst = jtx.update({k: jnp.asarray(v) for k, v in grads.items()},
                             jst, jp)
        jp = optax.apply_updates(jp, ju)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=rtol,
                                       atol=1e-7, err_msg=f"{k} step {i}")


def test_defaults_are_optax_not_torch():
    p = [torch.nn.Parameter(torch.ones(2))]
    assert topt.get("adagrad", 0.1)(p).defaults["initial_accumulator_value"] \
        == 0.1
    rms = topt.get("rmsprop", 0.1)(p).defaults
    assert (rms["decay"], rms["eps"], rms["initial_scale"]) == (0.9, 1e-8,
                                                                0.0)
    ada = topt.get("adadelta", 0.1)(p).defaults
    assert (ada["lr"], ada["rho"], ada["eps"]) == (0.1, 0.9, 1e-6)
    assert topt.get("lamb", 0.1)(p).defaults["eps"] == 1e-6
    assert topt.get("nadam", 0.1)(p).defaults["eps"] == 1e-8


@pytest.mark.parametrize("name", NEW)
def test_single_trainer_with_each_matches_jax(name):
    kw = dict(worker_optimizer=name, learning_rate=0.05, batch_size=32,
              num_epoch=1)
    start = JMLP(features=(16,)).init(jax.random.key(0),
                                      np.zeros((1, 784), np.float32))
    start = jax.tree.map(np.asarray, start["params"])
    jt = jdk.SingleTrainer(JMLP(features=(16,)), **kw)
    jp = jt.train(jdk.synthetic_mnist(n=256))
    model = bridge.load_flax_params(MLP(features=(16,)), start)
    tt = tdk.SingleTrainer(model, device="cpu", **kw)
    tp = bridge.state_dict_to_flax(tt.train(tdk.synthetic_mnist(n=256)))
    for mod in jp:
        for leaf in jp[mod]:
            np.testing.assert_allclose(tp[mod][leaf], np.asarray(jp[mod][leaf]),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{mod}/{leaf}")
    for got, want in zip(tt.history, jt.history):
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-5)
