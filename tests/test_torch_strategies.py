"""The port's update rules and parameter servers against the JAX
package's, and NUMERICS.md's invariants on the port alone.

Shared setup: a flax ``MLP(features=(16,), num_classes=4)`` on 12
features, its params bridged into the port's ``MLP``, one numpy batch
of 8 rows. Bounds (float32): each strategy's carries, commits and center
after two rounds of window 3 within rtol 1e-6 (atol 1e-7) of JAX's; the
parameter-server folds' weights bitwise and their centers rtol 1e-6;
the invariants as ``tests/test_strategies.py`` states them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import engine as jeng
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu.models.mlp import MLP as JMLP
from distkeras_tpu.ops import optimizers as jopt
from distkeras_tpu.parallel import strategies as jstrat
from distkeras_tpu_torch import engine as teng
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch.data.dataset import synthetic_mnist
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.ops import optimizers as topt
from distkeras_tpu_torch.parallel import strategies as tstrat
from distkeras_tpu_torch.trainers import DOWNPOUR, SingleTrainer
from distkeras_tpu_torch.utils import bridge
from distkeras_tpu_torch.utils.trees import tree_sub

FEAT, CLASSES, WIDTH = 12, 4, 16


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, FEAT)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, 8)]
    jmodel = JMLP(features=(WIDTH,), num_classes=CLASSES)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0),
                                                  x)["params"])
    return jmodel, params, {"features": x, "labels": y}


def _port_model(params):
    model = MLP(features=(WIDTH,), num_classes=CLASSES, in_features=FEAT)
    return bridge.load_flax_params(model, params)


def _port_tree(params):
    return {n: t.clone() for n, t in bridge.flax_to_state_dict(params).items()}


def _assert_close(port_tree, jax_tree, rtol=1e-6, atol=1e-7, what=""):
    got = bridge.state_dict_to_flax(port_tree)
    for mod, leaves in jax_tree.items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(got[mod][leaf], np.asarray(want),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{what} {mod}/{leaf}")


STRATEGIES = {
    "downpour": ({}, "momentum"),
    "adag": ({}, "sgd"),
    "dynsgd": ({}, "sgd"),
    "aeasgd": ({"rho": 2.0}, "nesterov"),
    "eamsgd": ({"rho": 2.0, "momentum": 0.9}, "sgd"),
    "independent": ({}, "sgd"),
}


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategy_round_matches_jax(setup, name):
    """Two rounds of one worker: round_start, 3 local steps, commit, the
    weighted fold into the center (position 1 for DynSGD: weight 1/2),
    post_commit; carry, commit and center match JAX's after each."""
    jmodel, params, batch = setup
    kw, opt = STRATEGIES[name]
    lr, window = 0.05, 3
    js = jstrat.get(name, learning_rate=lr, **kw)
    ts = tstrat.get(name, learning_rate=lr, **kw)
    jtx = jopt.get(opt, lr)
    jgrad = jeng.make_grad_fn(jmodel, "categorical_crossentropy")
    model = _port_model(params)
    tgrad = teng.make_grad_fn(model, "categorical_crossentropy",
                              functional=True)
    jcenter = jax.tree.map(jnp.asarray, params)
    tcenter = _port_tree(params)
    jc = js.init_carry(jcenter, jtx)
    tc = ts.init_carry(tcenter, topt.get(opt, lr))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for r in range(2):
        jc = js.round_start(jc, jcenter)
        tc = ts.round_start(tc, tcenter)
        for _ in range(window):
            jc, jm = js.local_step(jgrad, jtx, jc, batch)
            tc, tm = ts.local_step(tgrad, tc, tbatch)
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=1e-6)
        _assert_close(tc.params, jc.params, what=f"round {r} params")
        jcommit = js.commit(jc, jcenter, window)
        tcommit = ts.commit(tc, tcenter, window)
        _assert_close(tcommit, jcommit, what=f"round {r} commit")
        jw = js.staleness_weight(jnp.int32(1))
        tw = ts.staleness_weight(1)
        assert np.float32(jw) == tw.numpy()
        jcenter = jax.tree.map(lambda c, d: c + d * jw, jcenter, jcommit)
        tcenter = {n: c + tcommit[n] * tw for n, c in tcenter.items()}
        _assert_close(tcenter, jcenter, what=f"round {r} center")
        jc = js.post_commit(jc, jcommit, jcenter)
        tc = ts.post_commit(tc, tcommit, tcenter)
        _assert_close(tc.params, jc.params, what=f"round {r} post")


def test_carry_optimizer_stays_bound_across_rounds(setup):
    """round_start and post_commit copy into the carry's own tensors, so
    the optimizer (and DOWNPOUR's momentum) keeps acting on them."""
    _, params, batch = setup
    model = _port_model(params)
    grad = teng.make_grad_fn(model, "categorical_crossentropy",
                             functional=True)
    s = tstrat.Downpour()
    carry = s.init_carry(_port_tree(params), topt.get("momentum", 0.1))
    ids = {n: id(t) for n, t in carry.params.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    carry, _ = s.local_step(grad, carry, tbatch)
    carry = s.post_commit(carry, {}, _port_tree(params))
    assert {n: id(t) for n, t in carry.params.items()} == ids
    bound = {id(p) for g in carry.opt_state.param_groups for p in g["params"]}
    assert bound == set(ids.values())
    assert all("momentum_buffer" in st
               for st in carry.opt_state.state.values())
    assert all(t.requires_grad and t.is_leaf for t in carry.params.values())


# -- NUMERICS invariants on the port alone ---------------------------------

def test_invariant_1_downpour_k1_w1_equals_sequential_sgd():
    ds = synthetic_mnist(n=512, seed=0)
    kw = dict(loss="categorical_crossentropy", worker_optimizer="sgd",
              learning_rate=0.05, batch_size=64, num_epoch=2, metrics=(),
              device="cpu")
    start = MLP(features=(16,))
    single = SingleTrainer(MLP(features=(16,)), **kw)
    single.model.load_state_dict(start.state_dict())
    p_single = single.train(ds)
    down = DOWNPOUR(MLP(features=(16,)), num_workers=1,
                    communication_window=1, **kw)
    down.model.load_state_dict(start.state_dict())
    p_down = down.train(ds)
    for n in p_single:
        torch.testing.assert_close(p_down[n], p_single[n], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose([h["loss"] for h in single.get_history()],
                               [h["loss"] for h in down.get_history()],
                               rtol=1e-4)


def _tiny(setup, lr=0.05):
    _, params, batch = setup
    model = _port_model(params)
    grad = teng.make_grad_fn(model, "categorical_crossentropy",
                             functional=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return _port_tree(params), grad, tbatch, topt.get("sgd", lr)


def test_invariant_2_adag_commit_is_downpour_over_window(setup):
    center, grad, batch, tx = _tiny(setup)
    down, adag = tstrat.Downpour(), tstrat.ADAG()
    carry = down.round_start(down.init_carry(center, tx), center)
    for _ in range(4):
        carry, _ = down.local_step(grad, carry, batch)
    c_down = down.commit(carry, center, window=4)
    c_adag = adag.commit(carry, center, window=4)
    for n in c_down:
        torch.testing.assert_close(c_down[n] / 4.0, c_adag[n], rtol=1e-6,
                                   atol=0.0)


def test_invariant_3_dynsgd_weight_zero_staleness_is_one():
    dyn = tstrat.DynSGD()
    assert float(dyn.staleness_weight(0)) == 1.0
    assert float(dyn.staleness_weight(3)) == pytest.approx(0.25)
    assert float(tstrat.Downpour().staleness_weight(7)) == 1.0


def test_invariant_4_aeasgd_fixed_point(setup):
    center, _, _, tx = _tiny(setup)
    strat = tstrat.AEASGD(rho=1.0, learning_rate=0.05)
    commit = strat.commit(strat.init_carry(center, tx), center, window=4)
    assert all(torch.count_nonzero(x) == 0 for x in commit.values())


def test_invariant_5_eamsgd_mu0_step_equals_sgd_step(setup):
    center, grad, batch, tx = _tiny(setup)
    eam = tstrat.EAMSGD(rho=1.0, learning_rate=0.05, momentum=0.0)
    ca, _ = eam.local_step(grad, eam.init_carry(center, tx), batch)
    sgd = tstrat.AEASGD(rho=1.0, learning_rate=0.05)
    cb, _ = sgd.local_step(grad, sgd.init_carry(center, tx), batch)
    for n in ca.params:
        torch.testing.assert_close(ca.params[n], cb.params[n], rtol=1e-5,
                                   atol=1e-7)


def test_elastic_symmetry_worker_and_server_move_oppositely(setup):
    center, grad, batch, tx = _tiny(setup)
    strat = tstrat.AEASGD(rho=2.0, learning_rate=0.1)
    carry = strat.init_carry(center, tx)
    for _ in range(3):
        carry, _ = strat.local_step(grad, carry, batch)
    commit = strat.commit(carry, center, window=3)
    before = {n: t.detach().clone() for n, t in carry.params.items()}
    for n, w in before.items():
        torch.testing.assert_close(commit[n], 0.2 * (w - center[n]),
                                   rtol=1e-3, atol=1e-7)
    after = strat.post_commit(carry, commit, center)
    moved = tree_sub(before, after.params)
    for n in moved:
        torch.testing.assert_close(moved[n], commit[n], rtol=1e-3,
                                   atol=1e-7)


def test_independent_strategy_never_moves_center(setup):
    center, grad, batch, tx = _tiny(setup)
    strat = tstrat.Independent()
    carry, _ = strat.local_step(grad, strat.init_carry(center, tx), batch)
    commit = strat.commit(carry, center, window=1)
    assert all(torch.count_nonzero(x) == 0 for x in commit.values())
    assert not strat.exchanges


def test_get_rejects_misdirected_kwargs():
    with pytest.raises(TypeError, match="does not take"):
        tstrat.get("downpour", rho=2.0)
    with pytest.raises(TypeError, match="does not take"):
        tstrat.get("aeasgd", momentum=0.5)
    with pytest.raises(ValueError, match="Unknown strategy"):
        tstrat.get("hogwild")
    eam = tstrat.get("EAMSGD", learning_rate=0.2, rho=3.0, momentum=0.5)
    assert (eam.rho, eam.learning_rate, eam.momentum) == (3.0, 0.2, 0.5)


# -- parameter servers -----------------------------------------------------

COMMITS = ((0, 1.0), (0, 2.0), (2, -0.5), (1, 3.0), (4, 0.25))


@pytest.mark.parametrize("kind", ["delta", "dynsgd"])
def test_parameter_server_folds_match_jax(kind):
    """The same commits (last_update, delta scale) folded by both
    servers: the applied weights bitwise, the centers rtol 1e-6, the
    clocks equal."""
    rng = np.random.default_rng(3)
    base = {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    jcls = jps.DeltaParameterServer if kind == "delta" \
        else jps.DynSGDParameterServer
    tcls = tps.DeltaParameterServer if kind == "delta" \
        else tps.DynSGDParameterServer
    js = jcls({k: jnp.asarray(v) for k, v in base.items()})
    ts = tcls({k: torch.from_numpy(v.copy()) for k, v in base.items()})
    for last, scale in COMMITS:
        delta = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in base.items()}
        ja = js.commit_ex({k: jnp.asarray(v) for k, v in delta.items()},
                          last_update=last)
        ta = ts.commit_ex({k: torch.from_numpy(v) for k, v in delta.items()},
                          last_update=last)
        assert ja == ta
    (jc, jclock), (tc, tclock) = js.pull(), ts.pull()
    assert jclock == tclock == len(COMMITS)
    for k in base:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6)
    assert tps.ADAGParameterServer is tps.DeltaParameterServer
    if kind == "dynsgd":  # a committer ahead of the clock
        with pytest.raises(ValueError, match="staleness"):
            ts.commit({k: torch.zeros(v.shape) for k, v in base.items()},
                      last_update=99)


def test_dynsgd_host_weight_equals_the_float32_curve():
    dyn = tstrat.DynSGD()
    for s in range(0, 2000, 7):
        assert np.float32(tps.dynsgd_fold_weight(s)) == \
            dyn.staleness_weight(s).numpy()
        assert np.float32(tps.dynsgd_fold_weight(s)) == np.float32(
            jps.dynsgd_fold_weight(s))


def test_parameter_server_replay_and_versions():
    ps = tps.DeltaParameterServer({"w": torch.zeros(2)})
    ps.commit({"w": torch.ones(2)})
    assert ps.replay({"w": torch.ones(2)}, at_fold=3, weight=0.5) == 2
    center, clock, version = ps.pull_versioned()
    assert clock == 4 and version == 0
    torch.testing.assert_close(center["w"], torch.full((2,), 1.5))
    ps.set_model_version(1)
    with pytest.raises(ValueError, match="monotone"):
        ps.set_model_version(1)
    ps.initialize({"w": torch.zeros(2)})
    assert ps.pull()[1] == 0 and ps.model_version == 1
