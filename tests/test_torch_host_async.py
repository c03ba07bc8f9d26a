"""The port's host-async runner against the JAX package's.

Shared setup: a dropout-free flax ``MLP(features=(16,), num_classes=4)``
on 12 features, its params bridged into the port's ``MLP``, seeded numpy
batches. Bounds (float32, as tests/test_torch_strategies.py): rtol 1e-6,
atol 1e-7 for one worker's two windows; rtol 1e-5, atol 1e-6 for a
K = 1 run of 2 epochs (more steps accumulate rounding).

- ``make_window_fn``: two windows of each exchanging strategy give the
  carry, the commit and the per-step loss and accuracy of JAX's;
- a K = 1 ``HostAsyncRunner`` (DynSGD and ADAG, 2 epochs): the final
  center, the history, the staleness and the clock of JAX's;
- the ``CadenceTrigger`` cases of tests/test_host_async.py, and the same
  fire sequence as JAX's trigger for one observed clock stream;
- the runner alone on ``device="cpu"``: K threads commit every window
  once (also with ``overlap=True``, an int8 codec, ``accum_steps``),
  the degradation ladder folds a backlog with the oldest pull clock, a
  failing worker aborts its siblings, the per-window MFU series runs
  when a peak is given, worker ``k`` runs on ``devices[k % D]`` with a
  module of its own;
- snapshots and resume: ``checkpoint_folds`` snapshots ``{"center",
  "clock"}``; a resumed trainer starts from the snapshot's center
  (bitwise) and continues its clock.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu_torch as tdk
from distkeras_tpu.models.mlp import MLP as JMLP
from distkeras_tpu.ops import optimizers as jopt
from distkeras_tpu.parallel import host_async as jha
from distkeras_tpu.parallel import strategies as jstrat
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.checkpoint import Checkpointer
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.ops import optimizers as topt
from distkeras_tpu_torch.parallel import host_async as tha
from distkeras_tpu_torch.parallel import strategies as tstrat
from distkeras_tpu_torch.parallel.remote_ps import PSUnavailable
from distkeras_tpu_torch.utils import bridge

FEAT, CLASSES, WIDTH = 12, 4, 16
LOSS = "categorical_crossentropy"
STRATEGIES = {
    "downpour": ({}, "momentum"),
    "adag": ({}, "sgd"),
    "dynsgd": ({}, "sgd"),
    "aeasgd": ({"rho": 2.0}, "nesterov"),
    "eamsgd": ({"rho": 2.0, "momentum": 0.9}, "sgd"),
}


@pytest.fixture(scope="module")
def setup():
    jmodel = JMLP(features=(WIDTH,), num_classes=CLASSES)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(0), np.zeros((1, FEAT), np.float32))["params"])
    return jmodel, params


def _rounds(n_rounds, window, batch, seed):
    rng = np.random.default_rng(seed)
    return [{"features": rng.standard_normal(
                (window, batch, FEAT)).astype(np.float32),
             "labels": np.eye(CLASSES, dtype=np.float32)[
                 rng.integers(0, CLASSES, (window, batch))]}
            for _ in range(n_rounds)]


def _port_model(params):
    return bridge.load_flax_params(
        MLP(features=(WIDTH,), num_classes=CLASSES, in_features=FEAT),
        params)


def _port_tree(params):
    return {n: t.clone() for n, t in bridge.flax_to_state_dict(params).items()}


def _assert_close(port_tree, jax_tree, rtol=1e-6, atol=1e-7, what=""):
    got = bridge.state_dict_to_flax(port_tree)
    for mod, leaves in jax_tree.items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(got[mod][leaf], np.asarray(want),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{what} {mod}/{leaf}")


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_window_fn_matches_jax(setup, name):
    jmodel, params = setup
    kw, opt = STRATEGIES[name]
    lr, window = 0.05, 3
    js = jstrat.get(name, learning_rate=lr, **kw)
    ts = tstrat.get(name, learning_rate=lr, **kw)
    jtx, ttx = jopt.get(opt, lr), topt.get(opt, lr)
    jfn = jha.make_window_fn(jmodel, LOSS, jtx, js, window, ("accuracy",),
                             seed=0)
    tfn = tha.make_window_fn(_port_model(params), LOSS, ttx, ts, window,
                             ("accuracy",), seed=0)
    jcenter = jax.tree.map(jnp.asarray, params)
    tcenter = _port_tree(params)
    jc, tc = js.init_carry(jcenter, jtx), ts.init_carry(tcenter, ttx)
    for r, batches in enumerate(_rounds(2, window, 8, seed=1)):
        jc, jcommit, jms = jfn(jc, jcenter, batches, np.int32(r))
        tc, tcommit, tms = tfn(tc, tcenter, {
            k: torch.from_numpy(v) for k, v in batches.items()}, r)
        _assert_close(tc.params, jc.params, what=f"window {r} carry")
        _assert_close(tcommit, jcommit, what=f"window {r} commit")
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(tms[key].numpy(), np.asarray(jms[key]),
                                       rtol=1e-6, atol=1e-7)
        # the server's fold at weight 1, then the next window reads it
        jcenter = jax.tree.map(lambda c, d: c + d, jcenter, jcommit)
        tcenter = {n: c + tcommit[n] for n, c in tcenter.items()}


@pytest.mark.parametrize("name", ["dynsgd", "adag"])
def test_single_worker_runner_matches_jax(setup, name):
    """K = 1 is deterministic: pull, window, commit in order. Two epochs
    of four rounds; the clock, the staleness (all 0), every history entry
    and the final center equal JAX's (rtol 1e-5 / atol 1e-6)."""
    jmodel, params = setup
    lr, window = 0.05, 2
    rounds = _rounds(4, window, 8, seed=2)
    jrun = jha.HostAsyncRunner(jmodel, LOSS, jopt.get("sgd", lr),
                               jstrat.get(name, learning_rate=lr), window,
                               metrics=("accuracy",),
                               devices=jax.devices()[:1])
    jcenter, jhist, jstal, jclock = jrun.run(
        jax.tree.map(jnp.asarray, params), [[rounds]] * 2)
    trun = tha.HostAsyncRunner(_port_model(params), LOSS,
                               topt.get("sgd", lr),
                               tstrat.get(name, learning_rate=lr), window,
                               metrics=("accuracy",), device="cpu")
    tcenter, thist, tstal, tclock = trun.run(_port_tree(params),
                                             [[rounds]] * 2)
    assert tclock == jclock == 8
    assert tstal == jstal == [0.0] * 8
    assert trun.window_clocks == jrun.window_clocks == list(range(8))
    assert len(thist) == len(jhist) == 16
    for t, j in zip(thist, jhist):
        assert sorted(t) == sorted(j)
        for key in t:
            np.testing.assert_allclose(t[key], j[key], rtol=1e-5, atol=1e-6)
    _assert_close(tcenter, jcenter, rtol=1e-5, atol=1e-6, what="center")


# -- the checkpoint cadence ------------------------------------------------

def test_cadence_survives_a_clock_stride_like_jax():
    folds, stride = 4, 3
    clocks = list(range(0, 120, stride))
    mine, theirs = tha.CadenceTrigger(folds), jha.CadenceTrigger(folds)
    fired = [c for c in clocks if mine.crossed(c)]
    assert fired == [c for c in clocks if theirs.crossed(c)]
    intervals = (clocks[-1] + 1) // folds
    assert intervals - 1 <= len(fired) <= intervals
    buckets = [(c + 1) // folds for c in fired]
    assert buckets == sorted(set(buckets))
    with pytest.raises(ValueError, match="checkpoint_folds"):
        tha.CadenceTrigger(0)


def test_cadence_resume_does_not_refire_old_intervals():
    trig = tha.CadenceTrigger(4, start_clock=8)
    assert not trig.crossed(8)
    assert not trig.crossed(9)
    assert trig.crossed(11)
    assert not trig.crossed(11)


def test_cadence_concurrent_workers_fire_once():
    trig = tha.CadenceTrigger(2)
    fires = []

    def worker():
        for c in range(100):
            if trig.crossed(c):
                fires.append((c + 1) // 2)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert sorted(fires) == sorted(set(fires)) == list(range(1, 51))


# -- the runner on the CPU -------------------------------------------------

def _runner(setup, name="adag", **kw):
    _, params = setup
    return tha.HostAsyncRunner(
        _port_model(params), LOSS, topt.get("sgd", 0.05),
        tstrat.get(name, learning_rate=0.05), 2, metrics=("accuracy",),
        **kw), _port_tree(params)


@pytest.mark.parametrize("kw", [dict(), dict(overlap=True),
                                dict(codec="int8"),
                                dict(codec="bf16", overlap=True),
                                dict(accum_steps=2)])
def test_every_window_commits_once(setup, kw):
    runner, start = _runner(setup, device="cpu", **kw)
    shards = [_rounds(3, 2, 8, seed=10 + k) for k in range(3)]
    center, hist, stal, clock = runner.run(start, [shards, shards])
    assert clock == 18 and len(stal) == 18 and len(hist) == 36
    assert sorted(runner.window_clocks) == list(range(18))
    assert all(s >= 0 for s in stal)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert all(torch.isfinite(x).all() for x in center.values())


def test_workers_get_devices_round_robin_and_own_modules(setup):
    runner, start = _runner(setup, devices=["cpu", "cpu"])
    shards = [_rounds(1, 2, 8, seed=k) for k in range(3)]
    runner.run(start, [shards])
    assert [d.type for d in runner.worker_devices] == ["cpu"] * 3
    assert set(runner._window_fns) == {1, 2}  # worker 0 uses the caller's
    mods = {id(fn.grad_fn) for fn in runner._window_fns.values()}
    assert len(mods) == 2


class _Flaky:
    """A local server whose commits fail with PSUnavailable on the
    scripted call numbers (a fleet outage, seen by the worker)."""

    def __init__(self, ps, fail_calls):
        self.ps, self.fail, self.calls, self.seen = ps, set(fail_calls), 0, []

    def pull(self):
        return self.ps.pull()

    def commit(self, delta, last_update=0):
        self.calls += 1
        if self.calls in self.fail:
            raise PSUnavailable("scripted outage")
        self.seen.append(last_update)
        return self.ps.commit(delta, last_update=last_update)

    @property
    def num_updates(self):
        return self.ps.num_updates


def test_degradation_ladder_folds_the_backlog(setup):
    runner, start = _runner(setup, device="cpu")
    ps = _Flaky(tha.server_for(runner.strategy, start), fail_calls=(2, 3))
    center, hist, stal, clock = runner.run(
        start, [[_rounds(5, 2, 8, seed=3)]], ps=ps)
    # windows 1 and 2 fail to land; window 3 folds all three as one
    # commit whose last_update is the oldest backlog window's pull clock
    # (1), then window 4 commits on its own
    assert clock == 3 and ps.seen == [0, 1, 2]
    assert len(hist) == 10 and len(stal) == 5
    snap = telemetry.get_registry().snapshot()["counters"]
    assert sum(v for k, v in snap.items()
               if k.startswith("host_async.degraded_windows")) >= 2


def test_degradation_ladder_budget_surfaces_the_outage(setup):
    runner, start = _runner(setup, device="cpu", max_degraded_windows=1)
    ps = _Flaky(tha.server_for(runner.strategy, start),
                fail_calls=range(2, 100))
    with pytest.raises(PSUnavailable):
        runner.run(start, [[_rounds(5, 2, 8, seed=3)]], ps=ps)


def test_failing_worker_aborts_its_siblings(setup):
    runner, start = _runner(setup, device="cpu")
    ps = tha.server_for(runner.strategy, start)
    orig, attempts, bomber = ps.commit, [], []

    class Bomb(Exception):
        pass

    def commit(delta, last_update=0):
        attempts.append(1)
        tid = threading.get_ident()
        if ps.num_updates >= 3 and not bomber:
            bomber.append(tid)
        if bomber and bomber[0] == tid:
            raise Bomb("worker down")
        return orig(delta, last_update=last_update)

    ps.commit = commit
    shards = [_rounds(20, 2, 4, seed=k) for k in range(4)]
    with pytest.raises(Bomb):
        runner.run(start, [shards] * 2, ps=ps)
    # without the abort the three siblings would make their 120 commits
    # after the bomb; with it each stops at its next round (a few windows
    # in flight at most, even with the bomber's postmortem dump between
    # its raise and the abort)
    assert len(attempts) <= 40, len(attempts)


def test_window_mfu_series_runs_with_a_given_peak(setup):
    runner, start = _runner(setup, device="cpu")
    runner.mfu_peak_flops = 1e12
    runner.run(start, [[_rounds(2, 2, 8, seed=4)]])
    # 2 x (forward + two backward products) of 8 x 12 x 16 and 8 x 16 x 4
    step = 2 * 8 * (12 * 16 + 16 * 4) * 3 - 2 * 8 * 12 * 16
    assert runner._window_flops == step * 2
    hist = telemetry.get_registry().snapshot()["histograms"]
    assert any(k.startswith("observability.mfu_window") for k in hist)


def test_runner_defaults_to_the_card(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _runner(setup)


# -- snapshots and resume --------------------------------------------------

def test_checkpoint_folds_snapshot_and_resume_continues_the_clock(
        tmp_path, monkeypatch):
    ds = tdk.synthetic_mnist(n=512)
    kw = dict(mode="host_async", num_workers=2, batch_size=16,
              communication_window=2, learning_rate=0.05, metrics=(),
              worker_optimizer="sgd", device="cpu",
              checkpoint_dir=str(tmp_path), checkpoint_folds=2)
    model = MLP(features=(8,))
    first = tdk.DynSGD(model, **kw)
    first.train(ds)
    ckpt = Checkpointer(str(tmp_path))
    step = ckpt.latest_step()
    assert step == first.num_updates == 16
    snap = ckpt.restore(step=step)
    assert int(snap["clock"][0]) == step
    seen = {}
    orig = tha.HostAsyncRunner.run

    def spy(self, init_params, *a, **k):
        seen["center"] = {n: x.clone() for n, x in init_params.items()}
        seen["start_clock"] = k["start_clock"]
        return orig(self, init_params, *a, **k)

    monkeypatch.setattr(tha.HostAsyncRunner, "run", spy)
    resumed = tdk.DynSGD(MLP(features=(8,)), **kw)
    resumed.train(ds, resume=True)
    assert seen["start_clock"] == step
    for n, x in snap["center"].items():
        assert torch.equal(seen["center"][n], torch.as_tensor(np.array(x)))
    assert resumed.num_updates == 2 * step
    assert ckpt.latest_step() == 2 * step
    with pytest.raises(ValueError, match="resume=False"):
        tdk.DynSGD(MLP(features=(8,)), **kw).train(ds)


def test_many_threads_at_a_short_switch_interval_lose_no_fold(setup):
    """Stress: more worker threads than cores, the interpreter switching
    threads every microsecond. A lost or doubled fold would break the
    clock count or the center, which must equal a replay of the logged
    commits in fold order (float32, the same ops: bitwise)."""
    import sys

    runner, start = _runner(setup, device="cpu")
    ps = tha.server_for(runner.strategy, start)
    logged, orig = [], ps.commit_ex

    def commit_ex(delta, last_update=0, weight=None):
        at_fold, w = orig(delta, last_update=last_update, weight=weight)
        logged.append((at_fold, w, {n: x.clone() for n, x in delta.items()}))
        return at_fold, w

    ps.commit_ex = commit_ex
    shards = [_rounds(2, 2, 4, seed=k) for k in range(16)]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        center, _, stal, clock = runner.run(start, [shards], ps=ps)
    finally:
        sys.setswitchinterval(prev)
    assert clock == len(logged) == len(stal) == 32
    assert sorted(runner.window_clocks) == list(range(32))
    ref = {n: x.clone() for n, x in start.items()}
    for _, w, delta in sorted(logged, key=lambda r: r[0]):
        wt = torch.tensor(w, dtype=torch.float32)
        ref = {n: c + (wt * delta[n]).to(c.dtype) for n, c in ref.items()}
    assert all(torch.equal(center[n], ref[n]) for n in ref)
