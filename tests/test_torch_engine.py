"""The port's step engine, losses, optimizers and precision policies
against the JAX package's, on bridged ``gpt_tiny`` weights and shared
numpy batches.

Bounds (float32 unless stated; the packages differ in summation order,
and the port's CPU attention under ``attention="flash"`` is the plain
exact-softmax version where JAX's CPU "flash" path is the XLA einsum):

- model: logits 1e-5 abs; ``make_grad_fn`` loss 1e-6 relative, each
  gradient 1e-4 relative to its norm;
- train step: loss, ``grad_norm`` and ``accuracy`` 1e-5 relative,
  parameters 1e-5 abs after 3 SGD steps; one AdamW step: loss and
  ``grad_norm`` 1e-5 relative, parameters 1e-6 abs where JAX's
  gradient is at least 1e-6 in magnitude (Adam's first update is
  ``lr * g / (|g| + eps)``, about ``lr * sign(g)``, so where |g| is at
  the level of the two packages' float noise the sign is noise), and
  within ``lr * (1 + 1e-3)`` of the start elsewhere;
- accumulation: ``accum_steps=2`` equals the full-batch step to 1e-6
  and JAX's ``make_accum_grad_fn`` to the model bounds;
  ``make_epoch_fn`` equals looped ``make_train_step`` exactly;
- losses 1e-6 relative; optimizers 1e-6 abs after 3 steps;
- master weights: one SGD step at bf16 compute with an update below
  bf16's resolution moves the port's float32 weights as JAX moves its
  own, to 2e-2 relative over all parameters (bf16 rounding in the two
  frameworks' forward and backward differs by about 1e-2 relative per
  parameter), where bf16 storage would have dropped over 95% of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu import engine as jeng
from distkeras_tpu import precision as jprecision
from distkeras_tpu.models import gpt as jgpt
from distkeras_tpu.ops import losses as jlosses
from distkeras_tpu.utils import trees as jtrees
from distkeras_tpu_torch import engine as teng
from distkeras_tpu_torch import precision as tprecision
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.ops import losses as tlosses
from distkeras_tpu_torch.ops import optimizers as topt
from distkeras_tpu_torch.utils import bridge
from distkeras_tpu_torch.utils import trees as ttrees


@pytest.fixture(scope="module")
def flash_pair():
    """(jax gpt_tiny(attention="flash"), numpy params): t=128 fits."""
    jmodel = jgpt.gpt_tiny(attention="flash")
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, jax.tree.map(np.asarray, params)


def _port(params, **kw):
    """A fresh port model carrying ``params`` (steps update in place)."""
    return bridge.load_flax_params(tgpt.gpt_tiny(**kw), params)


def _batch(b=2, t=128, seed=0):
    x = np.random.default_rng(seed).integers(0, 256, (b, t)).astype(
        np.int32)
    y = np.concatenate([x[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
    return {"features": x, "labels": y}


def _jstate(params, tx):
    p = jax.tree.map(jnp.asarray, params)
    return jeng.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                           opt_state=tx.init(p))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


def _port_tree(model):
    return _flat(bridge.state_dict_to_flax(model.state_dict()))


def _port_grads(grads):
    return _flat(bridge.state_dict_to_flax(grads))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _assert_grads_close(got, want, rtol):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        err = np.linalg.norm(got[name] - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= rtol, (name, err)


# -- model and gradients -----------------------------------------------------

def test_flash_model_matches_jax(flash_pair):
    """The port's attention="flash" (plain versions on the CPU, through
    the autograd.Function) against JAX's attention="flash", which on the
    CPU is its XLA path: logits, loss and every gradient."""
    jmodel, params = flash_pair
    batch = _batch(seed=1)
    model = _port(params, attention="flash")
    want = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(batch["features"])))
    with torch.no_grad():
        got = model(torch.from_numpy(batch["features"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    (jloss, _), jgrads = jeng.make_grad_fn(jmodel, "masked_lm")(
        params, _jbatch(batch))
    (tloss, logits), tgrads = teng.make_grad_fn(model, "masked_lm")(
        teng.to_device(batch, "cpu"))
    assert logits.shape == (2, 128, 256) and not logits.requires_grad
    assert _rel(tloss, jloss) <= 1e-6
    assert all(g.dtype == torch.float32 for g in tgrads.values())
    _assert_grads_close(_port_grads(tgrads), _flat(jgrads), 1e-4)


def test_flash_and_full_attention_agree_in_the_port(flash_pair):
    _, params = flash_pair
    batch = teng.to_device(_batch(seed=2), "cpu")
    out = {}
    for attention in ("flash", "full"):
        model = _port(params, attention=attention)
        out[attention] = teng.make_grad_fn(model, "masked_lm")(batch)
    assert _rel(out["flash"][0][0], out["full"][0][0]) <= 1e-6
    _assert_grads_close(_port_grads(out["flash"][1]),
                        _port_grads(out["full"][1]), 1e-4)


# -- train step --------------------------------------------------------------

def test_sgd_train_steps_match_jax(flash_pair):
    jmodel, params = flash_pair
    jtx, ttx = optax.sgd(0.1), topt.get("sgd", 0.1)
    jstep = jeng.make_train_step(jmodel, "masked_lm", jtx,
                                 metrics=("accuracy",))
    model = _port(params, attention="flash")
    tstate = teng.create_train_state(model, ttx, device="cpu")
    tstep = teng.make_train_step(model, "masked_lm", ttx,
                                 metrics=("accuracy",))
    jstate = _jstate(params, jtx)
    for i in range(3):
        batch = _batch(seed=10 + i)
        jstate, jout = jstep(jstate, _jbatch(batch))
        tstate, tout = tstep(tstate, batch)
        assert sorted(tout) == sorted(jout) == ["accuracy", "grad_norm",
                                                "loss"]
        for name in jout:
            assert _rel(tout[name], jout[name]) <= 1e-5 or (
                float(jout[name]) == 0 and float(tout[name]) == 0), name
    assert tstate.step == 3
    got, want = _port_tree(model), _flat(jstate.params)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5,
                                   err_msg=name)


def test_adamw_step_matches_jax(flash_pair):
    jmodel, params = flash_pair
    batch = _batch(seed=20)
    jtx, ttx = optax.adamw(1e-3), topt.get("adamw", 1e-3)
    (_, _), jgrads = jeng.make_grad_fn(jmodel, "masked_lm")(
        params, _jbatch(batch))
    jstate, jout = jeng.make_train_step(jmodel, "masked_lm", jtx)(
        _jstate(params, jtx), _jbatch(batch))
    model = _port(params, attention="flash")
    _, tout = teng.make_train_step(model, "masked_lm", ttx)(
        teng.create_train_state(model, ttx, device="cpu"), batch)
    for name in ("loss", "grad_norm"):
        assert _rel(tout[name], jout[name]) <= 1e-5, name
    got, want, start = (_port_tree(model), _flat(jstate.params),
                        _flat(params))
    for name, g in _flat(jgrads).items():
        sure = np.abs(g) >= 1e-6
        assert sure.mean() > 0.5, name
        np.testing.assert_allclose(got[name][sure], want[name][sure],
                                   rtol=0, atol=1e-6, err_msg=name)
        assert np.all(np.abs(got[name] - start[name]) <= 1e-3 * (1 + 1e-3))


def test_adamw_trajectory_on_a_repeated_batch_matches_jax(flash_pair):
    """Five adamw(1e-3) steps on one repeated batch (the shape of the
    chip run's training phase, at gpt_tiny size): the port's losses
    follow the JAX engine's step by step, to 1e-4 relative."""
    jmodel, params = flash_pair
    batch = _batch(seed=21)
    jtx, ttx = optax.adamw(1e-3), topt.get("adamw", 1e-3)
    jstep = jeng.make_train_step(jmodel, "masked_lm", jtx)
    model = _port(params, attention="flash")
    tstep = teng.make_train_step(model, "masked_lm", ttx)
    jstate = _jstate(params, jtx)
    tstate = teng.create_train_state(model, ttx, device="cpu")
    jlosses_, tlosses_ = [], []
    for _ in range(5):
        jstate, jout = jstep(jstate, _jbatch(batch))
        tstate, tout = tstep(tstate, batch)
        jlosses_.append(float(jout["loss"]))
        tlosses_.append(float(tout["loss"]))
    assert tstate.step == 5
    for got, want in zip(tlosses_, jlosses_):
        assert _rel(got, want) <= 1e-4, (tlosses_, jlosses_)


# -- accumulation and the epoch loop -----------------------------------------

def test_accumulation_equals_full_batch_and_matches_jax(flash_pair):
    jmodel, params = flash_pair
    batch = _batch(b=4, seed=30)
    tbatch = teng.to_device(batch, "cpu")
    model = _port(params, attention="flash")
    (full_loss, logits), full_grads = teng.make_grad_fn(
        model, "masked_lm")(tbatch)
    (acc_loss, terms), acc_grads = teng.make_accum_grad_fn(
        model, "masked_lm", 2, ("accuracy",))(tbatch)
    assert _rel(acc_loss, full_loss) <= 1e-6
    for name, g in full_grads.items():
        torch.testing.assert_close(acc_grads[name], g, rtol=0, atol=1e-6)
    assert float(teng.finalize_metric(terms["accuracy"])) == float(
        teng.compute_metric("accuracy", logits, tbatch["labels"]))
    (jloss, jterms), jgrads = jeng.make_accum_grad_fn(
        jmodel, "masked_lm", 2, ("accuracy",))(params, _jbatch(batch))
    assert _rel(acc_loss, jloss) <= 1e-6
    for got, want in zip(terms["accuracy"], jterms["accuracy"]):
        assert float(got) == float(want)
    _assert_grads_close(_port_grads(acc_grads), _flat(jgrads), 1e-4)
    with pytest.raises(ValueError, match="divide"):
        teng.make_accum_grad_fn(model, "masked_lm", 3)(tbatch)


def test_accumulated_train_step_equals_full_batch_step(flash_pair):
    _, params = flash_pair
    batch = _batch(b=4, seed=31)
    models = [_port(params, attention="flash") for _ in range(2)]
    outs = []
    for model, k in zip(models, (1, 2)):
        tx = topt.get("momentum", 0.05)
        step = teng.make_train_step(model, "masked_lm", tx,
                                    metrics=("accuracy",), accum_steps=k)
        state = teng.create_train_state(model, tx, device="cpu")
        for _ in range(2):
            state, out = step(state, batch)
        outs.append(out)
    for name in outs[0]:
        assert _rel(outs[1][name], outs[0][name]) <= 1e-6, name
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_epoch_fn_equals_looped_train_steps_exactly(flash_pair):
    _, params = flash_pair
    batches = [_batch(seed=40 + i) for i in range(2)]
    data = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    tx = topt.get("adam", 1e-3)
    looped, scanned = (_port(params, attention="flash") for _ in range(2))
    state = teng.create_train_state(looped, tx, device="cpu")
    step = teng.make_train_step(looped, "masked_lm", tx,
                                metrics=("accuracy",))
    outs = []
    for batch in batches:
        state, out = step(state, batch)
        outs.append(out)
    epoch = teng.make_epoch_fn(scanned, "masked_lm", tx,
                               metrics=("accuracy",))
    estate, eout = epoch(teng.create_train_state(scanned, tx, device="cpu"),
                         data)
    assert estate.step == state.step == 2
    for name in eout:
        assert eout[name].shape == (2,)
        assert torch.equal(eout[name], torch.stack([o[name] for o in outs]))
    for a, b in zip(looped.parameters(), scanned.parameters()):
        assert torch.equal(a, b)


def test_eval_step_and_metric_terms_match_jax(flash_pair):
    jmodel, params = flash_pair
    batch = _batch(seed=50)
    model = _port(params, attention="flash")
    logits = teng.make_eval_step(model)(batch["features"])
    want = jeng.make_eval_step(jmodel)(params, jnp.asarray(batch["features"]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    onehot = np.eye(256, dtype=np.float32)[batch["features"]]
    for labels in (batch["labels"], onehot):
        got = teng.compute_metric_terms("accuracy", logits,
                                        torch.from_numpy(labels))
        ref = jeng.compute_metric_terms("accuracy", want, jnp.asarray(labels))
        assert [float(x) for x in got] == [float(x) for x in ref]
    empty = np.full_like(batch["labels"], -1)
    assert float(teng.compute_metric("masked_accuracy", logits,
                                     torch.from_numpy(empty))) == 0.0
    for name, err in (("loss", ValueError), ("f1", ValueError)):
        with pytest.raises(err):
            teng.compute_metric_terms(name, logits,
                                      torch.from_numpy(batch["labels"]))


# -- losses, optimizers, precision, trees ------------------------------------

def _loss_inputs(name):
    rng = np.random.default_rng(len(name))
    logits = rng.standard_normal((4, 6, 10)).astype(np.float32) * 3
    if name in ("categorical_crossentropy",):
        labels = rng.dirichlet(np.ones(10), size=(4, 6)).astype(np.float32)
    elif name in ("sparse_categorical_crossentropy",):
        labels = rng.integers(0, 10, (4, 6)).astype(np.int32)
    elif name == "masked_lm":
        labels = np.where(rng.random((4, 6)) < 0.5,
                          rng.integers(0, 10, (4, 6)), -1).astype(np.int32)
    elif name == "binary_crossentropy":
        labels = rng.integers(0, 2, (4, 6, 10)).astype(np.float32)
    else:
        labels = rng.standard_normal((4, 6, 10)).astype(np.float32)
    return logits, labels


@pytest.mark.parametrize("name", sorted(tlosses._LOSSES))
def test_each_loss_matches_jax(name):
    logits, labels = _loss_inputs(name)
    want = jlosses.get(name)(jnp.asarray(logits), jnp.asarray(labels))
    got = tlosses.get(name)(torch.from_numpy(logits),
                            torch.from_numpy(labels))
    assert got.shape == ()
    assert _rel(got, want) <= 1e-6


def test_loss_registry_matches_jax_and_masked_lm_counts_valid_only():
    assert sorted(tlosses._LOSSES) == sorted(jlosses._LOSSES)
    fn = lambda x, y: x.sum()
    assert tlosses.get(fn) is fn
    with pytest.raises(ValueError, match="Unknown loss"):
        tlosses.get("hinge")
    logits = torch.zeros(2, 3, 4)
    none_valid = torch.full((2, 3), -1)
    assert float(tlosses.masked_lm(logits, none_valid)) == 0.0


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32)}


@pytest.mark.parametrize("name", ["sgd", "momentum", "sgd_momentum",
                                  "nesterov", "adam", "adamw"])
def test_each_optimizer_matches_optax_over_three_steps(name):
    from distkeras_tpu.ops import optimizers as jopt

    params = _opt_tree(0)
    jtx = jopt.get(name, 0.05)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    jst, opt = jtx.init(jp), topt.get(name, 0.05)(tp.values())
    for i in range(3):
        grads = _opt_tree(i + 1)
        ju, jst = jtx.update({k: jnp.asarray(v) for k, v in grads.items()},
                             jst, jp)
        jp = optax.apply_updates(jp, ju)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=k)


def test_adamw_keeps_optax_defaults_not_torch_ones():
    """optax.adamw's weight decay is 1e-4 (torch's AdamW: 1e-2), applied
    as lr * wd * p: with a zero gradient one step moves p by exactly
    -lr * 1e-4 * p."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.get("adamw", 0.5)([p])
    assert (opt.defaults["weight_decay"], opt.defaults["eps"],
            opt.defaults["betas"]) == (1e-4, 1e-8, (0.9, 0.999))
    p.grad = torch.zeros(3)
    opt.step()
    torch.testing.assert_close(p.detach() - 1, torch.full((3,), -0.5 * 1e-4))


def test_optimizer_registry_raises_for_what_is_not_ported():
    """Every name of the JAX registry is ported now (the last five are
    held to optax in test_torch_optimizers.py); a name the JAX registry
    does not know raises ValueError, as there."""
    for name in ("adagrad", "rmsprop", "adadelta", "nadam", "lamb"):
        opt = topt.get(name)([torch.nn.Parameter(torch.ones(1))])
        assert isinstance(opt, torch.optim.Optimizer)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        topt.get("sgdw")
    factory = topt.get("sgd", 0.1)
    assert topt.get(factory) is factory
    assert isinstance(factory([torch.nn.Parameter(torch.ones(1))]),
                      torch.optim.SGD)


def test_precision_policies_match_jax():
    assert tprecision.PRECISION_POLICIES == jprecision.PRECISION_POLICIES
    for name in ("f32", "bf16", "int8", "fp8-sim"):
        tp, jp = tprecision.get_policy(name), jprecision.get_policy(name)
        assert (tp.name, tp.quant, tp.loss_scale, tp.growth_interval,
                tp.max_scale, tp.mfu_dtype) == (
                    jp.name, jp.quant, jp.loss_scale, jp.growth_interval,
                    jp.max_scale, jp.mfu_dtype)
        assert str(tp.compute_dtype).split(".")[-1] == jnp.dtype(
            jp.compute_dtype).name
        assert tprecision.validate_precision(tp) == name
    assert tprecision.get_policy(None) is None
    assert tprecision.current_scale({"anything": 1}) is None
    assert tprecision.resolve("int8", torch.float32) == torch.bfloat16
    assert tprecision.resolve("fp8-sim", torch.float32) == torch.bfloat16
    # the loss-scaling policies build grad fns (no longer refused)
    for name in ("int8", "fp8-sim"):
        assert callable(teng.make_grad_fn(torch.nn.Linear(2, 2), "mse",
                                          precision=name))
    with pytest.raises(ValueError):
        tprecision.get_policy("fp16")


def test_global_norm_matches_jax():
    tree = _opt_tree(7)
    want = jtrees.global_norm({k: jnp.asarray(v) for k, v in tree.items()})
    got = ttrees.global_norm({k: torch.from_numpy(v).bfloat16()
                              for k, v in tree.items()})
    assert got.dtype == torch.float32
    want_bf16 = jtrees.global_norm({k: jnp.asarray(v, jnp.bfloat16)
                                    for k, v in tree.items()})
    assert _rel(got, want_bf16) <= 1e-6
    assert _rel(ttrees.global_norm({k: torch.from_numpy(v)
                                    for k, v in tree.items()}), want) <= 1e-6


# -- float32 master weights ----------------------------------------------------

def test_bf16_compute_sgd_step_moves_float32_masters_like_jax():
    """One SGD step at bf16 compute with lr 1e-4: every update is far
    below bf16's spacing at the weights' magnitude. The port keeps
    float32 masters, so its parameters move as JAX's do (2e-2 relative
    over all parameters); had it stored the Dense and embedding weights
    in bf16, over 95% of their updates would have rounded away."""
    jmodel = jgpt.gpt_tiny(dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    batch = _batch(b=2, t=32, seed=60)
    jtx, ttx = optax.sgd(1e-4), topt.get("sgd", 1e-4)
    jstate, _ = jeng.make_train_step(jmodel, "masked_lm", jtx)(
        _jstate(params, jtx), _jbatch(batch))
    model = _port(params, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    teng.make_train_step(model, "masked_lm", ttx)(
        teng.create_train_state(model, ttx, device="cpu"), batch)
    start = _flat(params)
    jd = {k: v - start[k] for k, v in _flat(jstate.params).items()}
    td = {k: v - start[k] for k, v in _port_tree(model).items()}
    diff = np.sqrt(sum(np.sum((td[k] - jd[k]) ** 2) for k in jd))
    norm = np.sqrt(sum(np.sum(jd[k] ** 2) for k in jd))
    assert norm > 0 and diff / norm <= 2e-2, diff / norm
    for name in jd:
        if name.endswith("['kernel']") or name.endswith("['embedding']"):
            p0 = torch.tensor(start[name])
            lost = (p0 + torch.from_numpy(td[name])).bfloat16() == \
                p0.bfloat16()
            assert lost.float().mean() > 0.95, name
            moved = jd[name] != 0  # embedding: rows of the batch's tokens
            assert moved.mean() > 0.1 and (td[name][moved] != 0).mean() \
                > 0.99, name
