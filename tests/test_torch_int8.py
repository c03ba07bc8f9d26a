"""The port's int8 precision path against the JAX package's: quantizers,
the scaled int8 product and its plain kernel version, fake-quant, the
overflow guard, and ``gpt_tiny`` forward and training on bridged weights.

Bounds (inputs made from seeds with numpy; each bound measured on the CPU):

- ``quantize_int8`` codes and scale, the plain ``int8_matmul_dequant``,
  the forward of ``scaled_int8_matmul`` at float32 and ``fake_quant``
  (int8 and fp8): bitwise. The quantizers are the same float32
  elementwise arithmetic and the product is an exact int32 sum with one
  rounding;
- ``scaled_int8_matmul`` STE gradients: 1e-5 relative;
- ``gpt_tiny`` under quantizing policies that compute in float32 (the
  named policies' quantizers, float32 compute): logits 1e-5 abs
  (measured 1.2e-6), three guard-wrapped adamw steps: loss 1e-5 relative
  (Adam's first update is about ``lr * sign(g)``, so parameters whose
  gradient is at float noise differ by up to ``2 * lr``; the losses carry
  the rest);
- ``gpt_tiny(precision="int8")`` (bf16 compute): bf16 rounds at other
  places in the two frameworks, and one flipped code moves a product by a
  quantization step: logits 3e-2 relative in Frobenius norm (measured
  1.3e-2 to 1.5e-2; the bf16 policy alone 5e-3), three guard-wrapped
  adamw steps' losses 5e-3 relative (measured 1.9e-4, 7.3e-4, 2.9e-4);
- ``accum_steps=2`` against JAX's accumulation: loss 1e-5 relative,
  gradients 1e-4 of their norm; against the port's full-batch step,
  whose per-tensor scales see the whole batch: loss 1e-2 relative.
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
from distkeras_tpu.ops.pallas import int8_matmul as jk
from distkeras_tpu_torch import engine as teng
from distkeras_tpu_torch import precision as tprecision
from distkeras_tpu_torch.models import gpt as tgpt
from distkeras_tpu_torch.ops import optimizers as topt
from distkeras_tpu_torch.ops.kernels import int8_matmul as tk
from distkeras_tpu_torch.utils import bridge


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# -- quantizers and the product ---------------------------------------------

def _quant_input(kind):
    rng = np.random.default_rng(3)
    if kind == "zeros":
        return np.zeros((4, 5), np.float32)
    if kind == "wide":
        return (rng.standard_normal((33, 17)) * 1e4).astype(np.float32)
    if kind == "ties":  # values on half-steps of the grid: round half even
        return (np.arange(-127, 128, 0.5, dtype=np.float32) / 127.0)
    return (rng.standard_normal((64, 96)) * 3).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "zeros", "wide", "ties"])
def test_quantize_int8_codes_and_scale_bitwise(kind):
    x = _quant_input(kind)
    jc, js = jprecision.quantize_int8(jnp.asarray(x))
    tc, ts = tprecision.quantize_int8(_t(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert _bits_equal(tc.numpy(), jc) and _bits_equal(ts.numpy(), js)
    if kind == "zeros":
        assert not tc.any() and float(ts) == 1.0
    np.testing.assert_array_equal(
        tprecision.dequantize_int8(tc, ts, torch.float32).numpy(),
        np.asarray(jprecision.dequantize_int8(jc, js, jnp.float32)))


def test_quantize_int8_bitwise_on_bf16_input():
    x = jnp.asarray(_quant_input("normal")).astype(jnp.bfloat16)
    jc, js = jprecision.quantize_int8(x)
    tc, ts = tprecision.quantize_int8(
        _t(np.asarray(x.astype(jnp.float32))).bfloat16())
    assert _bits_equal(tc.numpy(), jc) and _bits_equal(ts.numpy(), js)


def test_plain_int8_matmul_bitwise_against_pallas_interpret_and_xla():
    """At 256^3 (one Pallas block): the plain version equals both the
    interpret-mode kernel and its XLA twin to the bit; the port takes the
    weight codes in the Linear layout [N, K]."""
    for qx, qw, sxw in jk.reference_rows(sizes=((256, 256, 256),)):
        want_k = jk.int8_matmul_dequant(jnp.asarray(qx), jnp.asarray(qw),
                                        sxw, interpret=True)
        want_x = jk.xla_int8_matmul_dequant(jnp.asarray(qx), jnp.asarray(qw),
                                            sxw)
        got = tk.int8_matmul_dequant(_t(qx), _t(qw.T),
                                     torch.tensor(sxw)).numpy()
        assert _bits_equal(got, want_k) and _bits_equal(got, want_x)


@pytest.mark.parametrize("m,k,n", [(100, 48, 72), (3, 16, 5), (130, 96, 1)])
def test_plain_int8_matmul_ragged_bitwise_against_xla(m, k, n):
    (qx, qw, sxw), = jk.reference_rows(sizes=((m, k, n),), seed=m)
    want = jk.xla_int8_matmul_dequant(jnp.asarray(qx), jnp.asarray(qw), sxw)
    got = tk.int8_matmul_dequant(_t(qx), _t(qw.T), torch.tensor(sxw))
    assert _bits_equal(got.numpy(), want)
    # the bf16 epilogue is the same float32 product rounded once
    got16 = tk.int8_matmul_dequant(_t(qx), _t(qw.T), torch.tensor(sxw),
                                   torch.bfloat16)
    assert torch.equal(got16, got.to(torch.bfloat16))


def test_int8_kernel_fits_predicate():
    assert tk.fits((16384, 768), (2304, 768))
    assert tk.fits((100, 48), (72, 48))      # ragged M and N are masked
    assert not tk.fits((100, 40), (72, 40))  # K not a multiple of 16
    assert not tk.fits((2, 8, 32), (16, 32))  # 3-D lhs: flatten first
    assert not tk.fits((8, 32), (16, 48))     # K mismatch


@pytest.mark.parametrize("lead", [(8,), (2, 5)])
def test_scaled_int8_matmul_forward_bitwise_and_ste_grads(lead):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(lead + (64,)).astype(np.float32)
    w = rng.standard_normal((64, 16)).astype(np.float32)
    g = rng.standard_normal(lead + (16,)).astype(np.float32)
    jout, vjp = jax.vjp(jprecision.scaled_int8_matmul, jnp.asarray(x),
                        jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g))
    tx = _t(x).requires_grad_()
    tw = _t(w.T).requires_grad_()  # the Linear layout
    tout = tprecision.scaled_int8_matmul(tx, tw)
    assert _bits_equal(tout.detach().numpy(), jout)
    tout.backward(_t(g))
    for got, want in ((tx.grad.numpy(), np.asarray(jgx)),
                      (tw.grad.numpy().T, np.asarray(jgw))):
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


@pytest.mark.parametrize("name", ["int8", "fp8-sim"])
def test_fake_quant_matches_jax(name):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((32, 40)) * 2).astype(np.float32)
    jpol, tpol = jprecision.get_policy(name), tprecision.get_policy(name)
    want = jprecision.fake_quant(jpol, jnp.asarray(x))
    tx = _t(x).requires_grad_()
    got = tprecision.fake_quant(tpol, tx)
    assert _bits_equal(got.detach().numpy(), want)
    (got ** 2).sum().backward()  # STE: the quantizer's gradient is 1
    np.testing.assert_allclose(tx.grad.numpy(), 2 * np.asarray(want),
                               rtol=1e-6)
    assert tprecision.fake_quant(tprecision.get_policy("f32"), tx) is tx


# -- overflow guard ----------------------------------------------------------

def test_overflow_guard_matches_jax_semantics():
    """The JAX package's guard test, step by step against the port's: a
    clean step updates, ``growth_interval`` clean steps double the scale
    (capped at ``max_scale``); a NaN step leaves the parameters and the
    inner state untouched, halves the scale and resets the count; the
    scale never falls below 1."""
    jpol = jprecision.PrecisionPolicy("int8", jnp.bfloat16, quant="int8",
                                      loss_scale=4.0, growth_interval=2,
                                      max_scale=16.0)
    tpol = tprecision.PrecisionPolicy("int8", torch.bfloat16, quant="int8",
                                      loss_scale=4.0, growth_interval=2,
                                      max_scale=16.0)
    jtx = jprecision.overflow_guard(optax.adam(0.1), jpol)
    jparams = {"w": jnp.ones((3,))}
    jstate = jtx.init(jparams)
    w = torch.nn.Parameter(torch.ones(3))
    guard = tprecision.overflow_guard(topt.get("adam", 0.1), tpol)([w])
    assert tprecision.current_scale(guard) == 4.0
    assert tprecision.current_scale(torch.optim.SGD([w], lr=0.1)) is None
    good = np.array([0.5, -0.25, 1.0], np.float32)
    bad = np.array([1.0, np.nan, 1.0], np.float32)
    for i, grad in enumerate([good, good, good, good, bad, good, bad, bad,
                              bad, bad]):
        up, jstate = jtx.update({"w": jnp.asarray(grad)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, up)
        inner_before = {k: v.clone() for k, v in
                        guard.state.get(w, {}).items()}
        w.grad = _t(grad.copy())
        applied = guard.step()
        assert applied == bool(np.isfinite(grad).all())
        if not applied:
            for k, v in inner_before.items():
                assert torch.equal(guard.state[w][k], v), (i, k)
        assert guard.scale == float(jstate.scale), i
        assert guard.good_steps == int(jstate.good_steps), i
        # optax takes Adam's bias corrections in float32, torch in
        # float64: 2e-6 apart at lr 0.1
        np.testing.assert_allclose(w.detach().numpy(),
                                   np.asarray(jparams["w"]), rtol=0,
                                   atol=1e-5, err_msg=str(i))
    assert guard.scale == 1.0  # floor after repeated skips


def test_apply_to_model_checks_the_policy():
    model = tgpt.gpt_tiny(precision="int8")
    assert tprecision.apply_to_model(model, "int8") is model
    assert tprecision.apply_to_model(model, None) is model
    with pytest.raises(ValueError, match="contradicts"):
        tprecision.apply_to_model(model, "bf16")
    with pytest.raises(ValueError, match="no `precision` field"):
        tprecision.apply_to_model(torch.nn.Linear(2, 2), "bf16")
    built = tgpt.gpt_tiny()  # re-stamped: a copy with the policy
    stamped = tprecision.apply_to_model(built, "int8")
    assert stamped is not built and stamped.precision == "int8"
    assert built.precision is None
    with pytest.raises(ValueError, match="unknown precision"):
        tprecision.apply_to_model(model, "int4")


# -- gpt_tiny through the int8 path -----------------------------------------

def _f32_policies(quant):
    """The named policy's quantizer and loss scale with float32 compute,
    in both packages (a policy object passes through both)."""
    return (jprecision.PrecisionPolicy("f32-" + quant, jnp.float32,
                                       quant=quant, loss_scale=16.0),
            tprecision.PrecisionPolicy("f32-" + quant, torch.float32,
                                       quant=quant, loss_scale=16.0))


def _models(jpol, tpol):
    jmodel = jgpt.gpt_tiny(precision=jpol)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    return jmodel, params, bridge.load_flax_params(
        tgpt.gpt_tiny(precision=tpol), params)


def _batch(b=2, t=64, seed=1):
    x = np.random.default_rng(seed).integers(0, 256, (b, t)).astype(
        np.int32)
    y = np.concatenate([x[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
    return {"features": x, "labels": y}


def _logits(jmodel, params, model, batch):
    want = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(batch["features"])))
    with torch.no_grad():
        got = model(_t(batch["features"])).numpy()
    return got, want


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_gpt_tiny_logits_match_jax_at_f32_compute(quant):
    jmodel, params, model = _models(*_f32_policies(quant))
    got, want = _logits(jmodel, params, model, _batch())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_int8_gpt_tiny_logits_match_jax():
    """The named policy (bf16 compute): the LM head stays float32 and
    unquantized; logits within the stated bf16 bound."""
    jmodel, params, model = _models("int8", "int8")
    assert model.dtype == torch.bfloat16
    assert model.lm_head.weight.dtype == torch.float32
    assert model.layers[0].mlp.fc1._dot is tprecision.scaled_int8_matmul
    got, want = _logits(jmodel, params, model, _batch())
    assert got.dtype == np.float32
    assert np.linalg.norm(got - want) <= 3e-2 * np.linalg.norm(want)


def _guarded_steps(jmodel, params, model, jpol, tpol, steps, accum=1):
    jtx = jprecision.overflow_guard(optax.adamw(1e-3), jpol)
    ttx = tprecision.overflow_guard(topt.get("adamw", 1e-3), tpol)
    jstep = jeng.make_train_step(jmodel, "masked_lm", jtx, precision=jpol,
                                 accum_steps=accum)
    tstep = teng.make_train_step(model, "masked_lm", ttx, precision=tpol,
                                 accum_steps=accum)
    p = jax.tree.map(jnp.asarray, params)
    jstate = jeng.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                             opt_state=jtx.init(p))
    tstate = teng.create_train_state(model, ttx, device="cpu")
    losses = []
    for i in range(steps):
        batch = _batch(seed=30 + i)
        jstate, jout = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tstate, tout = tstep(tstate, batch)
        losses.append((float(tout["loss"]), float(jout["loss"])))
        assert tstate.opt_state.scale == float(jstate.opt_state.scale)
    return losses, jstate, tstate


def test_guarded_int8_steps_match_jax_at_f32_compute():
    jpol, tpol = _f32_policies("int8")
    jmodel, params, model = _models(jpol, tpol)
    losses, _, tstate = _guarded_steps(jmodel, params, model, jpol, tpol, 3)
    assert all(_rel(a, b) <= 1e-5 for a, b in losses), losses
    assert tstate.opt_state.good_steps == 3


def test_guarded_int8_steps_match_jax():
    """Three guard-wrapped adamw(1e-3) steps under precision="int8"
    through make_train_step: the losses against the JAX engine's, the
    guard's scale 16 on both sides."""
    jmodel, params, model = _models("int8", "int8")
    losses, _, tstate = _guarded_steps(jmodel, params, model,
                                       jprecision.get_policy("int8"),
                                       tprecision.get_policy("int8"), 3)
    assert all(_rel(a, b) <= 5e-3 for a, b in losses), losses
    assert tstate.opt_state.scale == 16.0


def test_int8_accumulation_matches_jax_and_the_full_batch():
    jpol, tpol = _f32_policies("int8")
    jmodel, params, model = _models(jpol, tpol)
    batch = _batch(b=4, seed=40)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jeng.make_accum_grad_fn(
        jmodel, "masked_lm", 2, precision=jpol)(params, jb)
    tb = teng.to_device(batch, "cpu")
    (tloss, _), tgrads = teng.make_accum_grad_fn(
        model, "masked_lm", 2, precision=tpol)(tb)
    assert _rel(tloss, jloss) <= 1e-5
    got = bridge.state_dict_to_flax(tgrads)
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        want = np.asarray(want)
        assert np.linalg.norm(leaf - want) <= 1e-4 * max(
            np.linalg.norm(want), 1e-30), path
    (full_loss, _), _ = teng.make_grad_fn(model, "masked_lm",
                                          precision=tpol)(tb)
    assert _rel(tloss, full_loss) <= 1e-2


def test_power_of_two_loss_scale_is_exact():
    """Scaling the loss by 16 and unscaling the float32 gradients gives
    the unscaled gradients to the bit (and the unscaled loss)."""
    _, tpol = _f32_policies("int8")
    model = tgpt.init_params(tgpt.gpt_tiny(precision=tpol),
                             torch.Generator().manual_seed(5))
    batch = teng.to_device(_batch(seed=7), "cpu")
    grad_fn = teng.make_grad_fn(model, "masked_lm", precision=tpol)
    (l16, _), g16 = grad_fn(batch)
    (l1, _), g1 = grad_fn(batch, loss_scale=1.0)
    assert float(l16) == float(l1)
    assert all(torch.equal(g16[n], g1[n]) for n in g1)
