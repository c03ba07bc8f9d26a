"""Mixed-precision compute policies (port of ``distkeras_tpu/precision.py``).

- :class:`PrecisionPolicy`: one of ``f32 | bf16 | int8 | fp8-sim``.
  ``int8`` computes in bf16 with per-tensor symmetric int8 quantization
  of every Dense product (a real int8 product through
  :func:`scaled_int8_matmul` and the Hopper kernel of
  :mod:`distkeras_tpu_torch.ops.kernels.int8_matmul`; fake-quant for
  convolutions); ``fp8-sim`` round-trips both operands of a product
  through ``torch.float8_e4m3fn`` on the bf16 path.
- Master weights stay float32 under every policy; only the compute
  drops precision.
- Loss scaling: the step engine multiplies the loss by the scale before
  ``autograd.grad`` and unscales the gradients in float32 after. The
  scale is the policy's, unless the optimizer is wrapped by
  :func:`overflow_guard`, which carries the live scale (skip and rescale).
- Quantizer scales come from each operand's own ``amax`` at every call:
  no calibration, no state.

Gradients through quantizers are straight-through (STE): the forward sees
the quantized value, the backward the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch
from torch.nn import functional as F

from distkeras_tpu_torch.comms.codec import (affine_dequantize,
                                             affine_qparams, affine_quantize)
from distkeras_tpu_torch.ops import optimizers
from distkeras_tpu_torch.ops.kernels import int8_matmul as int8_kernels

#: symmetric int8 grid: codes 0..254 centred on 127, so signed [-127, 127]
_INT8_LEVELS = 254
#: largest finite float8_e4m3fn magnitude, the fp8-sim clip point
_FP8_E4M3_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """A named compute-precision contract (the JAX package's fields)."""

    name: str
    compute_dtype: torch.dtype
    quant: Optional[str] = None        # None | "int8" | "fp8"
    loss_scale: float = 1.0            # static / initial dynamic scale
    growth_interval: int = 200         # clean steps between scale doublings
    max_scale: float = 2.0 ** 15

    @property
    def mfu_dtype(self) -> str:
        """The hardware peak this policy's MFU is honest against: fp8-sim
        does its arithmetic in bf16 (the fp8 cast is a simulation)."""
        return {"f32": "f32", "bf16": "bf16", "int8": "int8",
                "fp8-sim": "bf16"}[self.name]


_POLICIES = {
    "f32": PrecisionPolicy("f32", torch.float32),
    "bf16": PrecisionPolicy("bf16", torch.bfloat16),
    "int8": PrecisionPolicy("int8", torch.bfloat16, quant="int8",
                            loss_scale=2.0 ** 4),
    "fp8-sim": PrecisionPolicy("fp8-sim", torch.bfloat16, quant="fp8",
                               loss_scale=2.0 ** 4),
}

PRECISION_POLICIES = tuple(_POLICIES)


def validate_precision(precision) -> Optional[str]:
    """A ``precision=`` knob as a policy name (or None); raises ValueError
    for an unknown name."""
    if precision is None:
        return None
    if isinstance(precision, PrecisionPolicy):
        precision = precision.name
    if precision not in _POLICIES:
        raise ValueError(f"unknown precision {precision!r}; valid policies: "
                         f"{PRECISION_POLICIES}")
    return precision


def get_policy(precision: Union[str, PrecisionPolicy, None]
               ) -> Optional[PrecisionPolicy]:
    """``None`` -> None; a policy passes through; a name -> its policy."""
    if precision is None or isinstance(precision, PrecisionPolicy):
        return precision
    return _POLICIES[validate_precision(precision)]


def resolve(precision, dtype: torch.dtype) -> torch.dtype:
    """The compute dtype of a model whose ``precision`` field is
    ``precision`` and whose ``dtype`` field is ``dtype`` (``None`` leaves
    the model's own dtype). The Dense and conv hooks are
    :func:`make_dot_general` and :func:`make_conv_general`."""
    policy = get_policy(precision)
    return dtype if policy is None else policy.compute_dtype


# -- per-tensor quantizers (the wire codec's affine rule) -------------------

def symmetric_int8_qparams(amax):
    """Step of the symmetric int8 grid over ``[-amax, amax]``: amax / 127."""
    return affine_qparams(-amax, amax, _INT8_LEVELS)


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8: ``(codes int8 in [-127, 127], scale)``,
    the scale a float32 0-d tensor. An all-zero tensor gives zero codes
    and scale 1."""
    f32 = x.float()
    amax = f32.abs().amax()
    scale = symmetric_int8_qparams(amax)
    codes = affine_quantize(f32, -amax, scale, _INT8_LEVELS) - 127.0
    ok = scale > 0
    codes = torch.where(ok, codes, 0.0)
    return codes.to(torch.int8), torch.where(ok, scale, 1.0)


def dequantize_int8(codes: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """``scale * codes`` in float32, then ``dtype``."""
    return affine_dequantize(codes.float(), 0.0, scale).to(dtype)


def _fp8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor-scaled cast through ``float8_e4m3fn`` and back: the exact
    e4m3 value grid, computed in ``x``'s dtype."""
    f32 = x.float()
    amax = f32.abs().amax()
    scale = torch.where(amax > 0, amax / _FP8_E4M3_MAX, 1.0)
    q = (f32 / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(x.dtype)


def fake_quant(policy: Optional[PrecisionPolicy],
               x: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient: the forward
    value is what the low-precision op would consume, the backward the
    identity."""
    if policy is None or policy.quant is None:
        return x
    if policy.quant == "int8":
        codes, scale = quantize_int8(x)
        deq = dequantize_int8(codes, scale, x.dtype)
    elif policy.quant == "fp8":
        deq = _fp8_roundtrip(x)
    else:  # pragma: no cover - the registry is closed
        raise ValueError(f"unknown quant kind {policy.quant!r}")
    return x + (deq - x).detach()


# -- the scaled-int8 matmul -------------------------------------------------

def _int8_dot_impl(qx, sx, qw, sw, out_dtype: torch.dtype) -> torch.Tensor:
    """``qx [..., K]`` times ``qw [N, K]`` (the Linear layout) in int8 with
    an int32 sum, dequantized by ``sx * sw`` (the float32 product of the
    two scales, taken first), in ``out_dtype``: the int8 kernel for CUDA
    tensors, its plain version for CPU tensors."""
    k = qx.shape[-1]
    out = int8_kernels.int8_matmul_dequant(qx.reshape(-1, k), qw, sx * sw,
                                           out_dtype)
    return out.reshape(*qx.shape[:-1], qw.shape[0])


class _ScaledInt8Matmul(torch.autograd.Function):
    """The JAX package's ``custom_vjp``: the forward quantizes both
    operands and saves the int8 codes and scales; the backward is the STE
    rule on the dequantized operands, two products in the gradient's
    dtype."""

    @staticmethod
    def forward(ctx, x, weight):
        qx, sx = quantize_int8(x)
        qw, sw = quantize_int8(weight)
        ctx.save_for_backward(qx, sx, qw, sw)
        return _int8_dot_impl(qx, sx, qw, sw, x.dtype)

    @staticmethod
    def backward(ctx, g):
        qx, sx, qw, sw = ctx.saved_tensors
        dt = g.dtype
        xh = dequantize_int8(qx, sx, dt)     # [..., K]
        wh = dequantize_int8(qw, sw, dt)     # [N, K]
        dx = torch.matmul(g, wh)             # [..., N] x [N, K]
        dw = torch.matmul(g.reshape(-1, g.shape[-1]).t(),
                          xh.reshape(-1, xh.shape[-1]))  # [N, K]
        return dx.to(dt), dw.to(dt)


def scaled_int8_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` with both operands per-tensor symmetrically
    quantized to int8 and the product summed in int32; ``x`` is
    ``[..., K]``, ``weight`` ``[N, K]`` (the Linear layout; the JAX
    function takes its transpose, and a per-tensor scale does not depend
    on layout). Output in ``x``'s dtype."""
    return _ScaledInt8Matmul.apply(x, weight)


# -- layer hooks ------------------------------------------------------------

def make_dot_general(policy: Optional[PrecisionPolicy]) -> Optional[Callable]:
    """The product of a Dense layer, ``(x [..., K], weight [N, K]) ->
    [..., N]``: int8 through :func:`scaled_int8_matmul`, fp8 through
    fake-quantized operands. None when the policy does not quantize."""
    if policy is None or policy.quant is None:
        return None
    if policy.quant == "int8":
        return scaled_int8_matmul

    def dot_general(x, weight):
        return F.linear(fake_quant(policy, x), fake_quant(policy, weight))

    return dot_general


def make_conv_general(policy: Optional[PrecisionPolicy]
                      ) -> Optional[Callable]:
    """``F.conv2d`` with both operands fake-quantized (no int8 conv);
    None when the policy does not quantize."""
    if policy is None or policy.quant is None:
        return None

    def conv_general(x, weight, **kwargs):
        return F.conv2d(fake_quant(policy, x), fake_quant(policy, weight),
                        **kwargs)

    return conv_general


# -- loss scaling and overflow skip-and-rescale -----------------------------

class OverflowGuardState:
    """A ``torch.optim`` optimizer (``inner``) with the live loss scale
    (``scale``) and the count of clean steps since the last skip
    (``good_steps``): the JAX package's ``(inner, scale, good_steps)``
    optimizer state. :meth:`step` skips the update on non-finite
    gradients (one host read of a finiteness flag a step)."""

    def __init__(self, inner: torch.optim.Optimizer, policy: PrecisionPolicy):
        self.inner = inner
        self.policy = policy
        self.scale = float(policy.loss_scale)
        self.good_steps = 0

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def step(self) -> bool:
        """Apply the inner update if every gradient is finite and return
        whether it was applied. Finite: ``good_steps`` + 1, and every
        ``growth_interval`` clean steps the scale doubles (capped at
        ``max_scale``). Non-finite: the inner optimizer and its state are
        untouched, the scale halves (floor 1), ``good_steps`` resets."""
        grads = [p.grad for group in self.inner.param_groups
                 for p in group["params"] if p.grad is not None]
        finite = (not grads) or bool(
            torch.stack([torch.isfinite(g).all() for g in grads]).all())
        if finite:
            self.inner.step()
            self.good_steps += 1
            if self.good_steps % self.policy.growth_interval == 0:
                self.scale = min(self.scale * 2.0, self.policy.max_scale)
        else:
            self.good_steps = 0
            self.scale = max(self.scale * 0.5, 1.0)
        return finite


def current_scale(opt_state) -> Optional[float]:
    """The live loss scale of a guard-wrapped optimizer, or None when the
    optimizer is not guarded (the policy's static scale applies)."""
    if isinstance(opt_state, OverflowGuardState):
        return opt_state.scale
    return None


def overflow_guard(tx, policy: PrecisionPolicy) -> Callable:
    """Wrap an optimizer factory (:func:`~distkeras_tpu_torch.ops.optimizers.get`'s
    ``params -> Optimizer``, or its name) with loss-scale bookkeeping and
    non-finite-gradient protection; returns a factory of
    :class:`OverflowGuardState`. The gradients that reach the optimizer
    are already unscaled (the grad fn divides by the scale it applied)."""
    factory = optimizers.get(tx)

    def build(params) -> OverflowGuardState:
        return OverflowGuardState(factory(params), policy)

    return build


def scale_grads_fn(policy: Optional[PrecisionPolicy]):
    """``(pre, post)``: ``pre(loss, S)`` scales the objective,
    ``post(grads, S)`` unscales a dict of gradients in float32 (exact for
    the power-of-two scales the guard emits). None for no policy."""
    if policy is None:
        return None

    def pre(loss, scale):
        return loss * (scale.to(loss.dtype) if torch.is_tensor(scale)
                       else scale)

    def post(grads: dict, scale) -> dict:
        inv = 1.0 / scale
        return {n: (g.float() * inv).to(g.dtype) for n, g in grads.items()}

    return pre, post


def apply_to_model(model, precision):
    """Check that ``model`` carries the policy ``precision`` names and
    return it. A port model wires its policy into its layers when it is
    built, so a model built with ``precision=None`` cannot be re-stamped
    afterwards (the JAX package clones the module definition): build it
    with ``precision=`` instead."""
    name = validate_precision(precision)
    if name is None:
        return model
    if not hasattr(model, "precision"):
        raise ValueError(
            f"precision={name!r} was requested but {type(model).__name__} "
            f"has no `precision` field; custom models must add it to opt "
            f"into mixed precision")
    if model.precision == name:
        return model
    if model.precision is not None:
        raise ValueError(
            f"trainer precision={name!r} contradicts the model's own "
            f"precision={model.precision!r}; set it in one place")
    raise NotImplementedError(
        f"re-stamping a built {type(model).__name__} with precision={name!r}"
        f" is not ported (ROADMAP.md Queue A, item 12, the trainer API that "
        f"calls it); build the model with precision={name!r}")
