"""GroupNorm: the hand-written Hopper kernels (forward and backward), their
plain versions, the differentiable op and the ``nn.Module``.

Port of ``distkeras_tpu/ops/pallas/groupnorm.py``. The op normalizes
``x [B, HW, C]`` (a sample's NHWC activation viewed as HW rows of C
channels) over each (sample, group) of ``C / G`` consecutive channels::

    forward   y [B, HW, C] in x's dtype, stats float32 [B, 2, G] = (mu, rstd)
              (csrc/groupnorm.cu ``gn_fwd_kernel``, replacing _fwd_kernel)
    backward  dx [B, HW, C] in x's dtype, per-sample dgamma/dbeta partials
              float32 [B, C], summed over B by one ``torch.sum``
              (``gn_bwd_kernel``, replacing _bwd_kernel)

The functions are the JAX module's float32 references: ``_reference``
with its two-pass variance (not the Pallas kernel's ``E[x^2] - mu^2``)
and ``_jnp_bwd_from_stats``, with every sum accumulated in float64 and
rounded once to float32, so that the kernels, whatever order they add
in, reproduce the plain versions bitwise. Dispatch: a CUDA tensor goes to the kernel
(built on first use by :mod:`._build`), a CPU tensor to the plain
version; a tensor the kernel does not take raises. Each launch adds one to
``group_norm_fwd.launches`` or ``group_norm_bwd.launches``. Unlike the JAX
package (``USE_FUSED_GROUPNORM``) there is no switch that routes a card
tensor past the kernel.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from distkeras_tpu_torch.ops.kernels._build import SMEM_OPTIN_BYTES

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: threads a CTA (csrc/groupnorm.cu kThreads); a row may hold at most this
#: many load chunks
_THREADS = 256
#: shared memory left for the kernels' static arrays
_SMEM_SLACK = 1024

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from distkeras_tpu_torch.ops.kernels import _build

        lib = _build.load("groupnorm", ["groupnorm.cu"])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.groupnorm_fwd_launch.argtypes = (
            [i32, i32] + [ptr] * 5 + [i32] * 4 + [ctypes.c_float, ptr])
        lib.groupnorm_fwd_launch.restype = i32
        lib.groupnorm_bwd_launch.argtypes = (
            [i32, i32] + [ptr] * 7 + [i32] * 4 + [ctypes.c_float, ptr])
        lib.groupnorm_bwd_launch.restype = i32
        lib.groupnorm_error_string.argtypes = [i32]
        lib.groupnorm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _vec(channels_per_group: int, itemsize: int) -> int:
    """Values a load: the largest of 8, 4, 2, 1 that divides the group's
    channels and fits 16 bytes."""
    return next(v for v in (8, 4, 2, 1)
                if v * itemsize <= 16 and channels_per_group % v == 0)


def smem_bytes(shape, groups: int, dtype, backward: bool) -> int:
    """Dynamic shared memory one CTA uses: the (sample, group) slab of x
    (forward), of x and dy plus the per-thread dgamma/dbeta partials
    (backward)."""
    _, hw, c = shape
    item = torch.finfo(dtype).bits // 8
    slab = hw * (c // groups) * item
    if not backward:
        return slab
    return -(-2 * slab // 16) * 16 + 2 * 8 * _THREADS * _vec(c // groups,
                                                             item)


def fits(shape, groups: int, dtype, backward: bool = False) -> bool:
    """Whether the kernels take ``x`` of ``shape`` ([B, HW, C]) in
    ``dtype`` with ``groups`` groups: G divides C, a row of the group
    loads in at most 256 chunks, and the slab(s) fit the card's opt-in
    shared memory."""
    if len(shape) != 3 or dtype not in _DTYPE_CODES or groups < 1:
        return False
    b, hw, c = shape
    if b < 1 or hw < 1 or c % groups:
        return False
    cg = c // groups
    if cg // _vec(cg, torch.finfo(dtype).bits // 8) > _THREADS:
        return False
    return smem_bytes(shape, groups, dtype, backward) \
        <= SMEM_OPTIN_BYTES - _SMEM_SLACK


def _group_sum(t, groups: int):
    """Sum of float32 ``t [B, HW, C]`` over each (sample, group),
    accumulated in float64 and rounded once to float32: ``[B, 1, G, 1]``
    (the kernels' sums, equal to the last bit whatever the order)."""
    b, hw, c = t.shape
    return t.double().reshape(b, hw, groups, c // groups).sum(
        dim=(1, 3), keepdim=True)


def group_norm_fwd_reference(x, gamma, beta, groups: int, eps: float = 1e-6):
    """Plain version of the forward kernel (``_reference``, plus the
    stats): mean and two-pass variance per (sample, group), summed in
    float64 and rounded to float32, ``rstd = 1 / sqrt(var + eps)``,
    ``((x - mu) * rstd) * gamma + beta``
    in float32 rounded once to x's dtype; ``stats`` float32 ``[B, 2,
    G]``."""
    b, hw, c = x.shape
    n = hw * (c // groups)
    xf = x.float()
    mu = (_group_sum(xf, groups) / n).float()
    d = xf.reshape(b, hw, groups, c // groups) - mu
    var = (_group_sum((d * d).reshape(b, hw, c), groups) / n).float()
    rstd = torch.reciprocal(torch.sqrt(var + eps))  # both correctly rounded
    xhat = (d * rstd).reshape(b, hw, c)
    y = (xhat * gamma.float() + beta.float()).to(x.dtype)
    stats = torch.stack([mu.reshape(b, groups), rstd.reshape(b, groups)],
                        dim=1)
    return y, stats


def group_norm_bwd_reference(x, gamma, stats, dy, groups: int):
    """Plain version of the backward kernel (``_jnp_bwd_from_stats``):
    ``(dx in x's dtype, dgamma_p, dbeta_p)``, the partials float32
    ``[B, C]`` (summed over HW, not yet over B); sums in float64 rounded
    once to float32, every other operation in float32."""
    b, hw, c = x.shape
    cg = c // groups
    per_channel = lambda t: t.repeat_interleave(cg, dim=1)[:, None, :]
    mu_c, rstd_c = per_channel(stats[:, 0, :]), per_channel(stats[:, 1, :])
    xf, dyf = x.float(), dy.float()
    xhat = (xf - mu_c) * rstd_c
    dxhat = dyf * gamma.float()
    inv_n = 1.0 / (hw * cg)
    group_sum = lambda t: _group_sum(t, groups).float().reshape(b, groups)
    m1 = per_channel(group_sum(dxhat) * inv_n)
    m2 = per_channel(group_sum(dxhat * xhat) * inv_n)
    dx = (rstd_c * (dxhat - m1 - xhat * m2)).to(x.dtype)
    channel_sum = lambda t: t.double().sum(dim=1).float()
    return dx, channel_sum(dyf * xhat), channel_sum(dyf)


def _check(name, x, groups, others, backward):
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported (float32, "
                         f"bfloat16)")
    if not fits(x.shape, groups, x.dtype, backward):
        raise ValueError(
            f"{name}: kernel does not take x {tuple(x.shape)} {x.dtype} with "
            f"{groups} groups ([B, HW, C], G dividing C, at most 256 load "
            f"chunks a group row, a (sample, group) slab within "
            f"{SMEM_OPTIN_BYTES - _SMEM_SLACK} B of shared memory)")
    for t in (x, *others):
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             f"16-byte aligned")


def _params(gamma, c):
    """gamma or beta as the float32 ``[C]`` the kernels read."""
    if gamma.shape != (c,):
        raise ValueError(f"group_norm: gamma/beta must be [{c}], got "
                         f"{tuple(gamma.shape)}")
    return gamma.float().contiguous()


def _raise_on(err, lib, what):
    if err != 0:
        raise RuntimeError(
            f"groupnorm {what} kernel launch failed: cudaError {err} "
            f"({lib.groupnorm_error_string(err).decode()})")


def group_norm_fwd(x, gamma, beta, groups: int, eps: float = 1e-6):
    """``(y, stats)``: the Hopper kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return group_norm_fwd_reference(x, gamma, beta, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_fwd: no kernel for device {x.device}")
    gamma, beta = _params(gamma, x.shape[-1]), _params(beta, x.shape[-1])
    _check("group_norm_fwd", x, groups, (gamma, beta), backward=False)
    b, hw, c = x.shape
    y = torch.empty_like(x)
    stats = torch.empty((b, 2, groups), dtype=torch.float32, device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.groupnorm_fwd_launch(
            _DTYPE_CODES[x.dtype], _vec(c // groups, x.element_size()),
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            stats.data_ptr(), b, hw, c, groups, eps, stream)
    _raise_on(err, lib, "forward")
    group_norm_fwd.launches += 1
    return y, stats


def group_norm_bwd(x, gamma, stats, dy, groups: int):
    """``(dx, dgamma_p, dbeta_p)``: the Hopper kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return group_norm_bwd_reference(x, gamma, stats, dy, groups)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_bwd: no kernel for device {x.device}")
    gamma = _params(gamma, x.shape[-1])
    _check("group_norm_bwd", x, groups, (gamma, stats, dy), backward=True)
    b, hw, c = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype \
            or tuple(stats.shape) != (b, 2, groups) \
            or stats.dtype != torch.float32:
        raise ValueError("group_norm_bwd: dy must match x, stats must be "
                         "float32 [B, 2, G]")
    dx = torch.empty_like(x)
    dgamma_p = torch.empty((b, c), dtype=torch.float32, device=x.device)
    dbeta_p = torch.empty((b, c), dtype=torch.float32, device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.groupnorm_bwd_launch(
            _DTYPE_CODES[x.dtype], _vec(c // groups, x.element_size()),
            x.data_ptr(), gamma.data_ptr(), stats.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dgamma_p.data_ptr(), dbeta_p.data_ptr(), b, hw,
            c, groups, 1.0 / (hw * (c // groups)), stream)
    _raise_on(err, lib, "backward")
    group_norm_bwd.launches += 1
    return dx, dgamma_p, dbeta_p


group_norm_fwd.launches = 0
group_norm_bwd.launches = 0


class _GroupNormFn(torch.autograd.Function):
    """The JAX module's ``custom_vjp``: the forward saves ``(x, gamma,
    stats)``, the backward runs the backward kernel and sums the
    per-sample partials over B (cast to gamma's dtype)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps):
        y, stats = group_norm_fwd(x, gamma, beta, groups, eps)
        ctx.save_for_backward(x, gamma, stats)
        ctx.groups = groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, stats = ctx.saved_tensors
        dx, dgamma_p, dbeta_p = group_norm_bwd(x, gamma, stats,
                                               dy.contiguous(), ctx.groups)
        return (dx, dgamma_p.sum(dim=0).to(gamma.dtype),
                dbeta_p.sum(dim=0).to(gamma.dtype), None, None)


def group_norm(x, gamma, beta, groups: int, eps: float = 1e-6):
    """Differentiable GroupNorm over ``x [B, HW, C]`` (module docstring)."""
    if x.dim() != 3 or x.shape[-1] % groups:
        raise ValueError(f"group_norm: x must be [B, HW, C] with {groups} "
                         f"dividing C, got {tuple(x.shape)}")
    return _GroupNormFn.apply(x.contiguous(), gamma, beta, groups, eps)


class GroupNorm(nn.Module):
    """GroupNorm over the last axis of ``x [B, ..., C]`` (flax's
    ``nn.GroupNorm`` layout and names: ``weight`` is flax's ``scale``,
    ``bias`` its ``bias``, both float32), through :func:`group_norm`.
    ``scale_init`` is ``"ones"`` or ``"zeros"`` (the zero-init last norm
    of a residual branch). The output has x's dtype."""

    def __init__(self, num_channels: int, num_groups: int, eps: float = 1e-6,
                 scale_init: str = "ones"):
        super().__init__()
        if scale_init not in ("ones", "zeros"):
            raise ValueError(f"scale_init must be 'ones' or 'zeros', got "
                             f"{scale_init!r}")
        self.num_groups = num_groups
        self.eps = eps
        self.scale_init = scale_init
        self.weight = nn.Parameter(torch.ones(num_channels) if
                                   scale_init == "ones"
                                   else torch.zeros(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        y = group_norm(x.reshape(shape[0], -1, shape[-1]), self.weight,
                       self.bias, self.num_groups, self.eps)
        return y.reshape(shape)
