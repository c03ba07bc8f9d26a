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
in, reproduce the plain versions bitwise. :func:`plan` tiles a call:
the cluster path (one launch; a thread-block cluster shares the
statistics of a sample's rows) or, where that outgrows a cluster's shared
memory, the streaming path (a float64 workspace; three forward launches,
two backward). Dispatch: a CUDA tensor goes to the kernel (built on first
use by :mod:`._build`), a CPU tensor to the plain version; a tensor the
kernel does not take (another dtype, G not dividing C, not contiguous or
not 16-byte aligned) raises. Each call adds one to
``group_norm_fwd.launches`` or ``group_norm_bwd.launches``. Unlike the JAX
package (``USE_FUSED_GROUPNORM``) there is no switch that routes a card
tensor past the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch import nn

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: threads and shared memory a CTA, first choice: a tile row holds at
#: most CTA_THREADS load chunks
CTA_THREADS = 128
TILE_BYTES = 56 * 1024
#: ... and where a sample's column block does not fit a cluster of such
#: CTAs: csrc/groupnorm.cu kMaxThreads, and two CTAs an SM (228 KB, less
#: 1 KB reserved a CTA)
_BIG_CTA_THREADS = 256
_BIG_TILE_BYTES = 110 * 1024
#: shared memory a CTA of the streaming path takes at most: smaller
#: tiles, more CTAs in flight
STREAM_TILE_BYTES = 48 * 1024
#: CTAs a cluster at most (16 is Hopper's non-portable limit)
MAX_CLUSTER = 16
#: column blocks are preferably this wide (one 128-byte line a row) ...
_PREFERRED_BYTES = 128
#: ... wider, up to _WIDE_BYTES, while a tile holds fewer values (all
#: tensors) than this many a thread ...
_VALUES_PER_THREAD = 96
_WIDE_BYTES = 512
#: ... and narrower, down to this, while a sample does not fit a cluster
#: (each bound yields to the whole row, or to one group, if that is
#: beyond it)
_MIN_BYTES = 64

_lib = None


class Plan(NamedTuple):
    """How the kernels tile ``x [B, HW, C]``: column blocks of ``cols``
    channels (whole groups, or on the streaming path a part of one group
    wider than ``threads`` chunks), ``rows`` rows a CTA, ``tiles`` CTAs a
    (sample, column block), ``cluster`` CTAs a cluster (``tiles`` on the
    cluster path, 1 when streaming), ``vec`` values a load, ``threads``
    threads and ``smem`` bytes of dynamic shared memory a CTA."""
    path: str
    cols: int
    rows: int
    tiles: int
    cluster: int
    vec: int
    threads: int
    smem: int


def _kernel_lib():
    global _lib
    if _lib is None:
        from distkeras_tpu_torch.ops.kernels import _build

        lib = _build.load("groupnorm", ["groupnorm.cu"])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.groupnorm_fwd_launch.argtypes = (
            [i32, i32] + [ptr] * 6 + [i32] * 10 + [ctypes.c_float, ptr])
        lib.groupnorm_fwd_launch.restype = i32
        lib.groupnorm_bwd_launch.argtypes = (
            [i32, i32] + [ptr] * 8 + [i32] * 10 + [ctypes.c_float, ptr])
        lib.groupnorm_bwd_launch.restype = i32
        lib.groupnorm_error_string.argtypes = [i32]
        lib.groupnorm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _itemsize(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _vec(cols: int, c: int, itemsize: int) -> int:
    """Values a load: the largest of 8, 4, 2, 1 within 16 bytes that
    divides the column block and the row."""
    return next(v for v in (8, 4, 2, 1)
                if v * itemsize <= 16 and cols % v == 0 and c % v == 0)


def smem_bytes(rows: int, cols: int, vec: int, itemsize: int, cg: int,
               backward: bool, threads: int) -> int:
    """Dynamic shared memory of a CTA (csrc/groupnorm.cu ``layout``): the
    tile of x (and dy), the reduction scratch (a row of float64 a warp, or
    a thread row where a row's chunks do not divide 32), two float64
    partials a group, backward two a channel, and two float32 values a
    group."""
    ng = cols // cg if cols >= cg else 1
    tile = -(-rows * cols * itemsize // 16) * 16
    cpr = cols // vec
    red_rows = threads // 32 if 32 % cpr == 0 else threads // cpr
    return ((2 if backward else 1) * tile + 8 * red_rows * cols + 16 * ng
            + (16 * cols if backward else 0) + 8 * ng)


def _rows_within(budget, cols, vec, item, cg, backward, threads) -> int:
    fixed = smem_bytes(0, cols, vec, item, cg, backward, threads)
    return max(0, (budget - fixed) // ((2 if backward else 1) * cols * item))


@functools.lru_cache(maxsize=1024)
def plan(shape, groups: int, dtype, backward: bool = False) -> Plan:
    """The tiling of ``x`` of ``shape`` ([B, HW, C]) in ``dtype`` with
    ``groups`` groups (a pure function of its arguments; the C entry
    validates what it is given).

    Column blocks are whole groups. The preferred one is the narrowest of
    at least ``_PREFERRED_BYTES``, widened (up to ``_WIDE_BYTES``) while a
    sample's tile would hold fewer than ``_VALUES_PER_THREAD`` values a
    thread. Cluster path: from the preferred block, narrowed by halves
    down to ``_MIN_BYTES``, the first whose sample rows fit ``TILE_BYTES``
    a CTA of ``CTA_THREADS`` over at most ``MAX_CLUSTER`` CTAs, then the
    same with the larger CTAs; the rows are shared evenly. Otherwise the
    streaming path, at the preferred block (a part of one group where a
    group's row is wider than ``CTA_THREADS`` chunks), in tiles of
    ``STREAM_TILE_BYTES``. (The constants were chosen by timing on the
    card: PERF.md.)"""
    b, hw, c = shape
    item = _itemsize(dtype)
    cg = c // groups
    tensors = 2 if backward else 1
    widest = max(cg * item, _WIDE_BYTES)
    blocks = [k * cg for k in range(1, groups + 1)
              if groups % k == 0 and k * cg * item <= widest]
    at = next((i for i, cols in enumerate(blocks)
               if cols * item >= min(_PREFERRED_BYTES, c * item)),
              len(blocks) - 1)
    while at + 1 < len(blocks) and \
            hw * blocks[at] * tensors < _VALUES_PER_THREAD * CTA_THREADS:
        at += 1
    narrower = [cols for cols in reversed(blocks[:at + 1])
                if cols * item >= min(_MIN_BYTES, c * item)]
    for threads, budget in ((CTA_THREADS, TILE_BYTES),
                            (_BIG_CTA_THREADS, _BIG_TILE_BYTES)):
        for cols in narrower:
            vec = _vec(cols, c, item)
            if cols // vec > threads:
                continue
            fit = _rows_within(budget, cols, vec, item, cg, backward,
                               threads)
            if fit < 1 or -(-hw // fit) > MAX_CLUSTER:
                continue
            rows = -(-hw // -(-hw // fit))
            cluster = -(-hw // rows)
            return Plan("cluster", cols, rows, cluster, cluster, vec,
                        threads, smem_bytes(rows, cols, vec, item, cg,
                                            backward, threads))
    threads = CTA_THREADS
    cols = blocks[at]
    vec = _vec(cols, c, item)
    if cols // vec > threads:  # one group's row is wider than the CTA
        vec = _vec(cg, c, item)
        cols = vec * max(d for d in range(1, threads + 1)
                         if (cg // vec) % d == 0)
    rows = max(1, _rows_within(STREAM_TILE_BYTES, cols, vec, item, cg,
                               backward, threads))
    rows = min(rows, hw)
    return Plan("stream", cols, rows, -(-hw // rows), 1, vec, threads,
                smem_bytes(rows, cols, vec, item, cg, backward, threads))


def workspace_doubles(shape, groups: int, p: Plan, backward: bool) -> int:
    """float64 values of the streaming path's workspace: two partials a
    (sample, column block, tile, group in the block), backward also two a
    (sample, tile, channel); none on the cluster path."""
    if p.path == "cluster":
        return 0
    b, _, c = shape
    cg = c // groups
    ng = p.cols // cg if p.cols >= cg else 1
    n = 2 * b * (c // p.cols) * p.tiles * ng
    return n + (2 * b * p.tiles * c if backward else 0)


def fits(shape, groups: int, dtype) -> bool:
    """Whether the kernels take ``x`` of ``shape`` ([B, HW, C]) in
    ``dtype`` with ``groups`` groups: float32 or bfloat16, G dividing C.
    Every such shape has a plan in both directions (the cluster path or
    the streaming one); the tensors must also be contiguous and 16-byte
    aligned."""
    if len(shape) != 3 or dtype not in _DTYPE_CODES or groups < 1:
        return False
    b, hw, c = shape
    return b >= 1 and hw >= 1 and c >= 1 and c % groups == 0


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
    G]``. On a CUDA tensor torch runs ``/ n`` as a multiply by the
    float64 reciprocal (on the CPU it divides); the kernel multiplies the
    same way, so the two agree bitwise on the card."""
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


def _check(name, x, groups, others):
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported (float32, "
                         f"bfloat16)")
    if not fits(x.shape, groups, x.dtype):
        raise ValueError(
            f"{name}: kernel does not take x {tuple(x.shape)} {x.dtype} with "
            f"{groups} groups ([B, HW, C], G dividing C)")
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


def _launch_plan(x, groups, backward):
    """The plan for ``x`` and its workspace (None on the cluster path)."""
    p = plan(tuple(x.shape), groups, x.dtype, backward)
    n = workspace_doubles(tuple(x.shape), groups, p, backward)
    ws = torch.empty(n, dtype=torch.float64, device=x.device) if n else None
    return p, ws


def group_norm_fwd(x, gamma, beta, groups: int, eps: float = 1e-6):
    """``(y, stats)``: the Hopper kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return group_norm_fwd_reference(x, gamma, beta, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_fwd: no kernel for device {x.device}")
    gamma, beta = _params(gamma, x.shape[-1]), _params(beta, x.shape[-1])
    _check("group_norm_fwd", x, groups, (gamma, beta))
    b, hw, c = x.shape
    y = torch.empty_like(x)
    stats = torch.empty((b, 2, groups), dtype=torch.float32, device=x.device)
    p, ws = _launch_plan(x, groups, backward=False)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.groupnorm_fwd_launch(
            _DTYPE_CODES[x.dtype], p.vec, x.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), y.data_ptr(), stats.data_ptr(),
            ws.data_ptr() if ws is not None else None, b, hw, c, groups,
            p.cols, p.rows, p.tiles, p.cluster, int(p.path == "stream"),
            p.threads, eps, stream)
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
    _check("group_norm_bwd", x, groups, (gamma, stats, dy))
    b, hw, c = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype \
            or tuple(stats.shape) != (b, 2, groups) \
            or stats.dtype != torch.float32:
        raise ValueError("group_norm_bwd: dy must match x, stats must be "
                         "float32 [B, 2, G]")
    dx = torch.empty_like(x)
    dgamma_p = torch.empty((b, c), dtype=torch.float32, device=x.device)
    dbeta_p = torch.empty((b, c), dtype=torch.float32, device=x.device)
    p, ws = _launch_plan(x, groups, backward=True)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.groupnorm_bwd_launch(
            _DTYPE_CODES[x.dtype], p.vec, x.data_ptr(), gamma.data_ptr(),
            stats.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dgamma_p.data_ptr(), dbeta_p.data_ptr(),
            ws.data_ptr() if ws is not None else None, b, hw, c, groups,
            p.cols, p.rows, p.tiles, p.cluster, int(p.path == "stream"),
            p.threads, 1.0 / (hw * (c // groups)), stream)
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
