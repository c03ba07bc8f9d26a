"""Mixture of Experts (port of ``distkeras_tpu/models/moe.py``): Switch-style
top-1 routing with a capacity limit, dispatch and combine as one-hot
products, the experts stacked on a leading ``[E, ...]`` axis.

:class:`SwitchMoE` routes each token of ``[B, T, W]`` to one expert: a
float32 ``router`` Dense and softmax, the expert by ``argmax`` (the first
maximum, in both frameworks), a token's slot in its expert's queue by a
cumulative sum, tokens past ``capacity = max(1, int(capacity_factor *
tokens / E))`` dropped (their output is zero). The experts are one
:class:`StackedMlp` (``experts.fc{1,2}.weight [E, out, in]``, ``bias [E,
out]``; flax's ``nn.vmap`` stacks ``kernel [E, in, out]``) over batched
products. The Switch load-balance term ``aux_loss_weight * E *
sum(density * mean gate)`` is sown
(:func:`~distkeras_tpu_torch.models.aux_losses.sow`), and the step engine
adds it to the objective. ``router_noise`` (training only) draws from the
step engine's generator.

:class:`MoEEncoderBlock` is a pre-LN encoder block whose MLP is a
SwitchMoE; :class:`MoEClassifier` stacks them (``block{i}``), pools over
tokens and classifies in float32. flax infers the feature width from
the input; the port takes it at construction (``width``).

``EP_RULES`` / :func:`ep_partition_rules` shard the stacked expert axis
over the mesh's ``model`` axis under
:class:`~distkeras_tpu_torch.trainers.PjitTrainer` (expert parallelism:
each model position holds ``E / M`` experts at rest).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.models import aux_losses
from distkeras_tpu_torch.models.remat import remat_call, validate_remat
from distkeras_tpu_torch.models.transformer import LN_EPS, init_params
from distkeras_tpu_torch.ops.attention import MultiHeadAttention

__all__ = ["EP_RULES", "MoEClassifier", "MoEEncoderBlock", "StackedMlp",
           "SwitchMoE", "ep_partition_rules", "init_params"]


class StackedMlp(nn.Module):
    """``E`` MLP blocks (``fc1`` -> tanh GELU -> ``fc2``) over ``[E, C,
    width]``, expert ``e`` on row ``e``: float32 ``weight [E, out, in]``
    and ``bias [E, out]`` for each of ``fc1``/``fc2``, computed in the
    compute dtype as batched products. A quantizing ``precision`` runs
    each expert's product through the policy's hook on its own (flax's
    ``nn.vmap`` quantizes each expert's operands per slice)."""

    def __init__(self, num_experts: int, width: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 precision: Optional[str] = None):
        super().__init__()
        self.compute_dtype = precision_lib.resolve(precision, dtype)
        self._dot = precision_lib.make_dot_general(
            precision_lib.get_policy(precision))
        self.fc1 = nn.ParameterDict({
            "weight": nn.Parameter(torch.empty(num_experts, mlp_dim, width)),
            "bias": nn.Parameter(torch.zeros(num_experts, mlp_dim))})
        self.fc2 = nn.ParameterDict({
            "weight": nn.Parameter(torch.empty(num_experts, width, mlp_dim)),
            "bias": nn.Parameter(torch.zeros(num_experts, width))})
        for fc, fan_in in ((self.fc1, width), (self.fc2, mlp_dim)):
            nn.init.normal_(fc["weight"], 0.0, fan_in ** -0.5)

    def _dense(self, fc, x):
        w = fc["weight"].to(self.compute_dtype)
        b = fc["bias"].to(self.compute_dtype)[:, None, :]
        if self._dot is None:
            return torch.bmm(x, w.transpose(1, 2)) + b
        return torch.stack([self._dot(x[e], w[e])
                            for e in range(w.shape[0])]) + b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        return self._dense(self.fc2, F.gelu(self._dense(self.fc1, x),
                                            approximate="tanh"))


class SwitchMoE(nn.Module):
    """Top-1 routed MoE over the tokens of ``[B, T, W]``; see the module
    docstring."""

    def __init__(self, width: int, num_experts: int, mlp_dim: int,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 router_noise: float = 0.0, aux_loss_weight: float = 0.01,
                 precision: Optional[str] = None):
        super().__init__()
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.dtype = dtype
        self.router_noise, self.aux_loss_weight = router_noise, \
            aux_loss_weight
        self.router = nn.Linear(width, num_experts)  # float32
        self.experts = StackedMlp(num_experts, width, mlp_dim, dtype,
                                  precision)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t, w = x.shape
        tokens, e = b * t, self.num_experts
        capacity = max(1, int(self.capacity_factor * tokens / e))
        xt = x.reshape(tokens, w)
        logits = self.router(xt.float())
        if self.router_noise > 0.0 and self.training:
            logits = logits + self.router_noise * torch.randn(
                logits.shape, generator=generator, device=logits.device)
        gates = torch.softmax(logits, dim=-1)                    # [N, E]
        expert_idx = torch.argmax(gates, dim=-1)                 # [N]
        gate = torch.gather(gates, 1, expert_idx[:, None])[:, 0]
        onehot = F.one_hot(expert_idx, e).float()                # [N, E]
        # position of each token in its expert's queue
        pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
        keep = (pos >= 0) & (pos < capacity)
        slot = torch.where(keep, pos, 0.0).sum(dim=-1).long()
        pos_cap = F.one_hot(slot, capacity).float()              # [N, C]
        dispatch = (onehot * keep)[:, :, None] * pos_cap[:, None, :]
        combine = dispatch * gate[:, None, None]
        # Switch eq. 4, sown pre-scaled: the engine adds it as it is
        density = onehot.mean(dim=0)
        density_proxy = gates.mean(dim=0)
        aux_losses.sow(self.aux_loss_weight
                       * (density * density_proxy).sum() * e)
        expert_in = torch.einsum("nec,nw->ecw", dispatch.to(self.dtype),
                                 xt.to(self.dtype))              # [E, C, W]
        expert_out = self.experts(expert_in)
        y = torch.einsum("nec,ecw->nw", combine.to(self.dtype),
                         expert_out.to(self.dtype))
        return y.reshape(b, t, w)


class MoEEncoderBlock(nn.Module):
    """Pre-LN encoder block whose MLP is a :class:`SwitchMoE` (``ln1``,
    ``attn``, ``ln2``, ``moe``)."""

    def __init__(self, width: int, num_heads: int, num_experts: int,
                 mlp_dim: int, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 aux_loss_weight: float = 0.01,
                 precision: Optional[str] = None,
                 attention: Optional[str] = None):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = MultiHeadAttention(width, num_heads, dtype=dtype,
                                       precision=precision,
                                       attention=attention)
        self.ln2 = nn.LayerNorm(width, eps=LN_EPS)
        self.moe = SwitchMoE(width, num_experts, mlp_dim, capacity_factor,
                             dtype, aux_loss_weight=aux_loss_weight,
                             precision=precision)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x.float()).to(self.dtype))
        return x + self.moe(self.ln2(x.float()).to(self.dtype), generator)


class MoEClassifier(nn.Module):
    """MoE encoder stack and classification head: ``[B, T, width]``
    token features in, ``[B, num_classes]`` float32 logits out (mean over
    tokens, then ``head``). Each block runs through
    :func:`~distkeras_tpu_torch.models.remat.remat_call` under ``remat``;
    its sown aux term counts once."""

    def __init__(self, num_classes: int, num_layers: int = 1,
                 num_heads: int = 2, num_experts: int = 4, mlp_dim: int = 32,
                 capacity_factor: float = 2.0,
                 dtype: torch.dtype = torch.bfloat16,
                 aux_loss_weight: float = 0.01, remat: str = "none",
                 precision: Optional[str] = None,
                 attention: Optional[str] = None, width: int = 16):
        super().__init__()
        self.num_classes, self.num_layers = num_classes, num_layers
        self.num_heads, self.num_experts = num_heads, num_experts
        self.mlp_dim, self.capacity_factor = mlp_dim, capacity_factor
        self.dtype, self.aux_loss_weight = dtype, aux_loss_weight
        self.remat = validate_remat(remat)
        self.precision, self.attention, self.width = precision, attention, \
            width
        for i in range(num_layers):
            setattr(self, f"block{i}", MoEEncoderBlock(
                width, num_heads, num_experts, mlp_dim, capacity_factor,
                dtype, aux_loss_weight, precision, attention))
        self.head = nn.Linear(width, num_classes)  # float32

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.num_layers):
            x = remat_call(getattr(self, f"block{i}"), self.remat, x,
                           generator=generator)
        return self.head(x.float().mean(dim=1))


# partition rule addition for expert parallelism: the stacked expert
# axis of the experts' params shards over the model axis (flax paths and
# layout; parallel/tensor.py maps them onto the port's [E, out, in])
EP_RULES = (
    (r"experts/fc1/kernel$", ("model", None, None)),
    (r"experts/fc2/kernel$", ("model", None, None)),
    (r"experts/fc1/bias$", ("model", None)),
    (r"experts/fc2/bias$", ("model", None)),
)


def ep_partition_rules():
    """EP rules as PartitionSpecs, prepended to the tensor-parallel
    defaults (``parallel.tensor.DEFAULT_RULES``)."""
    # sharding-layer bridge, lazy so the MoE model definition itself stays
    # importable below parallel/ (only this helper reaches up)
    from distkeras_tpu_torch.parallel import tensor  # dktlint: disable=layer-forbidden-import

    converted = tuple((pat, tensor.P(*axes)) for pat, axes in EP_RULES)
    return converted + tuple(tensor.DEFAULT_RULES)
