"""Optimizers by Keras-style name (port of ``distkeras_tpu/ops/optimizers.py``).

The JAX package resolves names to optax transformations; the port
resolves them to ``torch.optim`` optimizers with optax's DEFAULTS and
arithmetic, which are not torch's. :func:`get` returns a factory,
``params -> torch.optim.Optimizer`` (a torch optimizer binds to its
parameters, so the train state builds it from the module's):

- ``sgd``/``momentum``/``nesterov``: ``torch.optim.SGD`` with
  ``dampening=0``, whose ``buf = g + momentum * buf`` and nesterov
  direction ``g + momentum * buf`` are optax's ``trace``;
- ``adam``: ``torch.optim.Adam`` with b1 0.9, b2 0.999, eps 1e-8 outside
  the square root, as optax;
- ``adamw``: ``torch.optim.AdamW`` with optax's weight decay 1e-4 (torch
  defaults to 1e-2). torch scales ``p`` by ``1 - lr * wd`` before the
  Adam step, optax adds ``wd * p`` to the Adam direction before the
  ``-lr`` scale: both take ``p`` before the step, so the update is the
  same;
- ``adadelta``: ``torch.optim.Adadelta`` with optax's rho 0.9 and eps
  1e-6 (torch's defaults too) and the given learning rate (torch
  defaults to 1.0); its ``sqrt(E[dx²] + eps) / sqrt(E[g²] + eps) * g``
  is optax's ``scale_by_adadelta``;
- ``adagrad``, ``rmsprop``, ``nadam``, ``lamb``: the classes below,
  because torch's classes of those names compute something else.

torch computes Adam's bias corrections in float64 where optax takes them
in float32: at lr 1e-3 the updates differ by about 1e-8. The classes
below take them in float32, as optax.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, Union

import torch

#: ``params -> optimizer``: what :func:`get` returns and the train state
#: is built with
OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


def _f32_pow(base: float, count: int) -> torch.Tensor:
    """``base ** count`` in float32, as optax's bias correction traces it
    (a weak-typed Python float to an int32 counter's power)."""
    return torch.pow(torch.tensor(base, dtype=torch.float32),
                     torch.tensor(float(count), dtype=torch.float32))


def _bias_correction(moment: torch.Tensor, decay: float,
                     count: int) -> torch.Tensor:
    """optax's ``tree_bias_correction``: ``moment / (1 - decay**count)``
    with the correction in float32, cast to the moment's dtype."""
    correction = 1 - _f32_pow(decay, count)
    return moment / correction.to(moment.device, moment.dtype)


class _OptaxOptimizer(torch.optim.Optimizer):
    """Shared loop: for every parameter with a gradient, lazily build its
    state with :meth:`_init_state` and apply ``p += -lr * u`` where
    :meth:`_direction` gives ``u`` (optax's ``scale_by_learning_rate``
    then ``apply_updates``)."""

    def _init_state(self, p: torch.Tensor, group: dict) -> dict:
        raise NotImplementedError

    def _direction(self, p, g, state, group) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            self._step_group(group)
        return loss

    def _step_group(self, group: dict) -> None:
        for p in group["params"]:
            if p.grad is None:
                continue
            p.add_(-group["lr"] * self._direction(p, p.grad,
                                                  self._state(p, group),
                                                  group))

    def _state(self, p, group) -> dict:
        state = self.state[p]
        if not state:
            state.update(self._init_state(p, group))
        return state


class Adagrad(_OptaxOptimizer):
    """optax's ``adagrad``: ``chain(scale_by_rss(0.1, 1e-7),
    scale_by_learning_rate(lr))``. The accumulator starts at
    ``initial_accumulator_value`` (0.1; torch's ``Adagrad`` starts at 0)
    and the step is ``g * rsqrt(sum + eps)``, eps INSIDE the root and 0
    where the sum is 0 (torch adds eps outside the root)."""

    def __init__(self, params, lr: float = 0.01,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    def _init_state(self, p, group):
        return {"sum_of_squares": torch.full_like(
            p, group["initial_accumulator_value"])}

    def _direction(self, p, g, state, group):
        total = g * g + state["sum_of_squares"]
        state["sum_of_squares"] = total
        inv_sqrt = torch.where(total > 0, torch.rsqrt(total + group["eps"]),
                               torch.zeros((), dtype=total.dtype,
                                           device=total.device))
        return inv_sqrt * g


class RMSprop(_OptaxOptimizer):
    """optax's ``rmsprop`` (not centered, no momentum): ``nu = (1 -
    decay) * g² + decay * nu`` from ``initial_scale`` 0, then ``g *
    rsqrt(nu + eps)`` with eps INSIDE the root (``eps_in_sqrt=True``;
    torch's ``RMSprop`` adds eps outside it, and its decay default is
    0.99 where optax's is 0.9)."""

    def __init__(self, params, lr: float = 0.01, decay: float = 0.9,
                 eps: float = 1e-8, initial_scale: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      initial_scale=initial_scale))

    def _init_state(self, p, group):
        return {"nu": torch.full_like(p, group["initial_scale"])}

    def _direction(self, p, g, state, group):
        decay = group["decay"]
        nu = (1 - decay) * (g * g) + decay * state["nu"]
        state["nu"] = nu
        return torch.rsqrt(nu + group["eps"]) * g


def _adam_moments(g, state, b1, b2):
    """optax's ``update_moment`` for both Adam moments; returns the new
    count."""
    state["mu"] = (1 - b1) * g + b1 * state["mu"]
    state["nu"] = (1 - b2) * (g * g) + b2 * state["nu"]
    state["count"] += 1
    return state["count"]


class NAdam(_OptaxOptimizer):
    """optax's ``nadam`` (``adam(nesterov=True)``): Adam moments, then
    ``mu_hat = b1 * mu / (1 - b1**(t+1)) + (1 - b1) * g / (1 - b1**t)``
    and ``mu_hat / (sqrt(nu / (1 - b2**t)) + eps)``. torch's ``NAdam``
    uses Dozat's momentum-decay schedule instead, so it is not used."""

    def __init__(self, params, lr: float = 0.01, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      eps_root=eps_root))

    def _init_state(self, p, group):
        return {"count": 0, "mu": torch.zeros_like(p),
                "nu": torch.zeros_like(p)}

    def _direction(self, p, g, state, group):
        b1, b2 = group["b1"], group["b2"]
        t = _adam_moments(g, state, b1, b2)
        mu_hat = (b1 * _bias_correction(state["mu"], b1, t + 1)
                  + (1 - b1) * _bias_correction(g, b1, t))
        nu_hat = _bias_correction(state["nu"], b2, t)
        return mu_hat / (torch.sqrt(nu_hat + group["eps_root"])
                         + group["eps"])


class Lamb(_OptaxOptimizer):
    """optax's ``lamb``: ``chain(scale_by_adam(b1, b2, eps=1e-6),
    add_decayed_weights(weight_decay), scale_by_trust_ratio(),
    scale_by_learning_rate(lr))``. The Adam direction ``u`` plus ``wd *
    p`` is scaled per parameter tensor by ``||p|| / ||u||``, or by 1 where
    either norm is 0 (optax's zero-norm rule). torch has no LAMB.

    A param group with ``shard_dim`` holds the shards of one tensor, split
    along that dim in order (what
    :func:`~distkeras_tpu_torch.parallel.tensor.param_groups` builds):
    their ratio is the whole tensor's, taken on the concatenated ``p`` and
    ``u`` as GSPMD takes it over the logical array, so a sharded step
    gives the unsharded one's bits. Where other processes hold some of
    the shards, the group's ``shard_join`` (this process's shards -> the
    whole tensor, a collective) takes the place of the concatenation."""

    def __init__(self, params, lr: float = 0.01, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6, eps_root: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      eps_root=eps_root,
                                      weight_decay=weight_decay))

    def _init_state(self, p, group):
        return {"count": 0, "mu": torch.zeros_like(p),
                "nu": torch.zeros_like(p)}

    def _update(self, p, g, state, group):
        """The Adam direction plus weight decay, before the trust ratio."""
        b1, b2 = group["b1"], group["b2"]
        t = _adam_moments(g, state, b1, b2)
        mu_hat = _bias_correction(state["mu"], b1, t)
        nu_hat = _bias_correction(state["nu"], b2, t)
        u = mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) + group["eps"])
        return u + group["weight_decay"] * p

    @staticmethod
    def _trust_ratio(p, u):
        param_norm = torch.linalg.vector_norm(p)
        update_norm = torch.linalg.vector_norm(u)
        zero_norm = (param_norm == 0.0) | (update_norm == 0.0)
        return torch.where(zero_norm, torch.ones_like(param_norm),
                           param_norm / update_norm)

    def _direction(self, p, g, state, group):
        u = self._update(p, g, state, group)
        return u * self._trust_ratio(p, u)

    def _step_group(self, group):
        dim = group.get("shard_dim")
        if dim is None:
            return super()._step_group(group)
        shards = group["params"]
        us = [self._update(p, p.grad, self._state(p, group), group)
              for p in shards]
        home = shards[0].device  # the ratio before any shard moves
        join = group.get("shard_join") or (lambda ts: torch.cat(
            [t.to(home) for t in ts], dim=dim))
        ratio = self._trust_ratio(join(shards), join(us))
        for p, u in zip(shards, us):
            p.add_(-group["lr"] * (u * ratio.to(p.device)))


def get(optimizer: Union[str, OptimizerFactory],
        learning_rate: float = 0.01,
        momentum: float = 0.9) -> OptimizerFactory:
    """Resolve an optimizer name (the JAX registry's strings and
    defaults) to a factory; a factory passes through."""
    if not isinstance(optimizer, str):
        return optimizer
    name = optimizer.lower()
    if name == "sgd":
        return functools.partial(torch.optim.SGD, lr=learning_rate)
    if name in ("momentum", "sgd_momentum", "nesterov"):
        return functools.partial(torch.optim.SGD, lr=learning_rate,
                                 momentum=momentum, dampening=0.0,
                                 nesterov=name == "nesterov")
    if name == "adam":
        return functools.partial(torch.optim.Adam, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return functools.partial(torch.optim.AdamW, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)
    if name == "adadelta":
        return functools.partial(torch.optim.Adadelta, lr=learning_rate,
                                 rho=0.9, eps=1e-6, foreach=False)
    classes = {"adagrad": Adagrad, "rmsprop": RMSprop, "nadam": NAdam,
               "lamb": Lamb}
    if name in classes:
        return functools.partial(classes[name], lr=learning_rate)
    raise ValueError(f"Unknown optimizer {optimizer!r}")
