"""Update rules of the trainer zoo (port of
``distkeras_tpu/parallel/strategies.py``; NUMERICS.md pins the rules).

A :class:`Strategy` is the algebra of one round of one worker (lambda =
communication_window)::

    round_start -> lambda x local_step -> commit
    -> [server: c += sum_k s_k * commit_k] -> post_commit

The JAX strategies are pure pytree functions over an immutable carry.
Here a :class:`Carry` holds one replica's state as tensors on its
device, and the methods update it in place and return it:

- ``params`` is a name -> tensor dict of leaf tensors that require
  grad, and ``opt_state`` a ``torch.optim`` optimizer bound to them, so
  the worker's optimizer state lives in it;
- :meth:`Strategy.round_start` and :meth:`Strategy.post_commit` copy the
  center into those tensors (``copy_`` under ``no_grad``): the optimizer
  stays bound, and DOWNPOUR's optimizer state persists across rounds as
  optax's ``opt_state`` does in the JAX carry;
- :meth:`Strategy.local_step` takes gradients through a functional grad
  function (``engine.make_grad_fn(..., functional=True)``) of the one
  model over the carry's tensors; no worker holds a copy of the module.

The arithmetic (which differences, which scale, in which order) is the
JAX package's, leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from distkeras_tpu_torch.utils.trees import (tree_scale, tree_sub,
                                             tree_zeros_like)


@dataclasses.dataclass
class Carry:
    """One worker replica's state: its parameters (leaf tensors that
    require grad), its optimizer bound to them (None for EAMSGD, whose
    momentum is its own), and strategy-private tensors (EAMSGD's
    velocity)."""

    params: dict
    opt_state: Optional[torch.optim.Optimizer]
    extra: Any = ()


def _leaves(tree: dict, device=None) -> dict:
    """Fresh leaf tensors that require grad, copied from ``tree``."""
    return {n: x.detach().to(device if device is not None else x.device,
                             copy=True).requires_grad_(True)
            for n, x in tree.items()}


@torch.no_grad()
def _assign(dst: dict, src: dict) -> None:
    """Copy ``src`` into ``dst``'s tensors in place (across devices)."""
    for n, t in dst.items():
        t.copy_(src[n])


class Strategy:
    """Base: DOWNPOUR-family behaviour (pull, local optimizer steps,
    delta commit)."""

    name = "base"
    #: True when the replica is reset to the fresh center after a commit
    #: (DOWNPOUR family); the EASGD family keeps its replica.
    resets_to_center = True
    #: False for strategies that never exchange (Independent): the
    #: substrate then skips the fold and the center update entirely.
    exchanges = True

    def init_carry(self, params: dict, tx: Callable, device=None) -> Carry:
        """A replica starting from ``params`` (copied onto ``device``),
        with the optimizer ``tx`` (a factory ``params -> Optimizer``)
        built over its tensors."""
        leaves = _leaves(params, device)
        return Carry(params=leaves, opt_state=tx(list(leaves.values())))

    def round_start(self, carry: Carry, center: dict) -> Carry:
        """Pull: the DOWNPOUR family starts each round from the center."""
        _assign(carry.params, center)
        return carry

    def local_step(self, grad_fn: Callable, carry: Carry, batch: dict,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[Carry, dict]:
        """One minibatch step with the worker optimizer."""
        (loss, logits), grads = grad_fn(carry.params, batch, generator)
        for n, p in carry.params.items():
            p.grad = grads[n]
        carry.opt_state.step()
        carry.opt_state.zero_grad(set_to_none=True)
        return carry, {"loss": loss, "logits": logits}

    @torch.no_grad()
    def commit(self, carry: Carry, center: dict, window: int) -> dict:
        """What is sent to the server: the accumulated delta."""
        return tree_sub(carry.params, center)

    def staleness_weight(self, position: int) -> torch.Tensor:
        """Server-side scale of a commit folded at schedule position
        ``position`` (0 = first/freshest), a 0-d float32 tensor."""
        return torch.tensor(1.0, dtype=torch.float32)

    def post_commit(self, carry: Carry, commit: dict,
                    new_center: dict) -> Carry:
        """After the exchange: the DOWNPOUR family pulls the fresh
        center."""
        if self.resets_to_center:
            _assign(carry.params, new_center)
        return carry


class Downpour(Strategy):
    """DOWNPOUR (Dean et al. 2012): windowed delta push, fresh-center
    pull."""

    name = "downpour"


class ADAG(Strategy):
    """ADAG: DOWNPOUR with accumulated-gradient normalization; the commit
    is divided by the window, so the server step is window-invariant."""

    name = "adag"

    @torch.no_grad()
    def commit(self, carry: Carry, center: dict, window: int) -> dict:
        return tree_scale(tree_sub(carry.params, center), 1.0 / window)


class DynSGD(Strategy):
    """DynSGD: DOWNPOUR deltas, each scaled by 1/(staleness + 1) on the
    server. The host-side fold
    (:func:`distkeras_tpu_torch.parameter_servers.dynsgd_fold_weight`)
    is the same curve in Python floats; rounded to float32 it equals this
    one."""

    name = "dynsgd"

    def staleness_weight(self, position: int) -> torch.Tensor:
        return 1.0 / (torch.tensor(position, dtype=torch.float32) + 1.0)


class AEASGD(Strategy):
    """Asynchronous EASGD (Zhang et al. 2015): persistent local replicas
    with the symmetric elastic attraction E = rho * eta * (w - c)."""

    name = "aeasgd"
    resets_to_center = False

    def __init__(self, rho: float, learning_rate: float):
        self.rho = float(rho)
        self.learning_rate = float(learning_rate)

    def round_start(self, carry: Carry, center: dict) -> Carry:
        return carry  # the replica persists; the center is read at commit

    @torch.no_grad()
    def commit(self, carry: Carry, center: dict, window: int) -> dict:
        alpha = self.rho * self.learning_rate
        return tree_scale(tree_sub(carry.params, center), alpha)

    @torch.no_grad()
    def post_commit(self, carry: Carry, commit: dict,
                    new_center: dict) -> Carry:
        # the worker side of the elastic update: w <- w - E
        for n, p in carry.params.items():
            p.sub_(commit[n])
        return carry


class EAMSGD(AEASGD):
    """EAMSGD: AEASGD with explicit Nesterov momentum on the replica
    (v <- mu v - eta grad f(w + mu v); w <- w + v). The worker optimizer
    is not used: momentum lives in the worker loop, as in the
    reference."""

    name = "eamsgd"

    def __init__(self, rho: float, learning_rate: float, momentum: float):
        super().__init__(rho, learning_rate)
        self.momentum = float(momentum)

    def init_carry(self, params: dict, tx: Callable, device=None) -> Carry:
        leaves = _leaves(params, device)
        return Carry(params=leaves, opt_state=None,
                     extra=tree_zeros_like(leaves))

    def local_step(self, grad_fn: Callable, carry: Carry, batch: dict,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[Carry, dict]:
        mu, eta = self.momentum, self.learning_rate
        v = carry.extra
        with torch.no_grad():
            lookahead = {n: (w + mu * v[n]).requires_grad_(True)
                         for n, w in carry.params.items()}
        (loss, logits), grads = grad_fn(lookahead, batch, generator)
        with torch.no_grad():
            for n, w in carry.params.items():
                v[n] = mu * v[n] - eta * grads[n]
                w.add_(v[n])
        return carry, {"loss": loss, "logits": logits}


class Independent(Strategy):
    """No exchange at all: replicas train in isolation (the Averaging and
    Ensemble trainers). Commits are zero, so the center never moves; the
    trainer reads the replicas at the end."""

    name = "independent"
    resets_to_center = False
    exchanges = False

    def round_start(self, carry: Carry, center: dict) -> Carry:
        return carry

    @torch.no_grad()
    def commit(self, carry: Carry, center: dict, window: int) -> dict:
        return tree_zeros_like(carry.params)


def get(name: str, *, learning_rate: float = 0.01, **kwargs) -> Strategy:
    """Resolve a strategy by trainer name. Rejects hyperparameters the
    selected strategy does not take: a misdirected rho/momentum fails
    loudly instead of being dropped."""
    name = name.lower()

    def _done():
        if kwargs:
            raise TypeError(
                f"Strategy {name!r} does not take {sorted(kwargs)}")

    if name == "downpour":
        _done()
        return Downpour()
    if name == "adag":
        _done()
        return ADAG()
    if name == "dynsgd":
        _done()
        return DynSGD()
    if name == "aeasgd":
        rho = kwargs.pop("rho", 5.0)
        _done()
        return AEASGD(rho, learning_rate)
    if name == "eamsgd":
        rho = kwargs.pop("rho", 5.0)
        momentum = kwargs.pop("momentum", 0.9)
        _done()
        return EAMSGD(rho, learning_rate, momentum)
    if name == "independent":
        _done()
        return Independent()
    raise ValueError(f"Unknown strategy {name!r}")
