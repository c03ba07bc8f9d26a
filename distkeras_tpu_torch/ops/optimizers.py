"""Optimizers by Keras-style name (port of ``distkeras_tpu/ops/optimizers.py``).

The JAX package resolves names to optax transformations; the port
resolves them to ``torch.optim`` classes set to optax's DEFAULTS, which
are not torch's. :func:`get` returns a factory, ``params ->
torch.optim.Optimizer`` (a torch optimizer binds to its parameters, so
the train state builds it from the module's):

- ``sgd``/``momentum``/``nesterov``: ``torch.optim.SGD`` with
  ``dampening=0``, whose ``buf = g + momentum * buf`` and nesterov
  direction ``g + momentum * buf`` are optax's ``trace``;
- ``adam``: ``torch.optim.Adam`` with b1 0.9, b2 0.999, eps 1e-8 outside
  the square root, as optax;
- ``adamw``: ``torch.optim.AdamW`` with optax's weight decay 1e-4 (torch
  defaults to 1e-2). torch scales ``p`` by ``1 - lr * wd`` before the
  Adam step, optax adds ``wd * p`` to the Adam direction before the
  ``-lr`` scale: both take ``p`` before the step, so the update is the
  same.

torch computes the bias corrections in float64 where optax takes them in
float32: at lr 1e-3 the updates differ by about 1e-8.

The other names of the JAX registry (adagrad, rmsprop, adadelta, nadam,
lamb) raise NotImplementedError.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, Union

import torch

#: ``params -> optimizer``: what :func:`get` returns and the train state
#: is built with
OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]

_NOT_PORTED = ("adagrad", "rmsprop", "adadelta", "nadam", "lamb")


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
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet (ROADMAP.md Queue "
            f"A, item 9, the step engine's optimizer registry)")
    raise ValueError(f"Unknown optimizer {optimizer!r}")
