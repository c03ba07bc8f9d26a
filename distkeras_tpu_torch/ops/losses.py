"""Loss functions by Keras-style name (port of
``distkeras_tpu/ops/losses.py``).

Every loss is ``loss(logits, labels) -> scalar`` over logits, with the
JAX package's reductions; log-softmax is taken in float32.
"""

from __future__ import annotations

from typing import Callable, Union

import torch
from torch.nn import functional as F

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _log_softmax(logits):
    return F.log_softmax(logits.float(), dim=-1)


def categorical_crossentropy(logits, labels):
    """Softmax crossentropy with one-hot (or soft) labels."""
    return -torch.mean(torch.sum(labels * _log_softmax(logits), dim=-1))


def sparse_categorical_crossentropy(logits, labels):
    """Softmax crossentropy with integer class labels."""
    ll = torch.gather(_log_softmax(logits), -1, labels.long()[..., None])
    return -torch.mean(ll)


def binary_crossentropy(logits, labels):
    """Sigmoid crossentropy; labels in {0, 1}, broadcastable to logits."""
    labels = labels.to(logits.dtype)
    return torch.mean(torch.clamp(logits, min=0.0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def masked_lm(logits, labels):
    """Sparse crossentropy over positions with ``label >= 0``; negative
    labels are ignored. Mean over valid positions (count clamped at 1)."""
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    ll = torch.gather(_log_softmax(logits), -1, safe[..., None])[..., 0]
    count = torch.clamp(valid.sum(), min=1)
    return -torch.sum(torch.where(valid, ll, 0.0)) / count


def masked_lm_terms(logits, labels):
    """``(summed NLL, hits, valid count)`` of one block under
    :func:`masked_lm`'s rule (labels < 0 ignored): the terms a
    sequence-parallel or pipelined step sums over its shards or
    microbatches before dividing by the global count."""
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    ll = torch.gather(_log_softmax(logits), -1, safe[..., None])[..., 0]
    nll = -torch.sum(torch.where(valid, ll, 0.0))
    hits = (valid & (torch.argmax(logits, dim=-1) == safe)).sum()
    return nll, hits, valid.sum()


def mean_squared_error(preds, targets):
    return torch.mean(torch.square(preds - targets))


def mean_absolute_error(preds, targets):
    return torch.mean(torch.abs(preds - targets))


_LOSSES: dict = {
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "masked_lm": masked_lm,
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
}


def get(loss: Union[str, LossFn]) -> LossFn:
    """Resolve a loss by Keras-style name, or pass a callable through."""
    if callable(loss):
        return loss
    try:
        return _LOSSES[loss]
    except KeyError:
        raise ValueError(
            f"Unknown loss {loss!r}; available: {sorted(_LOSSES)}") from None
