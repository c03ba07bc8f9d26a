"""Deterministic RNG helpers (port of ``distkeras_tpu/utils/rng.py``).

Every stochastic choice is an explicit function of a seed. The host-side
helpers are the JAX package's numpy calls, so a shuffle is bitwise the
same in both packages. The JAX ``key``/``split`` pair becomes explicit
``torch.Generator``s on a given device: their streams are torch's, not
JAX's threefry bits, so dropout masks of the two packages differ (the
tests compare the packages with dropout off).
"""

from __future__ import annotations

import numpy as np
import torch

_GOLDEN = 0x9E3779B97F4A7C15


def np_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def permutation(seed: int, n: int) -> np.ndarray:
    """Host-side permutation for dataset shuffling (utils.shuffle parity)."""
    return np.random.default_rng(seed).permutation(n)


def fold_in(seed: int, *indices: int) -> int:
    """A 63-bit seed derived from ``seed`` and each index in turn (the
    JAX package's nested ``fold_in``, not its bits)."""
    for i in indices:
        seed = (seed * _GOLDEN + int(i) + 1) % (1 << 63)
    return seed


def generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (the CPU when None) seeded with
    ``seed``."""
    dev = torch.device("cpu" if device is None else device)
    return torch.Generator(device=dev).manual_seed(int(seed))


def step_generator(seed: int, worker: int, round_idx: int, step: int,
                   device=None) -> torch.Generator:
    """The dropout stream of logical worker ``worker`` at global round
    ``round_idx``, local step ``step``: the substrate's
    ``fold_in(fold_in(fold_in(key(seed), k), round), step)``."""
    return generator(fold_in(seed, worker, round_idx, step), device)
