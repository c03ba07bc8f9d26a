"""Reference-vocabulary compatibility layer (port of
``distkeras_tpu/utils/compat.py``): distkeras/utils.py's helpers under
their original names, over the port's own types
(:class:`~distkeras_tpu_torch.data.dataset.Dataset`,
:mod:`~distkeras_tpu_torch.utils.serialization`). Helpers whose job
disappeared with the platform (Spark, Keras) degrade to the honest
equivalent and say so, so ported scripts keep running.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np

if TYPE_CHECKING:  # a runtime import would be circular via data/
    from distkeras_tpu_torch.data.dataset import Dataset

from distkeras_tpu_torch.utils.serialization import (
    deserialize_model,
    deserialize_params,
    serialize_model,
    serialize_params,
    uniform_weights,
)

# reference names for model serialization (architecture + weights blob)
serialize_keras_model = serialize_model
deserialize_keras_model = deserialize_model

__all__ = ["deserialize_keras_model", "deserialize_model",
           "deserialize_params", "get_os_username",
           "history_executors_average", "new_dataframe_row", "precache",
           "serialize_keras_model", "serialize_model", "serialize_params",
           "set_keras_base_directory", "shuffle", "to_dense_vector",
           "uniform_weights"]


def shuffle(dataset: "Dataset", seed: int = 0) -> "Dataset":
    """utils.shuffle(df) parity (deterministic by seed here)."""
    return dataset.shuffle(seed)


def precache(dataset: "Dataset") -> "Dataset":
    """utils.precache(df) parity. Spark needed cache()+count() to force
    materialization; the columnar Dataset is already host-resident NumPy,
    so this touches every column (forcing any lazy views) and returns the
    dataset."""
    for col in dataset.columns:
        np.asarray(dataset[col])
    return dataset


def new_dataframe_row(row: dict, column: str, value) -> dict:
    """utils.new_dataframe_row parity for row dicts: copy + set column."""
    out = dict(row)
    out[column] = value
    return out


def to_dense_vector(value, n_dim: int) -> np.ndarray:
    """utils.to_dense_vector parity: class index -> one-hot float vector."""
    vec = np.zeros(int(n_dim), np.float32)
    vec[int(value)] = 1.0
    return vec


def history_executors_average(histories: Sequence[dict]) -> dict:
    """utils.history_executors_average parity: mean of each metric across
    per-worker/step history dicts (trainers also expose this as
    ``get_averaged_history``)."""
    if not histories:
        return {}
    keys = histories[0].keys()
    return {k: float(np.mean([h[k] for h in histories])) for k in keys}


def set_keras_base_directory(path: Optional[str] = None) -> None:
    """utils.set_keras_base_directory parity: a no-op, there is no Keras
    home directory here. Kept so ported scripts don't crash."""
    return None


def get_os_username() -> str:
    """Reference helper used by job deployment."""
    import getpass

    return getpass.getuser()
