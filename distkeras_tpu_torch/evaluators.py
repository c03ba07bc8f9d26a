"""Evaluators (port of ``distkeras_tpu/evaluators.py``): metrics over
scored datasets. ``across_processes=True`` is the host-sharded contract:
each process scores its own rows and the evaluators sum every process's
``(value, total)`` over the ``torch.distributed`` group, so every process
returns the global metric (in one process, the local one)."""

from __future__ import annotations

import numpy as np
import torch


def _allgather_counts(value: float, total: float, integral: bool = False):
    """Sum ``(value, total)`` pairs over processes (every process calls,
    with the same ``integral`` flag: it picks the wire dtype, as in the
    JAX package).

    ``integral=True`` gathers int32 (exact counts); float payloads (loss
    sums) ride float32, whose ~1e-7 relative rounding is noise next to the
    loss's own precision. The sums are taken in float64 in rank order."""
    from distkeras_tpu_torch.parallel import distributed

    if distributed.process_count() == 1:
        return value, total
    if integral:
        if not (abs(value) < 2 ** 31 and abs(total) < 2 ** 31):
            raise ValueError(
                f"per-process counts ({value}, {total}) exceed int32; "
                f"shard the evaluation further")
        arr = np.array([int(value), int(total)], np.int32)
    else:
        arr = np.array([value, total], np.float32)
    gathered = distributed.process_allgather(arr)
    return (float(gathered[..., 0].astype(np.float64).sum()),
            float(gathered[..., 1].astype(np.float64).sum()))


class Evaluator:
    def evaluate(self, dataset) -> float:
        raise NotImplementedError


class AccuracyEvaluator(Evaluator):
    """Fraction of rows where the predicted index equals the label index.
    Index columns or score vectors on both sides (argmax over the last
    axis of >=2-d columns); raw binary scores are thresholded. As in the
    JAX package, the count is over every index position and the division
    by rows. ``across_processes=True``: each process holds a disjoint
    shard and the correct and total counts are summed over processes
    (every process must call ``evaluate``)."""

    def __init__(self, prediction_col: str = "prediction",
                 label_col: str = "label", across_processes: bool = False):
        self.prediction_col = prediction_col
        self.label_col = label_col
        self.across_processes = bool(across_processes)

    @staticmethod
    def _to_index(col: np.ndarray, threshold: float = 0.5) -> np.ndarray:
        col = np.asarray(col)
        if col.ndim >= 2 and col.shape[-1] > 1:
            return col.argmax(axis=-1)
        flat = col.reshape(len(col))
        if np.issubdtype(flat.dtype, np.floating) and \
                not np.all(flat == np.floor(flat)):
            # raw binary scores: threshold in probability space (values
            # outside [0,1] are logits; sigmoid(x) >= 0.5 <=> x >= 0)
            if flat.min() < 0.0 or flat.max() > 1.0:
                return (flat >= 0.0).astype(np.int64)
            return (flat >= threshold).astype(np.int64)
        return flat.astype(np.int64)

    def evaluate(self, dataset) -> float:
        """``dataset``: any mapping of column name to rows."""
        pred = self._to_index(dataset[self.prediction_col])
        true = self._to_index(dataset[self.label_col])
        correct, total = int(np.sum(pred == true)), len(pred)
        if self.across_processes:
            correct, total = _allgather_counts(correct, total,
                                               integral=True)
        if total == 0:
            return float("nan")
        return float(correct / total)


class CanaryAgreementEvaluator(AccuracyEvaluator):
    """Agreement of a canary version's predicted index with the
    incumbent's on shadow rows (:mod:`distkeras_tpu_torch.serving.rollout`):
    accuracy with the incumbent's outputs standing in for labels, so
    logits, probabilities and index columns all compare."""

    def __init__(self, candidate_col: str = "candidate",
                 incumbent_col: str = "incumbent",
                 across_processes: bool = False):
        super().__init__(prediction_col=candidate_col,
                         label_col=incumbent_col,
                         across_processes=across_processes)


class LossEvaluator(Evaluator):
    """Mean loss of a scored dataset, the loss resolved by name through
    :mod:`distkeras_tpu_torch.ops.losses` and computed on the CPU.

    ``across_processes=True``: each process's mean is weighted by the
    count the loss's own mean divides by (rows, or the label tokens of a
    masked-LM loss), summed over processes and divided by the summed
    count: the global mean."""

    def __init__(self, loss: str = "categorical_crossentropy",
                 prediction_col: str = "prediction",
                 label_col: str = "label", across_processes: bool = False):
        from distkeras_tpu_torch.ops import losses as losses_lib

        self.loss_fn = losses_lib.get(loss)
        self._is_masked_lm = self.loss_fn is losses_lib.masked_lm
        self.prediction_col = prediction_col
        self.label_col = label_col
        self.across_processes = bool(across_processes)

    def _weight(self, labels) -> int:
        """How many units the loss's own mean divides by."""
        if self._is_masked_lm:
            return int(np.sum(np.asarray(labels) >= 0))
        return len(labels)

    def evaluate(self, dataset) -> float:
        logits = torch.as_tensor(np.asarray(dataset[self.prediction_col]))
        labels = torch.as_tensor(np.asarray(dataset[self.label_col]))
        weight = self._weight(labels)
        local = float(self.loss_fn(logits, labels)) if weight else 0.0
        if self.across_processes:
            # every process enters the collective, an empty shard too
            total, weight = _allgather_counts(local * weight, weight)
            return total / weight if weight else float("nan")
        if not weight:
            return float("nan")
        return local
