"""Evaluators (port of ``distkeras_tpu/evaluators.py``): metrics over
scored datasets. ``across_processes=True`` (the JAX package's
cross-process aggregation) needs several processes and raises
NotImplementedError (ROADMAP.md Queue A, item 16)."""

from __future__ import annotations

import numpy as np
import torch


def _one_process(across_processes: bool) -> None:
    if across_processes:
        raise NotImplementedError(
            "across_processes=True aggregates over several processes, "
            "which the port does not run yet (ROADMAP.md Queue A, item 16)")


class Evaluator:
    def evaluate(self, dataset) -> float:
        raise NotImplementedError


class AccuracyEvaluator(Evaluator):
    """Fraction of rows where the predicted index equals the label index.
    Index columns or score vectors on both sides (argmax over the last
    axis of >=2-d columns); raw binary scores are thresholded. As in the
    JAX package, the count is over every index position and the division
    by rows."""

    def __init__(self, prediction_col: str = "prediction",
                 label_col: str = "label", across_processes: bool = False):
        _one_process(across_processes)
        self.prediction_col = prediction_col
        self.label_col = label_col
        self.across_processes = False

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
    :mod:`distkeras_tpu_torch.ops.losses` and computed on the CPU."""

    def __init__(self, loss: str = "categorical_crossentropy",
                 prediction_col: str = "prediction",
                 label_col: str = "label", across_processes: bool = False):
        from distkeras_tpu_torch.ops import losses as losses_lib

        _one_process(across_processes)
        self.loss_fn = losses_lib.get(loss)
        self._is_masked_lm = self.loss_fn is losses_lib.masked_lm
        self.prediction_col = prediction_col
        self.label_col = label_col
        self.across_processes = False

    def _weight(self, labels) -> int:
        """How many units the loss's own mean divides by."""
        if self._is_masked_lm:
            return int(np.sum(np.asarray(labels) >= 0))
        return len(labels)

    def evaluate(self, dataset) -> float:
        logits = torch.as_tensor(np.asarray(dataset[self.prediction_col]))
        labels = torch.as_tensor(np.asarray(dataset[self.label_col]))
        if not self._weight(labels):
            return float("nan")
        return float(self.loss_fn(logits, labels))
