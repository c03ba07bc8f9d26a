"""The canary scorer (port of ``CanaryAgreementEvaluator`` of
``distkeras_tpu/evaluators.py``, with the index decode it inherits from
``AccuracyEvaluator``; the dataset evaluators and their cross-process
aggregation are ROADMAP.md Queue A, item 12)."""

from __future__ import annotations

import numpy as np


class CanaryAgreementEvaluator:
    """Agreement of a canary version's predicted index with the
    incumbent's on shadow rows (:mod:`distkeras_tpu_torch.serving.rollout`):
    accuracy with the incumbent's outputs standing in for labels. Index
    columns or score vectors on both sides (argmax over the last axis of
    >=2-d columns); raw binary scores are thresholded. As in the JAX
    package, the count is over every index position and the division by
    rows, so outputs with a position axis (a causal LM's ``[rows, t,
    vocab]`` logits) score up to ``t``."""

    def __init__(self, candidate_col: str = "candidate",
                 incumbent_col: str = "incumbent"):
        self.prediction_col = candidate_col
        self.label_col = incumbent_col

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
