"""Predictors (port of ``distkeras_tpu/predictors.py``): batched
inference that appends a prediction column to a dataset.

The forward runs on the predictor's device (``cuda:0`` unless the caller
names another, as at every entry point of the port) in eval mode without
autograd, in batches of ``batch_size`` rows (the tail padded to a full
batch and sliced off after, so every call has one shape), and the
outputs come back as numpy columns. With ``mesh=`` the scoring is
sharded over the mesh's worker devices, as the JAX predictor shards its
batch over the ``workers`` axis: each chunk of ``batch_size x workers``
rows splits into the workers' equal slices, each scored by a copy of
the model on its worker's device, and the outputs are gathered in row
order.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.device import resolve_device


def make_forward_fn(model: torch.nn.Module):
    """The inference forward pass ``x -> model(x)``, in eval mode and
    without autograd: the function the online
    :class:`~distkeras_tpu_torch.serving.engine.ServingEngine` captures
    per bucket and the predictors below batch. ``model`` holds its
    weights (the JAX function takes them as an argument)."""
    model.eval()

    @torch.no_grad()
    def forward(x):
        return model(x)

    return forward


def _placed(model: torch.nn.Module, params,
            device: torch.device) -> torch.nn.Module:
    """``model`` itself when ``params`` is None and it already lies on
    ``device``, else a copy on ``device`` carrying ``params`` (a name ->
    tensor dict, what a port trainer returns) or the model's own
    weights. The caller's module is never moved."""
    if params is None and all(p.device == device
                              for p in model.parameters()):
        return model
    clone = copy.deepcopy(model).to(device)
    if params is not None:
        with torch.no_grad():
            for n, p in clone.named_parameters():
                p.copy_(torch.as_tensor(params[n]))
    return clone


class Predictor:
    """Base predictor: ``predict(dataset) -> dataset + output_col``."""

    def predict(self, dataset: Dataset) -> Dataset:
        raise NotImplementedError


class ModelPredictor(Predictor):
    """Append the model's raw output vector for every row. ``params``
    (optional) are loaded into a copy of ``model``. Scoring runs on
    ``device`` (``None`` -> ``cuda:0``, raising without a card; the
    port's one added kwarg, as on the trainers) or, when ``mesh`` is
    given, on its worker devices, the batch sharded over them."""

    def __init__(self, model, params=None, features_col: str = "features",
                 output_col: str = "prediction", batch_size: int = 512,
                 mesh=None, device=None):
        self.mesh = mesh
        if mesh is not None:
            self.devices = [resolve_device(d) for d in mesh.devices]
        else:
            self.devices = [resolve_device(device)]
        self.device = self.devices[0]
        copies = {}  # one model a distinct device
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = _placed(model, params, dev)
        self.model = copies[self.device]
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)
        self._num_shards = len(self.devices)
        self._forwards = [make_forward_fn(copies[d]) for d in self.devices]

    def predict(self, dataset: Dataset) -> Dataset:
        # integer columns are token ids and stay as they are; float
        # columns are normalized to float32
        x = np.asarray(dataset[self.features_col])
        if np.issubdtype(x.dtype, np.floating):
            x = x.astype(np.float32)
        n = len(x)
        # pad to a full (batch * shards) multiple: one shape a call
        chunk = self.batch_size * self._num_shards
        pad = (-n) % chunk
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        outs = []
        for start in range(0, len(x), chunk):
            parts = [fwd(torch.from_numpy(
                         x[start + i * self.batch_size:
                           start + (i + 1) * self.batch_size]).to(dev))
                     for i, (fwd, dev) in enumerate(zip(self._forwards,
                                                        self.devices))]
            outs.extend(p.cpu() for p in parts)
        y = torch.cat(outs).numpy()[:n]
        return dataset.with_column(self.output_col, y)


class ModelClassifier(ModelPredictor):
    """Append the argmax class index instead of the raw output vector
    (ModelPredictor + LabelIndexTransformer on logits)."""

    def predict(self, dataset: Dataset) -> Dataset:
        from distkeras_tpu_torch.transformers import LabelIndexTransformer

        scored = super().predict(dataset)
        return LabelIndexTransformer(
            input_col=self.output_col, output_col=self.output_col,
            activation_threshold=0.5, from_logits=True).transform(scored)
