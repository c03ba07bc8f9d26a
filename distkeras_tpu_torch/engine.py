"""Step engine (port of ``distkeras_tpu/engine.py``): train state, loss and
gradient functions, metric terms, the train step, the epoch loop.

PyTorch idiom where the JAX package is functional:

- the parameters live in the ``nn.Module`` (float32 master weights);
  :class:`TrainState` holds the module, its ``torch.optim`` optimizer
  (built by the factory :func:`~distkeras_tpu_torch.ops.optimizers.get`
  returns) and ``step``. A step updates the module's parameters IN PLACE
  (the JAX step donates its state and returns a new one) and returns a
  new :class:`TrainState` around the same module and optimizer;
- gradient functions take a batch (and a ``torch.Generator``) and read
  the parameters from the module; gradients come back as a dict of
  name -> tensor in the parameters' dtype (float32), as JAX returns them
  in the params' dtype. Their ``functional=True`` form takes the
  parameters as a name -> tensor dict first, the JAX signature, and runs
  the one module on them through ``torch.func.functional_call`` (the
  substrate's K replicas share one module that way);
- there is no ``jit``: steps run eagerly (CUDA graphs are later work);
- the per-step dropout key becomes a ``torch.Generator`` seeded from
  ``dropout_seed`` and the step (and, under accumulation, the
  microbatch), passed to models whose ``forward`` takes a ``generator``
  (the MLP and the CIFAR CNN);
- ``precision=``: a policy with a loss scale other than 1 (``"int8"``,
  ``"fp8-sim"``) scales the loss before ``autograd.grad`` and unscales
  the gradients in float32 after; the step reads the live scale from an
  :func:`~distkeras_tpu_torch.precision.overflow_guard`-wrapped optimizer
  (:func:`~distkeras_tpu_torch.precision.current_scale`), else the
  policy's static scale applies. The reported loss is the unscaled one;
- auxiliary losses: the JAX package's ``mutable=["losses"]``. The loss
  function collects the terms modules sow in the forward
  (:mod:`distkeras_tpu_torch.models.aux_losses`, Switch-MoE's
  load-balance term) and adds each to the objective, which is the loss
  reported and differentiated, as in the JAX package.

A batch is a dict ``{"features": ..., "labels": ...}`` of tensors or numpy
arrays; the step moves it to the module's device.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable, Optional

import torch
from torch import nn

from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.models import aux_losses
from distkeras_tpu_torch.ops import losses as losses_lib
from distkeras_tpu_torch.ops.optimizers import OptimizerFactory
from distkeras_tpu_torch.utils import rng
from distkeras_tpu_torch.utils.trees import global_norm

Batch = dict


@dataclasses.dataclass
class TrainState:
    """One replica's training state: the module holding the parameters,
    the optimizer bound to them and the count of optimizer steps taken."""

    step: int
    model: nn.Module
    opt_state: torch.optim.Optimizer

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())


def create_train_state(model: nn.Module, tx: OptimizerFactory,
                       device=None) -> TrainState:
    """Move ``model`` (its weights already set, e.g. by ``init_params``)
    to ``device`` (default ``cuda:0``; the CPU only when asked) and build
    the optimizer over its parameters."""
    model.to(resolve_device(device))
    return TrainState(step=0, model=model, opt_state=tx(model.parameters()))


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def to_device(batch: Batch, device) -> Batch:
    """A batch of tensors or numpy arrays as tensors on ``device`` (what
    a grad function takes; the train steps call it themselves)."""
    return {key: torch.as_tensor(value).to(device)
            for key, value in batch.items()}


def _loss_scaling(precision):
    """``(policy, (pre, post))`` when the policy scales the loss, else
    ``(policy, None)``: f32 and bf16 have scale 1 and run no scaling code,
    so they equal ``precision=None`` exactly."""
    policy = precision_lib.get_policy(precision)
    if policy is None or policy.loss_scale == 1.0:
        return policy, None
    return policy, precision_lib.scale_grads_fn(policy)


def _takes_generator(model: nn.Module) -> bool:
    """Whether ``model.forward`` takes a ``generator`` (the dropout
    models do; the step engine then passes each step's)."""
    return "generator" in inspect.signature(model.forward).parameters


def make_loss_fn(model: nn.Module, loss) -> Callable:
    """``(batch, generator=None, params=None) -> (scalar loss, logits)``,
    resolving Keras-style loss names. With ``params`` (a name -> tensor
    dict) the forward runs on those tensors through
    ``torch.func.functional_call`` instead of the module's own; a model
    whose ``forward`` takes a ``generator`` gets this one. The forward
    runs inside a collector of sown auxiliary losses, each of which is
    summed and added to the loss: the scalar is the objective."""
    loss_fn = losses_lib.get(loss)
    with_generator = _takes_generator(model)

    def compute(batch: Batch, generator: Optional[torch.Generator] = None,
                params: Optional[dict] = None):
        kwargs = {"generator": generator} if with_generator else {}
        with aux_losses.collect() as terms:
            if params is None:
                logits = model(batch["features"], **kwargs)
            else:
                logits = torch.func.functional_call(
                    model, params, (batch["features"],), kwargs)
        total = loss_fn(logits, batch["labels"])
        for term in terms:
            total = total + term.sum()
        return total, logits

    return compute


def compute_metric_terms(name: str, logits: torch.Tensor,
                         labels: torch.Tensor) -> tuple:
    """(numerator, denominator) float32 pair of one metric over one
    (micro)batch; summing the pairs of k microbatches and finalizing gives
    the metric of the whole batch (what accumulation needs)."""
    if name in ("accuracy", "acc", "categorical_accuracy", "masked_accuracy"):
        pred = torch.argmax(logits, dim=-1)
        if labels.dim() == logits.dim() - 1:  # integer labels
            valid = labels >= 0
            hit = valid & (pred == labels)
            return hit.float().sum(), valid.float().sum()
        true = torch.argmax(labels, dim=-1)
        return ((pred == true).float().sum(),
                torch.tensor(float(pred.numel()), device=logits.device))
    if name == "loss":
        raise ValueError("'loss' is always recorded; don't list it in metrics")
    raise ValueError(f"Unknown metric {name!r}; supported: 'accuracy', "
                     "'masked_accuracy'")


def finalize_metric(terms: tuple) -> torch.Tensor:
    """num / den of accumulated metric terms (den clamped at 1: an
    all-masked batch reports 0, not NaN)."""
    num, den = terms
    return num / torch.clamp(den, min=1.0)


def compute_metric(name: str, logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Keras-style training metric over one batch; integer-label accuracy
    ignores positions with label < 0 (the masked_lm convention)."""
    return finalize_metric(compute_metric_terms(name, logits, labels))


def _grads(params: dict, loss_val: torch.Tensor) -> dict:
    names, tensors = zip(*params.items())
    grads = torch.autograd.grad(loss_val, tensors, allow_unused=True,
                                materialize_grads=True)
    return dict(zip(names, grads))


def make_grad_fn(model: nn.Module, loss, precision=None,
                 functional: bool = False) -> Callable:
    """``(batch, generator=None, loss_scale=None) -> ((loss, logits),
    grads)``: the building block a strategy applies its optimizer after,
    over the module's parameters. ``functional=True`` gives the form over
    an explicit name -> tensor dict, ``(params, batch, generator=None,
    loss_scale=None)``, the JAX package's signature: the forward runs on
    those tensors (``torch.func.functional_call`` of the one module) and
    the gradients are theirs. Under a loss-scaling ``precision`` the
    gradients are those of the loss times ``loss_scale`` (the policy's
    scale when None), unscaled in float32; ``loss`` is the unscaled
    loss."""
    compute_loss = make_loss_fn(model, loss)
    policy, scaling = _loss_scaling(precision)

    def grad_on(params: Optional[dict], batch: Batch,
                generator: Optional[torch.Generator] = None,
                loss_scale=None):
        wrt = dict(model.named_parameters()) if params is None else params
        loss_val, logits = compute_loss(batch, generator, params)
        if scaling is None:
            grads = _grads(wrt, loss_val)
        else:
            scale = policy.loss_scale if loss_scale is None else loss_scale
            grads = scaling[1](_grads(wrt, scaling[0](loss_val, scale)),
                               scale)
        return (loss_val.detach(), logits.detach()), grads

    if functional:
        return grad_on
    return functools.partial(grad_on, None)


def _split_microbatches(batch: Batch, k: int) -> Batch:
    """[k*m, ...] leaves -> [k, m, ...]; a ragged split raises."""

    def split(x):
        b = x.shape[0]
        if b % k != 0:
            raise ValueError(
                f"accum_steps={k} must divide the per-step batch "
                f"(got a leaf with leading dim {b})")
        return x.reshape((k, b // k) + tuple(x.shape[1:]))

    return {key: split(x) for key, x in batch.items()}


def make_accum_grad_fn(model: nn.Module, loss, accum_steps: int,
                       metric_names: tuple = (),
                       precision=None, functional: bool = False) -> Callable:
    """Gradient accumulation with :func:`make_grad_fn`'s contract:
    ``(batch, generator=None) -> ((loss, terms), grads)``. The
    ``[k*m, ...]`` batch runs as k microbatches of m rows in order; their
    gradients are summed in float32 from zero and divided by k (the
    full-batch mean-loss gradient), and ``terms`` holds each metric's
    summed ``(num, den)`` pair instead of full-batch logits. Each
    microbatch gets its own generator, derived from ``generator``'s seed
    and the microbatch index. Under a loss-scaling ``precision`` each
    microbatch's loss is scaled, and the float32 sum of the scaled
    gradients is unscaled once (exact for power-of-two scales)."""
    compute_loss = make_loss_fn(model, loss)
    policy, scaling = _loss_scaling(precision)
    k = int(accum_steps)
    if k < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    metric_names = tuple(metric_names)

    def grad_on(params: Optional[dict], batch: Batch,
                generator: Optional[torch.Generator] = None,
                loss_scale=None):
        scale = None if scaling is None else (
            policy.loss_scale if loss_scale is None else loss_scale)
        micro = _split_microbatches(batch, k)
        wrt = dict(model.named_parameters()) if params is None else params
        device = next(iter(wrt.values())).device
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        terms = {name: (torch.zeros((), device=device),
                        torch.zeros((), device=device))
                 for name in metric_names}
        grad_sum = {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in wrt.items()}
        for i in range(k):
            batch_i = {key: x[i] for key, x in micro.items()}
            gen_i = None if generator is None else rng.generator(
                rng.fold_in(generator.initial_seed(), i), generator.device)
            loss_i, logits = compute_loss(batch_i, gen_i, params)
            grads = _grads(wrt, loss_i if scale is None
                           else scaling[0](loss_i, scale))
            with torch.no_grad():
                for name in metric_names:
                    num, den = compute_metric_terms(name, logits,
                                                    batch_i["labels"])
                    terms[name] = (terms[name][0] + num, terms[name][1] + den)
                grad_sum = {n: a + grads[n].float()
                            for n, a in grad_sum.items()}
                loss_sum = loss_sum + loss_i.detach().float()
        if scale is not None:
            grad_sum = scaling[1](grad_sum, scale)
        grads = {n: (g / k).to(wrt[n].dtype) for n, g in grad_sum.items()}
        return (loss_sum / k, terms), grads

    if functional:
        return grad_on
    return functools.partial(grad_on, None)


def _make_step_body(model: nn.Module, loss, with_grad_norm: bool,
                    metrics: tuple, dropout_seed: int, accum_steps: int = 1,
                    precision=None) -> Callable:
    """The ONE step body :func:`make_train_step` and :func:`make_epoch_fn`
    share, so the two are equal by construction. ``accum_steps > 1``
    swaps the full-batch gradient for :func:`make_accum_grad_fn`; the
    state's optimizer applies once either way, so ``step`` counts
    optimizer steps. The live loss scale of a guard-wrapped optimizer
    (``precision.current_scale``) is fed to the grad function."""
    metric_names = tuple(metrics)
    accum_steps = int(accum_steps)
    if accum_steps > 1:
        grad_fn = make_accum_grad_fn(model, loss, accum_steps, metric_names,
                                     precision=precision)
    else:
        grad_fn = make_grad_fn(model, loss, precision=precision)

    def one_step(state: TrainState, batch: Batch):
        device = _device_of(state.model)
        batch = to_device(batch, device)
        generator = rng.generator(rng.fold_in(dropout_seed, state.step),
                                  device)
        (loss_val, aux), grads = grad_fn(
            batch, generator,
            loss_scale=precision_lib.current_scale(state.opt_state))
        for name, p in state.model.named_parameters():
            p.grad = grads[name]
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        with torch.no_grad():
            out = {"loss": loss_val}
            if with_grad_norm:
                out["grad_norm"] = global_norm(grads)
            for name in metric_names:
                out[name] = (finalize_metric(aux[name]) if accum_steps > 1
                             else compute_metric(name, aux, batch["labels"]))
        return TrainState(step=state.step + 1, model=state.model,
                          opt_state=state.opt_state), out

    return one_step


def make_train_step(model: nn.Module, loss, tx: OptimizerFactory,
                    with_metrics: bool = True, metrics: tuple = (),
                    dropout_seed: int = 0, accum_steps: int = 1,
                    precision=None) -> Callable:
    """``step(state, batch) -> (state, metrics)``: forward, backward and
    one update of the module's parameters (in place) by the state's
    optimizer, which :func:`create_train_state` built from ``tx`` (the
    JAX signature's optimizer; the step itself applies the state's).
    Metrics are 0-d tensors on the device: ``loss``, ``grad_norm`` (with
    ``with_metrics``) and each requested metric. ``accum_steps=k`` splits
    the batch into k microbatches and applies the optimizer once."""
    return _make_step_body(model, loss, with_metrics, metrics, dropout_seed,
                           accum_steps, precision=precision)


def make_epoch_fn(model: nn.Module, loss, tx: OptimizerFactory,
                  metrics: tuple = (), dropout_seed: int = 0,
                  accum_steps: int = 1, precision=None) -> Callable:
    """``epoch(state, data) -> (state, metrics)`` over ``[steps, batch,
    ...]`` leaves: the same step body as :func:`make_train_step`, looped
    (the JAX package scans it), with each metric stacked to ``[steps]``."""
    one_step = _make_step_body(model, loss, True, metrics, dropout_seed,
                               accum_steps, precision=precision)

    def epoch(state: TrainState, data: Batch):
        data = to_device(data, _device_of(state.model))
        steps = next(iter(data.values())).shape[0]
        outs = []
        for i in range(steps):
            state, out = one_step(state, {key: x[i]
                                          for key, x in data.items()})
            outs.append(out)
        return state, {name: torch.stack([o[name] for o in outs])
                       for name in outs[0]}

    return epoch


def make_eval_step(model: nn.Module) -> Callable:
    """``forward(features) -> logits`` without gradients."""

    @torch.no_grad()
    def forward(features):
        return model(torch.as_tensor(features).to(_device_of(model)))

    return forward
