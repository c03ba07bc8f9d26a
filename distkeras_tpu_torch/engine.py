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
  in the params' dtype;
- there is no ``jit``: steps run eagerly (CUDA graphs are later work);
- the per-step dropout key becomes a ``torch.Generator`` seeded from
  ``dropout_seed`` and the step (and, under accumulation, the
  microbatch). No ported model draws from it yet (``CausalLM`` has no
  dropout);
- ``precision=``: a policy with a loss scale other than 1 (``"int8"``,
  ``"fp8-sim"``) scales the loss before ``autograd.grad`` and unscales
  the gradients in float32 after; the step reads the live scale from an
  :func:`~distkeras_tpu_torch.precision.overflow_guard`-wrapped optimizer
  (:func:`~distkeras_tpu_torch.precision.current_scale`), else the
  policy's static scale applies. The reported loss is the unscaled one.

A batch is a dict ``{"features": ..., "labels": ...}`` of tensors or numpy
arrays; the step moves it to the module's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from distkeras_tpu_torch import precision as precision_lib
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.ops import losses as losses_lib
from distkeras_tpu_torch.ops.optimizers import OptimizerFactory
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


def _seeded(seed: int, index: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``index`` (the JAX
    package's ``fold_in``, not its bits)."""
    return (seed * 0x9E3779B97F4A7C15 + index + 1) % (1 << 63)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _loss_scaling(precision):
    """``(policy, (pre, post))`` when the policy scales the loss, else
    ``(policy, None)``: f32 and bf16 have scale 1 and run no scaling code,
    so they equal ``precision=None`` exactly."""
    policy = precision_lib.get_policy(precision)
    if policy is None or policy.loss_scale == 1.0:
        return policy, None
    return policy, precision_lib.scale_grads_fn(policy)


def make_loss_fn(model: nn.Module, loss) -> Callable:
    """``(batch, generator=None) -> (scalar loss, logits)``, resolving
    Keras-style loss names. No ported module sows auxiliary losses, so
    the objective is the loss alone."""
    loss_fn = losses_lib.get(loss)

    def compute(batch: Batch, generator: Optional[torch.Generator] = None):
        logits = model(batch["features"])
        return loss_fn(logits, batch["labels"]), logits

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


def _grads(model: nn.Module, loss_val: torch.Tensor) -> dict:
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss_val, params, allow_unused=True,
                                materialize_grads=True)
    return dict(zip(names, grads))


def make_grad_fn(model: nn.Module, loss, precision=None) -> Callable:
    """``(batch, generator=None, loss_scale=None) -> ((loss, logits),
    grads)``: the building block a strategy applies its optimizer after.
    Under a loss-scaling ``precision`` the gradients are those of the
    loss times ``loss_scale`` (the policy's scale when None), unscaled in
    float32; ``loss`` is the unscaled loss."""
    compute_loss = make_loss_fn(model, loss)
    policy, scaling = _loss_scaling(precision)

    def grad_fn(batch: Batch, generator: Optional[torch.Generator] = None,
                loss_scale=None):
        loss_val, logits = compute_loss(batch, generator)
        if scaling is None:
            grads = _grads(model, loss_val)
        else:
            scale = policy.loss_scale if loss_scale is None else loss_scale
            grads = scaling[1](_grads(model, scaling[0](loss_val, scale)),
                               scale)
        return (loss_val.detach(), logits.detach()), grads

    return grad_fn


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
                       precision=None) -> Callable:
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

    def grad_fn(batch: Batch, generator: Optional[torch.Generator] = None,
                loss_scale=None):
        scale = None if scaling is None else (
            policy.loss_scale if loss_scale is None else loss_scale)
        micro = _split_microbatches(batch, k)
        params = dict(model.named_parameters())
        device = _device_of(model)
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        terms = {name: (torch.zeros((), device=device),
                        torch.zeros((), device=device))
                 for name in metric_names}
        grad_sum = {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in params.items()}
        for i in range(k):
            batch_i = {key: x[i] for key, x in micro.items()}
            gen_i = None if generator is None else _generator(
                _seeded(generator.initial_seed(), i), generator.device)
            loss_i, logits = compute_loss(batch_i, gen_i)
            grads = _grads(model, loss_i if scale is None
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
        grads = {n: (g / k).to(params[n].dtype) for n, g in grad_sum.items()}
        return (loss_sum / k, terms), grads

    return grad_fn


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
        generator = _generator(_seeded(dropout_seed, state.step), device)
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
