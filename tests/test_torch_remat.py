"""Activation rematerialization in the port: every policy against
``"none"`` for every family, and what a recompute must replay.

- ``remat`` in {blocks, dots_saveable, full} gives the loss and every
  gradient of ``"none"`` bit for bit on the CPU (the recompute runs the
  same ops on the same values), for gpt, resnet, bert, vit and the MoE
  classifier; with dropout on (bert, vit) and router noise (MoE), which
  draw from the step engine's generator;
- the same under ``torch.func.functional_call`` on parameters that are
  not the module's own (the substrate's form);
- the MoE's sown term counts once, even when the backward runs while a
  collector is open;
- fewer activations are saved for the backward under ``"blocks"``;
- the policy names are the JAX package's.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from distkeras_tpu.models import remat as jremat
from distkeras_tpu_torch import engine
from distkeras_tpu_torch.models import (aux_losses, bert_tiny, gpt_tiny,
                                        remat, resnet18, vit_tiny)
from distkeras_tpu_torch.models.moe import MoEClassifier
from distkeras_tpu_torch.models.transformer import init_params
from distkeras_tpu_torch.utils import rng as rng_lib

POLICIES = ("blocks", "dots_saveable", "full")


def _batch(family):
    g = np.random.default_rng(0)
    if family in ("gpt", "bert"):
        ids = g.integers(1, 250, (2, 16))
        return {"features": ids,
                "labels": np.where(g.random((2, 16)) < 0.5, ids, -1)}, \
            "masked_lm"
    shape = {"resnet": (2, 32, 32, 3), "vit": (2, 16, 16, 3),
             "moe": (2, 8, 16)}[family]
    return {"features": g.standard_normal(shape).astype(np.float32),
            "labels": np.eye(4, dtype=np.float32)[[1, 2]]}, \
        "categorical_crossentropy"


def _model(family, policy):
    """Seeded weights, the same for every policy; dropout or router noise
    where the family has them."""
    torch.manual_seed(0)
    if family == "gpt":
        return gpt_tiny(remat=policy)
    if family == "resnet":
        return resnet18(num_classes=4, width=8, dtype=torch.float32,
                        remat=policy)
    if family == "bert":
        model = bert_tiny(remat=policy, dropout_rate=0.1)
    elif family == "vit":
        model = vit_tiny(remat=policy, dropout_rate=0.1, num_classes=4)
    else:
        model = MoEClassifier(4, num_layers=2, dtype=torch.float32,
                              remat=policy)
        for i in range(2):
            getattr(model, f"block{i}").moe.router_noise = 0.5
    return init_params(model, torch.Generator().manual_seed(0))


def _grads(family, policy, functional=False):
    model = _model(family, policy)
    batch, loss = _batch(family)
    batch = engine.to_device(batch, "cpu")
    gen = rng_lib.generator(7, torch.device("cpu"))
    if not functional:
        (value, _), grads = engine.make_grad_fn(model, loss)(batch, gen)
        return value, grads
    # parameters that are not the module's own: a recompute on the
    # module's tensors would give other gradients
    params = {k: (p.detach() * 1.25).requires_grad_()
              for k, p in model.named_parameters()}
    (value, _), grads = engine.make_grad_fn(model, loss, functional=True)(
        params, batch, gen)
    return value, grads


@pytest.fixture(scope="module")
def reference():
    return {(f, fn): _grads(f, "none", fn)
            for f in ("gpt", "resnet", "bert", "vit", "moe")
            for fn in (False, True)}


@pytest.mark.parametrize("functional", [False, True],
                         ids=["module", "functional_call"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", ["gpt", "resnet", "bert", "vit", "moe"])
def test_remat_gives_the_gradients_of_none(reference, family, policy,
                                           functional):
    want_loss, want = reference[(family, functional)]
    loss, grads = _grads(family, policy, functional)
    assert torch.equal(loss, want_loss), (float(loss), float(want_loss))
    assert set(grads) == set(want)
    worst = max((grads[k] - want[k]).abs().max().item() for k in want)
    assert all(torch.equal(grads[k], want[k]) for k in want), worst


def test_dropout_draws_differ_between_generators():
    """The dropout cases above exercise the generator: another seed gives
    other gradients."""
    model = _model("bert", "blocks")
    batch, loss = _batch("bert")
    grad_fn = engine.make_grad_fn(model, loss)
    batch = engine.to_device(batch, "cpu")
    a = grad_fn(batch, rng_lib.generator(7, torch.device("cpu")))[1]
    b = grad_fn(batch, rng_lib.generator(8, torch.device("cpu")))[1]
    assert not all(torch.equal(a[k], b[k]) for k in a)


def test_moe_aux_term_counts_once_with_a_collector_open():
    """A backward run inside an open collector recomputes both blocks
    under ``blocks``; their terms are not sown again."""
    x = torch.from_numpy(_batch("moe")[0]["features"])
    counts = {}
    for policy in ("none", "blocks"):
        model = _model("moe", policy)
        with aux_losses.collect() as terms:
            out = model(x, generator=torch.Generator().manual_seed(1))
            (out.sum() + sum(terms)).backward()
        counts[policy] = [float(t.detach()) for t in terms]
    assert len(counts["blocks"]) == 2
    assert counts["blocks"] == counts["none"]


def test_blocks_saves_fewer_activations():
    """The point of the layer: the bytes autograd keeps for the backward
    (saved-tensor hooks over one forward) shrink under ``blocks``."""
    def saved_bytes(policy):
        model = _model("bert", policy)
        ids = torch.from_numpy(_batch("bert")[0]["features"])
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model(ids, generator=torch.Generator().manual_seed(1))
        return total[0]

    none, blocks = saved_bytes("none"), saved_bytes("blocks")
    assert blocks < 0.6 * none, (blocks, none)


def test_no_grad_and_none_call_the_module_plainly():
    model = _model("bert", "blocks")
    ids = torch.from_numpy(_batch("bert")[0]["features"])
    with mock.patch.object(remat.ckpt, "checkpoint") as wrapped:
        with torch.no_grad():
            model(ids)
        _model("bert", "none")(ids).sum().backward()
    wrapped.assert_not_called()


def test_policy_names_follow_jax_and_unknown_ones_raise():
    assert remat.REMAT_POLICIES == jremat.REMAT_POLICIES
    for make in (gpt_tiny, bert_tiny, vit_tiny,
                 lambda remat: resnet18(remat=remat),
                 lambda remat: MoEClassifier(4, remat=remat)):
        with pytest.raises(ValueError, match="remat must be one of"):
            make(remat="sometimes")
