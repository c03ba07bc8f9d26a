"""The port's one-process (workers x model) mesh against the JAX package:
partition rules, ``PjitTrainer`` (GSPMD and bucketed folds, sharded
storage and optimizer state), expert-parallel rules, precision
re-stamping, ``ServingEngine``/``ModelPredictor`` over a mesh, the native
batcher and the compat helpers.

JAX runs on conftest's 8 CPU devices; the port on meshes that repeat
``cpu``. Weights cross with the bridge (JAX's ``init`` at the trainer's
seed, loaded into the port's module). Bounds, float32 (summation order
the only difference): rtol 1e-4 / atol 1e-5 on losses and parameters,
as ``tests/test_torch_trainers.py`` states them, except ViT's params
under adam (a bound derived in its test: adam amplifies summation-order
ulps of small gradients up to its per-step reach); serving and scoring outputs rtol 1e-5 / atol 1e-6. Model
parallelism M with one worker is held to M = 1 bit for bit, and so is a
bucketed fold to the whole-tree fold; re-stamping a built model is held
bit for bit to building it with ``precision=``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as tdk
from distkeras_tpu import precision as jprecision
from distkeras_tpu.models.mlp import MLP as JMLP
from distkeras_tpu.parallel import collectives as jcollectives
from distkeras_tpu.parallel import mesh as jmesh
from distkeras_tpu.parallel import tensor as jtensor
from distkeras_tpu_torch import engine, precision
from distkeras_tpu_torch.models import moe
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.parallel import collectives, tensor
from distkeras_tpu_torch.parallel.mesh import Mesh, make_mesh
from distkeras_tpu_torch.utils import bridge

TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_specs(tree, prefix=()):
    """{flax path: spec as a tuple} of a nested dict of specs."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat_specs(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = tuple(value)
    return out


def _port_specs_as_flax(state_dict, rules, mesh):
    """The port's specs, mapped back to flax paths and layout."""
    specs = tensor.partition_specs(state_dict, rules, mesh)
    out = {}
    for name, spec in specs.items():
        path, axes = bridge.flax_layout(name, state_dict[name].dim())
        out[path] = tuple(tensor.to_flax_spec(spec, axes))
    return out


# -- partition rules ----------------------------------------------------------

def _jax_rules_dict():
    return {
        "encoder": {"layer_0": {
            "attn": {"qkv": {"kernel": np.zeros((64, 192), np.float32)},
                     "out": {"kernel": np.zeros((64, 64), np.float32)}},
            "mlp": {"fc1": {"kernel": np.zeros((64, 128), np.float32)},
                    "fc2": {"kernel": np.zeros((128, 64), np.float32)}}}},
        "head": {"kernel": np.zeros((64, 10), np.float32),
                 "bias": np.zeros((10,), np.float32)},
    }


def _shapes(jmodel, *args):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        lambda k: jmodel.init(k, *args, train=False),
        jax.random.key(0))["params"])


def _spec_case(case):
    """(flax params, port model or None, rules pair, (workers, model))."""
    from distkeras_tpu.models import bert_tiny as jbert
    from distkeras_tpu.models import vit_tiny as jvit
    from distkeras_tpu.models.moe import MoEClassifier as JMoE
    from distkeras_tpu.models.moe import ep_partition_rules as jep
    from distkeras_tpu_torch.models import bert_tiny, vit_tiny

    if case == "jax_dict":
        return _jax_rules_dict(), None, (None, None), (4, 2)
    if case == "jax_dict_indivisible":
        return ({"head": {"kernel": np.zeros((64, 10), np.float32)}}, None,
                (None, None), (2, 4))
    if case == "vit_tiny":
        return (_shapes(jvit(), jnp.zeros((1, 16, 16, 3))), vit_tiny(),
                (None, None), (2, 4))
    if case == "bert_tiny":
        return (_shapes(jbert(), jnp.zeros((1, 16), jnp.int32)),
                bert_tiny(num_segments=0), (None, None), (4, 2))
    if case == "moe_ep":
        jm = JMoE(num_classes=4, num_layers=2, num_heads=2, num_experts=4,
                  mlp_dim=32, dtype=jnp.float32)
        return (_shapes(jm, jnp.zeros((1, 8, 16))),
                moe.MoEClassifier(4, num_layers=2, num_heads=2,
                                  num_experts=4, mlp_dim=32,
                                  dtype=torch.float32, width=16),
                (jep(), moe.ep_partition_rules()), (2, 4))
    raise KeyError(case)


@pytest.mark.parametrize("case", ["jax_dict", "jax_dict_indivisible",
                                  "vit_tiny", "bert_tiny", "moe_ep"])
def test_partition_specs_match_jax(case):
    """Every leaf's spec, the port's mapped back to flax paths and
    layout, equals JAX's, the divisibility fallback included; a flax tree
    given to the port directly gets JAX's specs in its own layout."""
    params, tmodel, (jrules, trules), (w, m) = _spec_case(case)
    jm = jmesh.make_mesh(num_workers=w, model_parallelism=m)
    want = _flat_specs(jtensor.partition_specs(params, jrules, jm))
    tm = Mesh(["cpu"] * (w * m), model_parallelism=m)
    assert _flat_specs(tensor.partition_specs(params, trules, tm)) == want
    state = tmodel.state_dict() if tmodel is not None \
        else bridge.flax_to_state_dict(params)
    assert _port_specs_as_flax(state, trules, tm) == want
    if case == "jax_dict":
        assert want[("encoder", "layer_0", "attn", "qkv", "kernel")] == \
            (None, "model")
        port = tensor.partition_specs(state, mesh=tm)
        assert port["encoder.layers.0.attn.qkv.weight"] == tensor.P(
            "model", None)  # the column split on the [out, in] weight
    if case == "moe_ep":
        port = tensor.partition_specs(state, trules, tm)
        assert port["block0.moe.experts.fc1.weight"] == tensor.P(
            "model", None, None)
    assert any(want.values()) == (case != "jax_dict_indivisible")


# -- PjitTrainer ----------------------------------------------------------------

def _jax_mlp_init(features, seed):
    return _np(JMLP(features=features, num_classes=10).init(
        jax.random.key(seed), jnp.zeros((1, 784)), train=False)["params"])


def _port_mlp(flax_params, features):
    model = MLP(features=features, num_classes=10, dropout_rate=0.0)
    bridge.load_flax_params(model, flax_params)
    return model


def test_pjit_mlp_dp8_matches_jax_and_single():
    """The twin of JAX's test_pjit_trainer_matches_single_device_math:
    workers 8 against JAX's workers 8 (each step's loss and accuracy and
    the final params) and against the port's SingleTrainer."""
    ds_j, ds_t = jdk.synthetic_mnist(n=512), tdk.synthetic_mnist(n=512)
    kw = dict(worker_optimizer="sgd", learning_rate=0.1, batch_size=64,
              num_epoch=1, seed=3)
    init = _jax_mlp_init((32,), 3)
    jt = jdk.PjitTrainer(JMLP(features=(32,), num_classes=10,
                              dropout_rate=0.0), num_workers=8, **kw)
    jparams = bridge.flax_to_state_dict(_np(jt.train(ds_j)))
    tt = tdk.PjitTrainer(_port_mlp(init, (32,)), num_workers=8,
                         device="cpu", **kw)
    tparams = tt.train(ds_t)
    assert tt.mesh.shape == {"workers": 8, "model": 1}
    for hj, ht in zip(jt.get_history(), tt.get_history(), strict=True):
        assert sorted(hj) == sorted(ht) == ["accuracy", "loss"]
        np.testing.assert_allclose(ht["loss"], hj["loss"], **TOL)
        assert ht["accuracy"] == hj["accuracy"]
    for name, want in jparams.items():
        np.testing.assert_allclose(tparams[name].numpy(), want.numpy(),
                                   **TOL)
    ts = tdk.SingleTrainer(_port_mlp(init, (32,)), device="cpu", **kw)
    sparams = ts.train(ds_t)
    for name, want in sparams.items():
        np.testing.assert_allclose(tparams[name].numpy(), want.numpy(),
                                   **TOL)


@pytest.mark.parametrize("opt", ["adam", "lamb", "momentum"])
def test_model_parallelism_with_one_worker_is_bitwise_model_one(opt):
    """workers 1 x model 4 gives the bits of model 1 (the gathered
    parameters are the unsharded ones; LAMB's trust ratio spans the whole
    tensor); each sharded parameter is held as 4 shards of a quarter of
    its bytes, and so is its optimizer state."""
    ds = tdk.synthetic_mnist(n=256)
    init = _jax_mlp_init((32,), 0)
    out = []
    for m in (1, 4):
        t = tdk.PjitTrainer(_port_mlp(init, (32,)), num_workers=1,
                            model_parallelism=m, device="cpu",
                            worker_optimizer=opt, learning_rate=1e-2,
                            batch_size=64)
        out.append((t.train(ds), [h["loss"] for h in t.history], t))
    (p1, h1, _), (p4, h4, t4) = out
    assert h1 == h4
    assert all(torch.equal(p1[n], p4[n]) for n in p1)
    w = t4.state.params["dense_0.weight"]  # fc: P(None, model) -> rows
    assert isinstance(w, tensor.Sharded) and w.dim == 0
    assert [tuple(s.shape) for s in w.shards] == [(8, 784)] * 4
    assert sum(s.nbytes for s in w.shards) == p4["dense_0.weight"].nbytes
    assert all(4 * s.nbytes == p4["dense_0.weight"].nbytes
               for s in w.shards)
    state = t4.state.opt_state.state
    for s in w.shards:
        moments = [v for v in state[s].values()
                   if torch.is_tensor(v) and v.dim() > 0]
        assert moments and all(v.shape == s.shape for v in moments)
    # head [10, 32]: 10 % 4 != 0 replicates
    assert isinstance(t4.state.params["head.weight"], torch.Tensor)


@pytest.fixture
def jax_init_jitted(monkeypatch):
    """JAX's trainers initialize through ``engine.create_train_state``
    op by op; jitted, the same init costs one compile, not one an op."""
    from distkeras_tpu import engine as jengine

    eager = jengine.create_train_state
    monkeypatch.setattr(
        jengine, "create_train_state",
        lambda model, key, batch, tx: jax.jit(
            lambda k, b: eager(model, k, b, tx))(key, batch))


def test_vit_tiny_dp2_tp4_matches_jax(jax_init_jitted):
    """``vit_tiny(width=64, num_heads=2, mlp_dim=128)`` at workers 2 x
    model 4 under adam: every step's loss and the final params against
    JAX's PjitTrainer on the same mesh shape, from JAX's init.

    Bound on the params, derived for adam: its update is ``m / (sqrt(v)
    + eps)`` element by element, at most about 1 in size whatever the
    gradient's scale, so an element moves at most ``lr`` a step, and
    float32 summation-order differences in a small gradient are amplified
    into that step. The params are held to ``atol = 1e-2 * steps * lr``
    (1% of the furthest adam can move an element) with rtol 1e-4. The
    keys' bias has a gradient of zero in real arithmetic (a softmax is
    invariant to a per-query constant), so its gradient is rounding in
    either package, about adam's eps in size, and adam turns that into
    steps of up to ``lr`` in a direction rounding decides. So it is held
    three ways: the port's gradient of it at init is rounding (below
    1e-5 of the queries' and values' bias gradients; a real gradient,
    from a wrong slice of the fused bias, would be of their size); each
    package leaves it within adam's reach of its init (Cauchy-Schwarz on
    the bias-corrected moments: ``lr * sum_t sqrt(sum_i a_i**2 / b_i)``,
    4.012 lr over 4 steps); the two within ``2 * steps * lr`` of each
    other. The losses keep TOL."""
    from distkeras_tpu.models import vit_tiny as jvit
    from distkeras_tpu_torch.models import vit_tiny

    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 16, 16, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 128)]
    lr, width = 1e-3, 64
    kw = dict(worker_optimizer="adam", learning_rate=lr, batch_size=32,
              num_workers=2, model_parallelism=4, num_epoch=1, metrics=())
    jm = jvit(width=width, num_heads=2, mlp_dim=128)
    jt = jdk.PjitTrainer(jm, **kw)
    jparams = bridge.flax_to_state_dict(_np(jt.train(
        jdk.Dataset({"features": x, "label": y}))))
    init = _np(jax.jit(lambda k: jm.init(k, jnp.zeros((1, 16, 16, 3)),
                                         train=False))(
        jax.random.key(0))["params"])
    tm = vit_tiny(width=width, num_heads=2, mlp_dim=128)
    bridge.load_flax_params(tm, init)
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    (_, _), grads = engine.make_grad_fn(tm, "categorical_crossentropy")(
        {"features": torch.from_numpy(x[:32]),
         "labels": torch.from_numpy(y[:32])})
    for name, g in grads.items():
        if name.endswith("attn.qkv.bias"):
            q, k, v = g.abs().split(width)
            assert k.max() <= 1e-5 * min(q.max(), v.max()), name
    tt = tdk.PjitTrainer(tm, device="cpu", **kw)
    tparams = tt.train(tdk.Dataset.from_arrays(features=x, label=y))
    steps = len(tt.history)
    assert steps == len(jt.history) == 4
    np.testing.assert_allclose([h["loss"] for h in tt.history],
                               [h["loss"] for h in jt.history], **TOL)
    b1, b2 = 0.9, 0.999
    reach = lr * sum(np.sqrt(sum(
        ((1 - b1) * b1 ** (t - i) / (1 - b1 ** t)) ** 2
        / ((1 - b2) * b2 ** (t - i) / (1 - b2 ** t))
        for i in range(1, t + 1))) for t in range(1, steps + 1))
    for name, want in jparams.items():
        got, want = tparams[name].numpy().copy(), want.numpy().copy()
        if name.endswith("attn.qkv.bias"):  # [q | k | v]
            key_got, key_want = got[width:2 * width], want[width:2 * width]
            key_start = start[name][width:2 * width].numpy()
            assert np.abs(key_got - key_start).max() <= reach, name
            assert np.abs(key_want - key_start).max() <= reach, name
            np.testing.assert_allclose(key_got, key_want, rtol=0,
                                       atol=2 * steps * lr)
            got[width:2 * width] = want[width:2 * width]
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-2 * steps * lr, err_msg=name)
    sharded = {n for n, p in tt.state.params.items()
               if isinstance(p, tensor.Sharded)}
    assert "encoder.layers.0.attn.qkv.weight" in sharded


def _global_batch_case(family):
    """(jax model, port model from JAX's init, rules pair, dataset pair,
    loss) for the objectives GSPMD takes over the global batch."""
    from distkeras_tpu.models import bert_tiny as jbert
    from distkeras_tpu.models.moe import MoEClassifier as JMoE
    from distkeras_tpu.models.moe import ep_partition_rules as jep
    from distkeras_tpu_torch.models import bert_tiny

    rng = np.random.default_rng(2)
    if family == "moe_ep":
        # capacity_factor 0.5: 16 slots an expert for the global batch's
        # 128 tokens, 8 for a worker's 64, so the drops bind
        kw = dict(num_layers=1, num_heads=2, num_experts=4, mlp_dim=32,
                  capacity_factor=0.5)
        x = rng.standard_normal((32, 8, 16)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 32)]
        jm = JMoE(num_classes=4, dtype=jnp.float32, **kw)
        tm = moe.MoEClassifier(4, dtype=torch.float32, width=16, **kw)
        rules, loss = (jep(), moe.ep_partition_rules()), \
            "categorical_crossentropy"
    else:
        # each row masks a different share of its tokens (1 to 12 of 16),
        # so the mean of the workers' means is not the global mean
        x = rng.integers(1, 256, (32, 16)).astype(np.int32)
        keep = rng.random((32, 16)) < rng.uniform(0.05, 0.75, (32, 1))
        keep[:, 0] = True
        y = np.where(keep, x, -1).astype(np.int32)
        jm, tm = jbert(), bert_tiny(num_segments=0)
        rules, loss = (None, None), "masked_lm"
    init = _np(jax.jit(lambda k: jm.init(k, jnp.asarray(x[:1]),
                                         train=False))(
        jax.random.key(0))["params"])
    bridge.load_flax_params(tm, init)
    return (jm, tm, rules, (jdk.Dataset({"features": x, "label": y}),
                            tdk.Dataset.from_arrays(features=x, label=y)),
            loss)


@pytest.mark.parametrize("family", ["moe_ep", "bert_mlm"])
def test_pjit_global_batch_objectives_match_jax(family, jax_init_jitted):
    """Workers 2 x model 2 against JAX's PjitTrainer on the same mesh
    shape, from JAX's init: objectives that GSPMD takes over the global
    batch and that a mean of per-worker losses would not give: the
    Switch-MoE under ``ep_partition_rules()`` (capacity ``int(cf *
    tokens / E)`` and the load-balance term of all the batch's tokens)
    and BERT's masked_lm (the mean over the global batch's valid tokens).
    Every step's loss and the final params within TOL (sgd, so a
    summation-order difference stays its own size)."""
    jm, tm, (jrules, trules), (ds_j, ds_t), loss = _global_batch_case(family)
    kw = dict(loss=loss, worker_optimizer="sgd", learning_rate=0.1,
              batch_size=16, num_workers=2, model_parallelism=2,
              metrics=())
    jt = jdk.PjitTrainer(jm, partition_rules=jrules, **kw)
    jparams = bridge.flax_to_state_dict(_np(jt.train(ds_j)))
    tt = tdk.PjitTrainer(tm, partition_rules=trules, device="cpu", **kw)
    tparams = tt.train(ds_t)
    assert len(tt.history) == len(jt.history) == 2
    np.testing.assert_allclose([h["loss"] for h in tt.history],
                               [h["loss"] for h in jt.history], **TOL)
    for name, want in jparams.items():
        np.testing.assert_allclose(tparams[name].numpy(), want.numpy(),
                                   err_msg=name, **TOL)
    assert any(isinstance(p, tensor.Sharded)
               for p in tt.state.params.values())


def test_moe_under_ep_rules_is_bitwise_model_one():
    """The MoE classifier under ``ep_partition_rules()`` at workers 1 x
    model 2 and 4 (the stacked expert axis sharded: 2 and 1 experts a
    position) gives model 1's per-step objectives (sown load-balance
    terms included) and params bit for bit. Model 1's step is the one
    ``tests/test_torch_moe.py`` holds to JAX's loss and gradients, and the
    rules are held to JAX's by ``test_partition_specs_match_jax``."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 8, 16)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 32)]
    ds = tdk.Dataset.from_arrays(features=x, label=y)
    torch.manual_seed(0)
    start = moe.MoEClassifier(4, num_layers=1, num_heads=2, num_experts=4,
                              mlp_dim=32, dtype=torch.float32, width=16)
    out = {}
    for m in (1, 2, 4):
        tm = copy.deepcopy(start)
        tt = tdk.PjitTrainer(tm, partition_rules=moe.ep_partition_rules(),
                             device="cpu", worker_optimizer="adam",
                             learning_rate=1e-3, batch_size=16,
                             model_parallelism=m, metrics=())
        out[m] = (tt.train(ds), [h["loss"] for h in tt.history], tt)
    for m in (2, 4):
        assert out[m][1] == out[1][1]
        assert all(torch.equal(out[m][0][n], out[1][0][n]) for n in out[1][0])
        w = out[m][2].state.params["block0.moe.experts.fc1.weight"]
        assert w.dim == 0 and [s.shape[0] for s in w.shards] == [4 // m] * m


def test_opt_state_sharding_is_structural_not_shape_keyed():
    """Two same-shaped params with DIFFERENT specs: each adam moment
    takes its own param's shards (the twin of JAX's test of the name)."""
    from distkeras_tpu_torch.ops import optimizers

    class TwoSquare(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.colp = torch.nn.Linear(16, 16)
            self.rowp = torch.nn.Linear(16, 16)

        def forward(self, x):
            return self.rowp(self.colp(x))

    rules = ((r"colp/kernel$", tensor.P(None, "model")),
             (r"rowp/kernel$", tensor.P("model", None)))
    mesh = make_mesh(num_workers=2, model_parallelism=4,
                     devices=["cpu"] * 8)
    model = TwoSquare()
    _, place_state, _ = tensor.build_pjit_epoch_fn(
        model, "mse", optimizers.get("adam", 1e-3), mesh, (), rules)
    state = place_state(dict(model.named_parameters()))
    colp, rowp = state.params["colp.weight"], state.params["rowp.weight"]
    assert (colp.spec, colp.dim) == (tensor.P("model", None), 0)
    assert (rowp.spec, rowp.dim) == (tensor.P(None, "model"), 1)
    for p in (colp, rowp):
        p.shards[0].grad = torch.ones_like(p.shards[0])
        for s in p.shards[1:]:
            s.grad = torch.zeros_like(s)
    for name in ("colp.bias", "rowp.bias"):
        state.params[name].grad = torch.zeros(16)
    state.opt_state.step()
    for p in (colp, rowp):
        for s in p.shards:
            st = state.opt_state.state[s]
            assert st["exp_avg"].shape == st["exp_avg_sq"].shape == s.shape
    assert colp.shards[0].shape == (4, 16) and rowp.shards[0].shape == (16, 4)


def test_bucketed_fold_is_bitwise_the_whole_tree_fold():
    """``bucket_bytes`` at several sizes (ragged tails, one leaf a
    bucket) gives the bits of one bucket holding every leaf (the
    whole-tree fold), and the buckets are JAX's. The GSPMD step, which
    takes the global batch's loss in one pass where the bucketed step
    sums the workers' slices, agrees within TOL (summation order)."""
    ds = tdk.synthetic_mnist(n=256)
    init = _jax_mlp_init((32, 16), 0)
    runs = {}
    for bb in (None, 1, 256, 4096, 1 << 30):
        t = tdk.PjitTrainer(_port_mlp(init, (32, 16)), num_workers=4,
                            device="cpu", batch_size=32, bucket_bytes=bb,
                            worker_optimizer="adam", learning_rate=1e-3)
        runs[bb] = (t.train(ds), [h["loss"] for h in t.history])
    base_p, base_h = runs[1 << 30]
    for bb, (p, h) in runs.items():
        if bb is None:
            np.testing.assert_allclose(h, base_h, **TOL)
            for n in p:
                np.testing.assert_allclose(p[n].numpy(), base_p[n].numpy(),
                                           **TOL)
            continue
        assert h == base_h, bb
        assert all(torch.equal(p[n], base_p[n]) for n in p), bb
    sizes = [3000, 40, 12, 4096, 7, 1]
    for bb in (1, 50, 4096, 10 ** 6):
        assert collectives.partition_buckets(sizes, bb) == \
            jcollectives.partition_buckets(sizes, bb)
    trees = [{"a": torch.randn(3), "b": torch.randn(2, 2)} for _ in range(3)]
    for bb in (None, 4, 1 << 20):
        out = collectives.bucketed_psum(trees, bb)
        assert torch.equal(out["a"], trees[0]["a"] + trees[1]["a"]
                           + trees[2]["a"])


def _value_error_cases():
    m, jm = (lambda: MLP(features=(8,))), (lambda: JMLP(features=(8,)))
    return {
        "batch_divisible": (
            lambda: jdk.PjitTrainer(jm(), batch_size=30, num_workers=8),
            lambda: tdk.PjitTrainer(m(), batch_size=30, num_workers=8,
                                    device="cpu")),
        "data_layout": (
            lambda: jdk.PjitTrainer(jm(), num_workers=2,
                                    data_layout="nope"),
            lambda: tdk.PjitTrainer(m(), num_workers=2, data_layout="nope",
                                    device="cpu")),
        "accum_positive": (
            lambda: jdk.PjitTrainer(jm(), num_workers=2, accum_steps=0),
            lambda: tdk.PjitTrainer(m(), num_workers=2, accum_steps=0,
                                    device="cpu")),
        "accum_divides": (
            lambda: jdk.PjitTrainer(jm(), num_workers=2, batch_size=32,
                                    accum_steps=3),
            lambda: tdk.PjitTrainer(m(), num_workers=2, batch_size=32,
                                    accum_steps=3, device="cpu")),
        "bucket_positive": (
            lambda: jdk.PjitTrainer(jm(), num_workers=2, bucket_bytes=0),
            lambda: tdk.PjitTrainer(m(), num_workers=2, bucket_bytes=0,
                                    device="cpu")),
        "bucket_model_axis": (
            lambda: jdk.PjitTrainer(jm(), num_workers=2,
                                    model_parallelism=2, bucket_bytes=64),
            lambda: tdk.PjitTrainer(m(), num_workers=2, model_parallelism=2,
                                    bucket_bytes=64, device="cpu")),
        "mesh_too_small": (
            lambda: jmesh.make_mesh(num_workers=8, model_parallelism=2),
            lambda: make_mesh(num_workers=8, model_parallelism=2,
                              devices=["cpu"] * 8)),
        "partition_buckets": (
            lambda: jcollectives.partition_buckets([4], 0),
            lambda: collectives.partition_buckets([4], 0)),
        "epoch_fn_bucket_model_axis": (
            lambda: jtensor.build_pjit_epoch_fn(
                jm(), "mse", __import__("optax").sgd(0.1),
                jmesh.make_mesh(num_workers=2, model_parallelism=2),
                bucket_bytes=64),
            lambda: tensor.build_pjit_epoch_fn(
                m(), "mse", tdk.ops.optimizers.get("sgd", 0.1),
                Mesh(["cpu"] * 4, model_parallelism=2), bucket_bytes=64)),
    }


@pytest.mark.parametrize("case", sorted(_value_error_cases()))
def test_value_errors_twin_jax(case):
    """Each validation raises ValueError in both packages, with JAX's
    message."""
    jbuild, tbuild = _value_error_cases()[case]
    with pytest.raises(ValueError) as je:
        jbuild()
    with pytest.raises(ValueError) as te:
        tbuild()
    assert str(te.value) == str(je.value)


def test_checkpoint_resume_reshards(tmp_path):
    """A PjitTrainer checkpoint holds whole tensors: a run at model 2
    stopped after epoch 1 and resumed at model 4 continues the
    uninterrupted model-1 run's trajectory bit for bit (adam's moments
    included)."""
    ds = tdk.synthetic_mnist(n=128)
    init = _jax_mlp_init((32,), 0)
    kw = dict(num_workers=1, device="cpu", worker_optimizer="adam",
              learning_rate=1e-2, batch_size=32, metrics=())
    full = tdk.PjitTrainer(_port_mlp(init, (32,)), num_epoch=2, **kw)
    want = full.train(ds)
    ck = str(tmp_path / "ck")
    first = tdk.PjitTrainer(_port_mlp(init, (32,)), num_epoch=1,
                            model_parallelism=2, checkpoint_dir=ck, **kw)
    first.train(ds)
    resumed = tdk.PjitTrainer(_port_mlp(init, (32,)), num_epoch=2,
                              model_parallelism=4, checkpoint_dir=ck, **kw)
    got = resumed.train(ds, resume=True)
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in full.history][4:]
    assert all(torch.equal(got[n], want[n]) for n in want)


# -- precision re-stamping ------------------------------------------------------

def _family(name):
    from distkeras_tpu_torch.models import (bert_tiny, gpt_tiny, resnet18,
                                            vit_tiny)

    return {
        "gpt": (gpt_tiny, lambda: torch.randint(0, 256, (2, 16))),
        "bert": (bert_tiny, lambda: torch.randint(1, 100, (2, 16))),
        "vit": (vit_tiny, lambda: torch.randn(2, 16, 16, 3)),
        # 32x32, not 16x16: at 16x16 the last stage's strided conv sees a
        # 1x1 input, where torch's CPU bf16 channels_last weight gradient
        # reads uninitialized memory (NaNs in about 4% of calls, shown by
        # a bare F.conv2d; ROADMAP.md Queue C)
        "resnet": (lambda **k: resnet18(width=8, num_classes=4, **k),
                   lambda: torch.randn(2, 32, 32, 3)),
        "moe": (lambda **k: moe.MoEClassifier(3, width=16, **k),
                lambda: torch.randn(2, 8, 16)),
    }[name]


@pytest.mark.parametrize("family", ["gpt", "bert", "vit", "resnet", "moe"])
@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_restamp_is_bitwise_building_with_precision(family, name):
    """``apply_to_model`` on a built model equals the model built with
    ``precision=`` carrying the same weights, bit for bit (forward and
    every gradient), and keeps the original's weights, device and
    kwargs."""
    build, inputs = _family(family)
    torch.manual_seed(0)
    built = build()
    restamped = precision.apply_to_model(built, name)
    direct = build(precision=name)
    direct.load_state_dict(built.state_dict())
    assert restamped is not built and restamped.precision == name
    assert type(restamped) is type(built)
    x = inputs()
    outs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU's conv backward sums per thread
    try:
        for model in (restamped, direct):
            model.zero_grad()
            y = model(x)
            y.float().square().mean().backward()
            outs.append((y, {n: p.grad for n, p in
                             model.named_parameters()}))
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(outs[0][0], outs[1][0])
    for n, g in outs[0][1].items():  # an unused parameter has no grad
        assert (g is None and outs[1][1][n] is None) or \
            torch.equal(g, outs[1][1][n]), n
    assert all(torch.equal(a, b) for a, b in zip(
        restamped.state_dict().values(), built.state_dict().values()))
    assert precision.apply_to_model(restamped, name) is restamped


def test_restamp_errors_like_jax():
    """A model with no ``precision`` field and a contradicting precision
    raise ValueError in both packages."""
    import flax.linen as nn

    with pytest.raises(ValueError, match="no `precision` field"):
        jprecision.apply_to_model(nn.LayerNorm(), "bf16")
    with pytest.raises(ValueError, match="no `precision` field"):
        precision.apply_to_model(torch.nn.Linear(3, 3), "bf16")
    with pytest.raises(ValueError, match="contradicts"):
        jprecision.apply_to_model(JMLP(precision="bf16"), "int8")
    with pytest.raises(ValueError, match="contradicts"):
        precision.apply_to_model(MLP(precision="bf16"), "int8")
    assert precision.apply_to_model(MLP(), None).precision is None


# -- serving and scoring over a mesh -------------------------------------------

FEATS = 12


@pytest.fixture(scope="module")
def served():
    jm = JMLP(features=(32,), num_classes=10)
    params = _np(jm.init(jax.random.key(0), jnp.zeros((2, FEATS)),
                         train=False)["params"])
    tm = MLP(features=(32,), num_classes=10, in_features=FEATS)
    bridge.load_flax_params(tm, params)
    return jm, params, tm


def test_serving_engine_on_mesh_matches_jax(served):
    """JAX's test_engine_on_mesh_requires_divisible_buckets, twinned:
    the same ValueError for a bucket the worker count does not divide,
    and a mesh engine's rows equal JAX's mesh engine's; one capture a
    (bucket, shard), and one weight bank for the shards' one device,
    which a swap loads once."""
    from distkeras_tpu.serving import ServingEngine as JEngine
    from distkeras_tpu_torch.serving import ServingEngine

    jm, params, tm = served
    jmesh8 = jmesh.make_mesh(num_workers=8)
    tmesh8 = Mesh(["cpu"] * 8)
    with pytest.raises(ValueError, match="divisible") as je:
        JEngine(jm, params, input_shape=(FEATS,), buckets=(1, 8),
                mesh=jmesh8, warmup=False)
    with pytest.raises(ValueError, match="divisible") as te:
        ServingEngine(tm, (FEATS,), buckets=(1, 8), mesh=tmesh8)
    assert str(te.value) == str(je.value)
    x = np.random.default_rng(4).normal(size=(5, FEATS)).astype(np.float32)
    jeng = JEngine(jm, params, input_shape=(FEATS,), buckets=(8, 32),
                   mesh=jmesh8, max_wait_ms=3.0)
    try:
        want = np.stack([f.result(timeout=60)
                         for f in jeng.submit_many(x)])
    finally:
        jeng.shutdown()
    with ServingEngine(tm, (FEATS,), buckets=(8, 32), mesh=tmesh8,
                       max_wait_ms=3.0) as eng:
        got = np.stack([f.result(timeout=60) for f in eng.submit_many(x)])
        assert eng.compiled_buckets == (8, 32) and eng.captures == 16
        assert len(eng.devices) == 8 and len(eng._banks) == 1
        eng.swap_weights({k: v * 0 for k, v in eng.params.items()}, 1)
        zero = np.stack([f.result(timeout=60)
                         for f in eng.submit_many(x)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # every shard serves the swapped weights (a zeroed MLP's logits are 0)
    assert not np.any(zero)


def test_model_predictor_on_mesh_matches_jax(served):
    """Scoring sharded over 4 worker devices equals JAX's mesh
    predictor's column, padded tail included."""
    jm, params, tm = served
    x = np.random.default_rng(5).normal(size=(37, FEATS)).astype(np.float32)
    want = jdk.ModelPredictor(jm, params, batch_size=4,
                              mesh=jmesh.make_mesh(num_workers=4)).predict(
        jdk.Dataset({"features": x}))["prediction"]
    got = tdk.ModelPredictor(tm, batch_size=4,
                             mesh=Mesh(["cpu"] * 4)).predict(
        tdk.Dataset.from_arrays(features=x))["prediction"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


# -- the native batcher and the compat layer ----------------------------------

def test_native_batcher_contracts_match_jax():
    """JAX's tests/test_native.py contracts on the port's copy: the
    library builds, gathers equal NumPy's for every dtype and row shape,
    bounds are checked, the permutation is valid, seeded and equal to
    the JAX library's (one source), and the shuffle gathers the rows
    JAX's does."""
    from distkeras_tpu.data import native as jnative
    from distkeras_tpu_torch.data import native

    assert native.available()
    rng = np.random.default_rng(0)
    for shape, dtype in [((1000, 784), np.float32), ((257, 3, 5), np.int32),
                         ((64,), np.float64)]:
        src = (rng.standard_normal(shape) * 100).astype(dtype)
        idx = rng.integers(0, shape[0], 513).astype(np.int64)
        out = native.gather_rows(src, idx)
        np.testing.assert_array_equal(out, src[idx])
        assert out.dtype == src.dtype
    src = np.zeros((10, 4), np.float32)
    for bad in ([0, 10], [-1]):
        with pytest.raises(IndexError):
            native.gather_rows(src, np.array(bad, np.int64))
    p1 = native.permutation(10_001, seed=42)
    np.testing.assert_array_equal(p1, native.permutation(10_001, seed=42))
    assert not np.array_equal(p1, native.permutation(10_001, seed=43))
    np.testing.assert_array_equal(np.sort(p1), np.arange(10_001))
    if jnative.available():
        np.testing.assert_array_equal(p1, jnative.permutation(10_001, 42))
    a = tdk.synthetic_mnist(n=512).shuffle(7)
    b = jdk.synthetic_mnist(n=512).shuffle(7)
    for col in ("features", "label"):
        np.testing.assert_array_equal(a[col], b[col])


def test_compat_helpers_match_jax():
    from distkeras_tpu.utils import compat as jcompat
    from distkeras_tpu_torch.utils import compat

    assert set(compat.__all__) == {
        n for n in vars(jcompat) if not n.startswith("_")
        and callable(getattr(jcompat, n)) and n not in (
            "TYPE_CHECKING", "Optional", "Sequence", "annotations")}
    ds_t, ds_j = tdk.synthetic_mnist(n=64), jdk.synthetic_mnist(n=64)
    np.testing.assert_array_equal(compat.shuffle(ds_t, 3)["features"],
                                  jcompat.shuffle(ds_j, 3)["features"])
    assert compat.precache(ds_t) is ds_t
    row = {"a": 1}
    assert compat.new_dataframe_row(row, "b", 2) == \
        jcompat.new_dataframe_row(row, "b", 2) and row == {"a": 1}
    np.testing.assert_array_equal(compat.to_dense_vector(3, 5),
                                  jcompat.to_dense_vector(3, 5))
    assert compat.to_dense_vector(3, 5).dtype == np.float32
    hist = [{"loss": 1.0, "acc": 0.5}, {"loss": 3.0, "acc": 0.25}]
    assert compat.history_executors_average(hist) == \
        jcompat.history_executors_average(hist)
    assert compat.history_executors_average([]) == {}
    assert compat.set_keras_base_directory("x") is None
    assert compat.get_os_username() == jcompat.get_os_username()
    model = MLP(features=(4,))
    blob = compat.serialize_keras_model(model)
    back, params = compat.deserialize_keras_model(blob)
    assert type(back) is MLP and back.features == model.features
    assert all(torch.equal(a, b) for a, b in zip(
        back.state_dict().values(), model.state_dict().values()))
    w = compat.uniform_weights(dict(model.named_parameters()), 0)
    assert all(((v >= -0.5) & (v <= 0.5)).all() for v in w.values())
