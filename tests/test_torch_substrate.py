"""The port's substrate (``build_epoch_fn``) against the JAX package's.

The JAX epoch runs K = 4 workers on 4 virtual CPU devices; the port runs
the same 4 logical workers as 1 device x 4 stacked replicas and as 2
devices x 2 (a mesh that repeats ``cpu``). Both start from one flax init
(bridged into the port) and take the same staged data: 2 rounds of
window 3, batch 8 of ``synthetic_mnist`` through an
``MLP(features=(16,))``, one epoch at ``round_offset`` 0 and a second
over the same data at ``round_offset`` 2 (the staleness rotation
continues). Bounds (float32): center, every carry's parameters, loss,
accuracy and staleness within rtol 1e-5 / atol 1e-6. The JAX references
are built once a module.
"""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.data.dataset import synthetic_mnist as jsynthetic
from distkeras_tpu.models.mlp import MLP as JMLP
from distkeras_tpu.ops import optimizers as jopt
from distkeras_tpu.parallel import mesh as jmesh
from distkeras_tpu.parallel import strategies as jstrat
from distkeras_tpu.parallel import substrate as jsub
from distkeras_tpu_torch.data.dataset import synthetic_mnist
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.ops import optimizers as topt
from distkeras_tpu_torch.parallel import mesh as tmesh
from distkeras_tpu_torch.parallel import strategies as tstrat
from distkeras_tpu_torch.parallel import substrate as tsub
from distkeras_tpu_torch.utils import bridge

K, WINDOW, BATCH, ROUNDS, LR = 4, 3, 8, 2, 0.05
CASES = {  # name -> (strategy kwargs, worker optimizer, accum_steps)
    "downpour": ({}, "momentum", 1),
    "adag": ({}, "sgd", 1),
    "dynsgd": ({}, "sgd", 1),
    "aeasgd": ({"rho": 2.0}, "sgd", 1),
    "eamsgd": ({"rho": 2.0, "momentum": 0.9}, "sgd", 1),
    "independent": ({}, "sgd", 1),
    "adag_accum2": ({}, "sgd", 2),
}
LAYOUTS = {"1x4": 1, "2x2": 2}


def _strategy_name(case):
    return case.split("_")[0]


@pytest.fixture(scope="module")
def start():
    ds = jsynthetic(n=K * ROUNDS * WINDOW * BATCH, seed=7)
    params = JMLP(features=(16,)).init(jax.random.key(1),
                                       ds["features"][:1])["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_runs(start):
    """case -> [(center, carries' params, metrics) after each epoch],
    all numpy, from the JAX substrate on 4 devices."""
    ds = jsynthetic(n=K * ROUNDS * WINDOW * BATCH, seed=7)
    mesh = jmesh.make_mesh(K)
    data, rounds = jsub.stage_epoch_data(ds.repartition(K), "features",
                                         "label", BATCH, WINDOW, mesh)
    out = {}
    for case, (kw, opt, accum) in CASES.items():
        strategy = jstrat.get(_strategy_name(case), learning_rate=LR, **kw)
        tx = jopt.get(opt, LR)
        epoch = jsub.build_epoch_fn(JMLP(features=(16,)),
                                    "categorical_crossentropy", tx, strategy,
                                    mesh, K, WINDOW, ("accuracy",),
                                    accum_steps=accum)
        center, carries = jsub.init_center_and_carries(
            jax.tree.map(np.asarray, start), tx, strategy, mesh, K)
        results = []
        for offset in (0, ROUNDS):
            center, carries, ms = epoch(center, carries, data,
                                        np.int32(offset))
            # copies: the next call donates (and may overwrite) these
            results.append(jax.tree.map(np.array,
                                        (center, carries.params, ms)))
        out[case] = results
    return out


def _port_epochs(start, case, devices):
    kw, opt, accum = CASES[case]
    mesh = tmesh.make_mesh(devices=["cpu"] * devices)
    strategy = tstrat.get(_strategy_name(case), learning_rate=LR, **kw)
    tx = topt.get(opt, LR)
    model = bridge.load_flax_params(MLP(features=(16,)), start)
    epoch = tsub.build_epoch_fn(model, "categorical_crossentropy", tx,
                                strategy, mesh, K, WINDOW, ("accuracy",),
                                accum_steps=accum)
    center, carries = tsub.init_center_and_carries(
        bridge.flax_to_state_dict(start), tx, strategy, mesh, K)
    ds = synthetic_mnist(n=K * ROUNDS * WINDOW * BATCH, seed=7)
    data, rounds = tsub.stage_epoch_data(ds.repartition(K), "features",
                                         "label", BATCH, WINDOW, mesh)
    assert rounds == ROUNDS
    results = []
    for offset in (0, ROUNDS):
        center, carries, ms = epoch(center, carries, data, offset)
        # copies: the carries are updated in place by the next epoch
        results.append((center, [{n: t.detach().clone()
                                  for n, t in c.params.items()}
                                 for c in carries], ms))
    return results


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6,
                               err_msg=what)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_epoch_matches_jax(start, jax_runs, case, layout):
    port = _port_epochs(start, case, LAYOUTS[layout])
    for e, ((tc, tcarries, tms), (jc, jparams, jms)) in enumerate(
            zip(port, jax_runs[case])):
        center = bridge.state_dict_to_flax(tc)
        for mod in jc:
            for leaf in jc[mod]:
                _close(center[mod][leaf], jc[mod][leaf],
                       f"epoch {e} center {mod}/{leaf}")
        for k, params in enumerate(tcarries):
            flax = bridge.state_dict_to_flax(params)
            for mod in jparams:
                for leaf in jparams[mod]:
                    _close(flax[mod][leaf], jparams[mod][leaf][k],
                           f"epoch {e} worker {k} {mod}/{leaf}")
        assert set(tms) == set(jms) == {"loss", "accuracy", "staleness"}
        for name in jms:
            assert tuple(tms[name].shape) == jms[name].shape
            _close(tms[name].numpy(), jms[name], f"epoch {e} {name}")


def test_staleness_rotates_with_round_offset(start):
    port = _port_epochs(start, "dynsgd", 2)
    for e, (_, _, ms) in enumerate(port):
        want = [[(k + e * ROUNDS + r) % K for r in range(ROUNDS)]
                for k in range(K)]
        np.testing.assert_array_equal(ms["staleness"].numpy(), want)


def test_stage_epoch_chunks_equal_stage_epoch_data():
    ds = synthetic_mnist(n=K * 3 * WINDOW * BATCH + 5, seed=2)
    shards = ds.repartition(K)
    mesh = tmesh.make_mesh(devices=["cpu", "cpu"])
    whole, rounds = tsub.stage_epoch_data(shards, "features", "label",
                                          BATCH, WINDOW, mesh)
    assert rounds == 3
    chunks = list(tsub.stage_epoch_chunks(shards, "features", "label",
                                          BATCH, WINDOW, mesh,
                                          chunk_rounds=2))
    assert [c for _, c in chunks] == [2, 1]
    for key in ("features", "labels"):
        assert len(whole[key]) == 2
        for d in range(2):
            got = torch.cat([chunk[key][d] for chunk, _ in chunks])
            assert torch.equal(got, whole[key][d])
        assert tuple(whole[key][0].shape[:4]) == (3, 2, WINDOW, BATCH)


def test_staged_data_equals_jax_layout():
    """Round-major staging, split over the devices' replicas, is JAX's
    ``(rounds, workers, window, batch, ...)`` array bitwise."""
    jds = jsynthetic(n=K * ROUNDS * WINDOW * BATCH, seed=7)
    jdata, _ = jsub.stage_epoch_data(jds.repartition(K), "features",
                                     "label", BATCH, WINDOW,
                                     jmesh.make_mesh(K))
    ds = synthetic_mnist(n=K * ROUNDS * WINDOW * BATCH, seed=7)
    data, _ = tsub.stage_epoch_data(ds.repartition(K), "features", "label",
                                    BATCH, WINDOW,
                                    tmesh.make_mesh(devices=["cpu"] * 2))
    for key in ("features", "labels"):
        np.testing.assert_array_equal(torch.cat(data[key], dim=1).numpy(),
                                      np.asarray(jdata[key]))


def test_dropout_masks_differ_across_workers_and_steps_and_repeat():
    """Port only (dropout streams cannot match JAX's): with dropout 0.5,
    two runs from one seed give the same losses, every worker's first
    step a different loss, and a different seed other losses."""
    ds = synthetic_mnist(n=K * WINDOW * BATCH, seed=3)
    mesh = tmesh.make_mesh(devices=["cpu"])

    def run(seed):
        model = MLP(features=(16,), dropout_rate=0.5)
        torch.manual_seed(0)
        model.load_state_dict(MLP(features=(16,)).state_dict())
        model.train()
        strategy = tstrat.Independent()
        tx = topt.get("sgd", 0.0)
        epoch = tsub.build_epoch_fn(model, "categorical_crossentropy", tx,
                                    strategy, mesh, K, WINDOW,
                                    dropout_seed=seed)
        center, carries = tsub.init_center_and_carries(
            {n: p.detach() for n, p in model.named_parameters()}, tx,
            strategy, mesh, K)
        shards = _repeated_shards(ds, K)
        data, _ = tsub.stage_epoch_data(shards, "features", "label", BATCH,
                                        WINDOW, mesh)
        return epoch(center, carries, data, 0)[2]["loss"].numpy()

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # same weights (lr 0) and the same batch for every worker and step:
    # only the masks differ
    assert len(np.unique(a[:, 0, :])) == K * WINDOW


def _repeated_shards(ds, k):
    """The first window x batch rows of ``ds`` as ``k`` identical
    shards, each repeating one batch ``WINDOW`` times."""
    from distkeras_tpu_torch.data.dataset import Dataset

    one = ds.take(BATCH)
    return [Dataset.concat([one] * WINDOW) for _ in range(k)]


def test_epoch_fn_validation():
    mesh = tmesh.make_mesh(devices=["cpu", "cpu"])
    model = MLP(features=(4,))
    with pytest.raises(ValueError, match="multiple of the mesh"):
        tsub.build_epoch_fn(model, "categorical_crossentropy",
                            topt.get("sgd"), tstrat.ADAG(), mesh, 3, 2)
    with pytest.raises(ValueError, match="bucket_bytes"):
        tsub.build_epoch_fn(model, "categorical_crossentropy",
                            topt.get("sgd"), tstrat.ADAG(), mesh, 2, 2,
                            bucket_bytes=0)
    with pytest.raises(ValueError, match="cannot form"):
        next(tsub.stage_epoch_chunks(
            synthetic_mnist(n=20).repartition(2), "features", "label", 8, 2,
            mesh))
    with pytest.raises(ValueError, match="Mesh needs 3 devices"):
        tmesh.make_mesh(3, devices=["cpu", "cpu"])


def test_bucket_bytes_cannot_change_the_per_leaf_fold(start):
    """The JAX package splits its all-reduce into buckets; the port's
    fold sums leaf by leaf, so any bucket size gives the same bits."""
    mesh = tmesh.make_mesh(devices=["cpu", "cpu"])
    ds = synthetic_mnist(n=K * ROUNDS * WINDOW * BATCH, seed=7)
    data, _ = tsub.stage_epoch_data(ds.repartition(K), "features", "label",
                                    BATCH, WINDOW, mesh)
    outs = []
    for bucket in (None, 1024):
        model = bridge.load_flax_params(MLP(features=(16,)), start)
        tx, strategy = topt.get("sgd", LR), tstrat.DynSGD()
        epoch = tsub.build_epoch_fn(model, "categorical_crossentropy", tx,
                                    strategy, mesh, K, WINDOW,
                                    bucket_bytes=bucket)
        center, carries = tsub.init_center_and_carries(
            bridge.flax_to_state_dict(start), tx, strategy, mesh, K)
        outs.append(epoch(center, carries, data, 0)[0])
    assert all(torch.equal(outs[0][n], outs[1][n]) for n in outs[0])
