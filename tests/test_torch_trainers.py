"""The port's trainer zoo against the JAX package's trainers.

Every trainer (DOWNPOUR, ADAG, DynSGD, AEASGD, EAMSGD, Averaging,
Ensemble, Single) trains ``MLP(features=(16,))`` on
``synthetic_mnist(n=512)`` for 2 epochs, shuffled, in both packages
from the same start: JAX initializes from ``jax.random.key(0)`` and the
port's module is loaded with those params through the bridge (Ensemble's
K members with JAX's K inits). JAX runs K = 4 workers on 4 virtual CPU
devices, the port K = 4 replicas on ``device="cpu"``
(``parallelism_factor=4``). Bounds: final parameters rtol 1e-4 / atol
1e-5, every history entry rtol 1e-4 / atol 1e-5, ``staleness_history``
and ``num_updates`` equal. The JAX runs are built once a module.

Then: Averaging on identical shards equals Single; Ensemble returns K
distinct models; each sync-mode validation of
``tests/test_distributed_trainers.py`` raises the JAX package's
exception class in both packages; each path that is not ported raises
NotImplementedError naming its ROADMAP.md Queue A item;
``mode="host_async"`` runs in one process as JAX's does (a K = 2 run's
commit count, history length and staleness count equal JAX's; the fleet
kwargs ``ps_shards``, ``ps_standby`` and ``ps_placement`` are accepted
with JAX's attributes); and the twin of
``examples/mnist_mlp.py`` at ``n=1024`` (each exchanging trainer at the
example's kwargs; EAMSGD, which refuses ``worker_optimizer`` in both
packages, at its default) scores within 0.5 percentage points of JAX's
accuracy.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as tdk
from distkeras_tpu.models.mlp import MLP as JMLP
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.parallel import distributed as tdistributed
from distkeras_tpu_torch.parallel import pipeline as tpipeline
from distkeras_tpu_torch.parallel import sequence as tsequence
from distkeras_tpu_torch.utils import bridge

K = 4
COMMON = dict(learning_rate=0.05, batch_size=16, num_epoch=2)
ZOO = {  # name -> (extra kwargs, worker optimizer)
    "DOWNPOUR": ({}, "momentum"),
    "ADAG": ({"staging_rounds": 1}, "sgd"),
    "DynSGD": ({}, "sgd"),
    "AEASGD": ({"rho": 1.0}, "sgd"),
    "EAMSGD": ({"rho": 1.0, "momentum": 0.9}, "sgd"),
    "AveragingTrainer": ({}, "sgd"),
    "EnsembleTrainer": ({}, "sgd"),
    "SingleTrainer": ({}, "adagrad"),
}


def _flax(params):
    return jax.tree.map(np.asarray, params)


def _ensemble_inits():
    keys = jax.random.split(jax.random.key(0), K)
    sample = np.zeros((1, 784), np.float32)
    return [_flax(JMLP(features=(16,)).init(k, sample)["params"])
            for k in keys]


@pytest.fixture(scope="module")
def jax_zoo():
    """name -> (trainer, final params as flax numpy trees)."""
    ds = jdk.synthetic_mnist(n=512)
    out = {}
    for name, (extra, opt) in ZOO.items():
        kw = dict(COMMON, worker_optimizer=opt, **extra)
        if name != "SingleTrainer":
            kw.update(num_workers=K, communication_window=3)
        trainer = getattr(jdk, name)(JMLP(features=(16,)), **kw)
        params = trainer.train(ds, shuffle=True)
        out[name] = (trainer, [_flax(p) for p in params]
                     if isinstance(params, list) else _flax(params))
    return out


def _start():
    sample = np.zeros((1, 784), np.float32)
    return _flax(JMLP(features=(16,)).init(jax.random.key(0),
                                           sample)["params"])


def _port_trainer(name, **over):
    extra, opt = ZOO[name]
    kw = dict(COMMON, worker_optimizer=opt, device="cpu", **extra)
    if name != "SingleTrainer":
        kw.update(num_workers=1, parallelism_factor=K,
                  communication_window=3)
    kw.update(over)
    model = bridge.load_flax_params(MLP(features=(16,)), _start())
    return getattr(tdk, name)(model, **kw)


def _close_tree(port_params, flax_params):
    got = bridge.state_dict_to_flax(port_params)
    for mod, leaves in flax_params.items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(got[mod][leaf], want, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{mod}/{leaf}")


@pytest.mark.parametrize("name", sorted(ZOO))
def test_trainer_matches_jax(jax_zoo, name, monkeypatch):
    jtrainer, jparams = jax_zoo[name]
    trainer = _port_trainer(name)
    if name == "EnsembleTrainer":
        inits = [bridge.flax_to_state_dict(p) for p in _ensemble_inits()]
        monkeypatch.setattr(trainer, "_member_params", lambda: inits)
    params = trainer.train(tdk.synthetic_mnist(n=512), shuffle=True)
    if name == "EnsembleTrainer":
        assert isinstance(params, list) and len(params) == K
        for p, jp in zip(params, jparams):
            _close_tree(p, jp)
    else:
        _close_tree(params, jparams)
    assert len(trainer.history) == len(jtrainer.history) > 0
    for got, want in zip(trainer.history, jtrainer.history):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-5, err_msg=key)
    if name != "SingleTrainer":
        assert trainer.staleness_history == jtrainer.staleness_history
        assert trainer.num_updates == jtrainer.num_updates
    # the trained weights are what trainer.model now holds
    held = params[0] if name == "EnsembleTrainer" else params
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p.detach(), held[n])
    assert trainer.get_training_time() > 0


def test_averaging_identical_shards_equals_single():
    """NUMERICS invariant 6: identical shards -> the mean is each
    replica."""
    block = tdk.synthetic_mnist(n=128, seed=2)
    tiled = tdk.Dataset.concat([block] * K)
    kw = dict(learning_rate=0.05, batch_size=32, num_epoch=1, metrics=(),
              device="cpu")
    start = MLP(features=(16,)).state_dict()
    avg = tdk.AveragingTrainer(MLP(features=(16,)), num_workers=1,
                               parallelism_factor=K, communication_window=1,
                               **kw)
    avg.model.load_state_dict(start)
    single = tdk.SingleTrainer(MLP(features=(16,)), **kw)
    single.model.load_state_dict(start)
    p_avg, p_single = avg.train(tiled), single.train(block)
    for n in p_avg:
        torch.testing.assert_close(p_avg[n], p_single[n], rtol=1e-4,
                                   atol=1e-5)


def test_ensemble_returns_k_distinct_models():
    t = tdk.EnsembleTrainer(MLP(features=(16,)), num_workers=1,
                            parallelism_factor=K, communication_window=2,
                            batch_size=16, device="cpu")
    models = t.train(tdk.synthetic_mnist(n=512, seed=3))
    assert isinstance(models, list) and len(models) == K
    assert not torch.allclose(models[0]["dense_0.weight"],
                              models[1]["dense_0.weight"])


def test_dynsgd_staleness_rotates_and_retrain_resets_bookkeeping():
    t = tdk.DynSGD(MLP(features=(16,)), num_workers=1, parallelism_factor=8,
                   communication_window=2, batch_size=16, device="cpu")
    ds = tdk.synthetic_mnist(n=1024, seed=1)
    t.train(ds)
    # mean staleness over a full rotation is (K-1)/2 every round
    assert np.allclose(t.staleness_history, 3.5)
    first = (len(t.get_history()), t.num_updates, len(t.staleness_history))
    t.train(ds)
    assert (len(t.get_history()), t.num_updates,
            len(t.staleness_history)) == first
    assert set(t.get_averaged_history()) == {"loss", "accuracy"}


def test_dropout_model_trains_and_is_reproducible():
    ds = tdk.synthetic_mnist(n=1024, seed=4)

    def run():
        torch.manual_seed(0)
        t = tdk.DOWNPOUR(MLP(features=(32,), dropout_rate=0.3),
                         num_workers=1, parallelism_factor=4,
                         communication_window=2, batch_size=16,
                         device="cpu")
        t.train(ds)
        return [h["loss"] for h in t.get_history()]

    a, b = run(), run()
    assert a == b and np.isfinite(a[-1])


# -- validation: the JAX package's exception class, in both packages -------

def _jmodel():
    return JMLP(features=(8,))


def _tmodel():
    return MLP(features=(8,))


SYNC_ERRORS = [  # (trainer, kwargs, exception, message fragment)
    ("ADAG", dict(data_layout="bogus"), ValueError, "data_layout"),
    ("EAMSGD", dict(worker_optimizer="adam"), ValueError,
     "worker_optimizer"),
    ("DOWNPOUR", dict(rho=2.0), TypeError, "does not take"),
    ("AEASGD", dict(momentum=0.5), TypeError, "does not take"),
    ("DOWNPOUR", dict(mode="bogus"), ValueError, "mode"),
    ("DOWNPOUR", dict(parallelism_factor=0), ValueError,
     "parallelism_factor"),
    ("DOWNPOUR", dict(devices=["x"]), ValueError, "devices="),
    ("DOWNPOUR", dict(checkpoint_folds=2), ValueError, "checkpoint_folds"),
    ("DOWNPOUR", dict(data_service="localhost:1"), ValueError,
     "data_service"),
    ("DOWNPOUR", dict(codec="int8"), ValueError, "codec"),
    ("DOWNPOUR", dict(comms_overlap=True), ValueError, "comms_overlap"),
    ("DOWNPOUR", dict(ps_shards=0), ValueError, "ps_shards"),
    ("DOWNPOUR", dict(ps_shards=2), ValueError, "ps_shards"),
    ("DOWNPOUR", dict(ps_placement="moon"), ValueError, "ps_placement"),
    ("DOWNPOUR", dict(ps_placement="spread"), ValueError, "ps_placement"),
    ("DOWNPOUR", dict(ps_standby=True), ValueError, "ps_standby"),
    ("DOWNPOUR", dict(accum_steps=0), ValueError, "accum_steps"),
    ("DOWNPOUR", dict(accum_steps=3), ValueError, "accum_steps"),
    ("DOWNPOUR", dict(bucket_bytes=0), ValueError, "bucket_bytes"),
    ("DOWNPOUR", dict(loss_weights=[1.0, 2.0]), ValueError, "loss_weights"),
    ("DOWNPOUR", dict(loss="hinge"), ValueError, "Unknown loss"),
    ("DOWNPOUR", dict(worker_optimizer="sgdw"), ValueError,
     "Unknown optimizer"),
    ("DOWNPOUR", dict(health="shout"), ValueError, "health policy"),
]


@pytest.mark.parametrize("name,kw,exc,match", SYNC_ERRORS)
def test_sync_validation_raises_like_jax(name, kw, exc, match):
    base = dict(batch_size=16)
    with pytest.raises(exc, match=match):
        getattr(jdk, name)(_jmodel(), num_workers=2, **base, **kw)
    place = dict(num_workers=1, parallelism_factor=2, device="cpu")
    place.update(kw)
    with pytest.raises(exc, match=match):
        getattr(tdk, name)(_tmodel(), **base, **place)


def test_dataset_too_small_and_master_port_like_jax():
    for pkg, model, place in ((jdk, _jmodel(), dict(num_workers=8)),
                              (tdk, _tmodel(), dict(num_workers=1,
                                                    parallelism_factor=8,
                                                    device="cpu"))):
        t = pkg.DOWNPOUR(model, batch_size=32, communication_window=2,
                         **place)
        with pytest.raises(ValueError, match="rows but one step needs"):
            t.train(pkg.synthetic_mnist(n=100, seed=0))
        assert pkg.DOWNPOUR(model, master_port=5000, **place).num_workers \
            == 8


@contextlib.contextmanager
def _rank0_of_two():
    """What looks like rank 0 of a two-process ``torch.distributed``
    group."""
    from unittest import mock

    with mock.patch.object(torch.distributed, "is_initialized",
                           lambda: True), \
            mock.patch.object(torch.distributed, "get_world_size",
                              lambda: 2), \
            mock.patch.object(torch.distributed, "get_rank", lambda: 0):
        yield


def _multi_process(build):
    """``build()`` inside what looks like a two-process
    ``torch.distributed`` group, as its rank 0."""
    def run():
        with _rank0_of_two():
            return build()
    return run


@contextlib.contextmanager
def _rank0_of(world):
    """What looks like rank 0 of a ``world``-process group."""
    from unittest import mock

    with mock.patch.object(torch.distributed, "is_initialized",
                           lambda: True), \
            mock.patch.object(torch.distributed, "get_world_size",
                              lambda: world), \
            mock.patch.object(torch.distributed, "get_rank", lambda: 0):
        yield


def _fold_choice(uuids, device="cuda:0", new_group=None):
    """``fold_group(device)`` twice as rank 0 of ``len(uuids)`` ranks
    whose cards have ``uuids`` (rank 0's first): ``(group, backend,
    new_group's calls, the payload rank 0 gathered, the all-reduces that
    formed the group as (current card, tensor's device, group))``."""
    from unittest import mock

    rows = np.stack([tdistributed.encode_payload(u) for u in uuids])
    calls, sent, reduces, current = [], [], [], [None]
    zeros = torch.zeros

    def gather(value):
        sent.append(tdistributed.decode_payload(value))
        return rows

    def group(**kw):
        calls.append((current[0], kw))
        return "nccl-group"

    @contextlib.contextmanager
    def on_card(index):
        current[0] = index
        try:
            yield
        finally:
            current[0] = None

    def set_device(index):
        raise AssertionError("fold_group moved the current card")

    def zeros_on(*shape, device=None, **kw):  # a card tensor, on the CPU
        t = zeros(*shape, **kw)
        t.card = torch.device(device)
        return t

    def all_reduce(t, group=None):
        reduces.append((current[0], t.card, group))

    tdistributed._CARDS.clear()
    try:
        with _rank0_of(len(uuids)), \
                mock.patch.object(tdistributed, "_require_gloo",
                                  lambda: None), \
                mock.patch.object(tdistributed, "process_allgather", gather), \
                mock.patch.object(tdistributed, "card_uuid",
                                  lambda index: uuids[0]), \
                mock.patch.object(torch.cuda, "set_device", set_device), \
                mock.patch.object(torch.cuda, "device", on_card), \
                mock.patch.object(torch, "zeros", zeros_on), \
                mock.patch.object(torch.distributed, "all_reduce",
                                  all_reduce), \
                mock.patch.object(torch.distributed, "new_group",
                                  new_group or group):
            got = tdistributed.fold_group(torch.device(device))
            # the choice is made once: no second gather, no second group
            assert tdistributed.fold_group(torch.device(device)) == got
        return (*got, calls, sent, reduces)
    finally:
        tdistributed._CARDS.clear()


FOLD_CHOICES = {  # name -> (uuids of ranks 0.., backend)
    # every rank on a card of its own: one NCCL group beside gloo's
    "distinct_cards": (["GPU-a", "GPU-b", "GPU-c", "GPU-d"], "nccl"),
    # two ranks on one card: gloo through the host (NCCL refuses it)
    "one_shared_card": (["GPU-a", "GPU-a"], "gloo"),
    # two of four ranks share a card: the whole layout stays on gloo
    "two_of_four_share": (["GPU-a", "GPU-b", "GPU-c", "GPU-c"], "gloo"),
    # CUDA_VISIBLE_DEVICES=i gives every rank index 0: the UUIDs differ
    "same_index_two_cards": (["GPU-0-host-a", "GPU-0-host-b"], "nccl"),
}


@pytest.mark.parametrize("name", sorted(FOLD_CHOICES))
def test_fold_group_chooses_nccl_exactly_for_distinct_cards(name):
    """``fold_group`` of a card tensor all-gathers each rank's card UUID
    once and makes one ``new_group(backend="nccl")``, with the group's
    timeout, exactly when every rank's card is its own, and forms it at
    once with one all-reduce on the card, every rank joining (so that a
    hop between two ranks is never the group's first NCCL call); both
    under the card as the current device, and the process's current
    card is not moved. Ranks that share a card fold over gloo. Two ranks
    whose cards are both ``cuda:0`` (each under its own
    ``CUDA_VISIBLE_DEVICES``) are told apart by UUID, not by index."""
    import datetime

    uuids, backend = FOLD_CHOICES[name]
    group, got, calls, sent, reduces = _fold_choice(uuids, device="cuda:1")
    assert got == backend
    assert sent == [uuids[0]]  # the card's UUID, not hostname|index
    if backend == "nccl":
        assert group == "nccl-group"
        assert calls == [(1, {"backend": "nccl",
                              "timeout": datetime.timedelta(
                                  seconds=tdistributed._TIMEOUT["s"])})]
        assert reduces == [(1, torch.device("cuda:1"), "nccl-group")]
    else:
        assert group is None and calls == [] and reduces == []


def test_fold_group_raises_when_the_nccl_group_fails():
    """A group that fails to form raises on the rank: nothing falls back
    to gloo or to the host."""
    def refuse(**kw):
        raise RuntimeError("NCCL error: unhandled system error")

    with pytest.raises(RuntimeError, match="NCCL error"):
        _fold_choice(["GPU-a", "GPU-b"], new_group=refuse)
    tdistributed._CARDS.clear()


def _eight_cpus(monkeypatch):
    from distkeras_tpu_torch import device as tdevice

    cpus = [torch.device("cpu")] * 8
    monkeypatch.setattr(tdevice, "visible_devices", lambda: list(cpus))
    return cpus


def test_default_meshes_take_every_device_as_jax_does(monkeypatch):
    """With eight visible devices (conftest's eight CPU devices for JAX,
    ``visible_devices`` patched to eight for the port) the default
    meshes have JAX's shapes: ``make_mesh()`` 8 workers, at model 2 four
    rows of two, ``make_sp_mesh(2, 4)`` and ``make_pp_mesh(4)``."""
    from distkeras_tpu.parallel import mesh as jmesh
    from distkeras_tpu.parallel import pipeline as jpipeline
    from distkeras_tpu.parallel import sequence as jsequence
    from distkeras_tpu_torch.parallel import mesh as tmesh

    assert len(jax.devices()) == 8
    _eight_cpus(monkeypatch)
    for port, ref in ((tmesh.make_mesh(), jmesh.make_mesh()),
                      (tmesh.make_mesh(model_parallelism=2),
                       jmesh.make_mesh(model_parallelism=2)),
                      (tsequence.make_sp_mesh(2, 4),
                       jsequence.make_sp_mesh(2, 4))):
        assert port.shape == dict(ref.shape)
    assert tpipeline.make_pp_mesh(4).shape == {
        "workers": 1, "stages": dict(jpipeline.make_pp_mesh(4).shape)[
            jpipeline.STAGE_AXIS]}
    with pytest.raises(ValueError, match="only 8 are visible"):
        tmesh.make_mesh(num_workers=9)


def test_default_trainers_place_workers_on_every_device(monkeypatch):
    """``DistributedTrainer`` in sync mode takes ``make_mesh(num_workers)``
    over the visible devices, and under ``mode="host_async"`` its
    workers' devices are all of them (JAX's ``jax.local_devices()``),
    worker ``k`` on ``devices[k % 8]``; ``device=`` still names one."""
    cpus = _eight_cpus(monkeypatch)
    t = tdk.ADAG(_tmodel(), num_workers=4, batch_size=8)
    assert t.mesh.shape == {"workers": 4, "model": 1} and t.num_workers == 4
    t = tdk.ADAG(_tmodel(), mode="host_async", num_workers=8, batch_size=8)
    assert t.devices == cpus and len(t.devices) == len(jax.local_devices())
    t = tdk.ADAG(_tmodel(), mode="host_async", num_workers=2, batch_size=8,
                 device="cpu")
    assert t.devices == [torch.device("cpu")]


def test_visible_devices_one_process_and_in_a_group(monkeypatch):
    """``visible_devices``: every card in order in one process (``[cuda:0]``
    on a one-card host), this process's card in a group, where the
    default meshes then lay one card a process end to end."""
    from distkeras_tpu_torch.device import visible_devices
    from distkeras_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert visible_devices() == [torch.device("cuda:0")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert visible_devices() == [torch.device("cuda", i) for i in range(4)]
    assert tmesh.make_mesh().shape == {"workers": 4, "model": 1}
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    with _rank0_of(4):
        assert visible_devices() == [torch.device("cuda:2")]
        mesh = tmesh.make_mesh()
        assert mesh.shape == {"workers": 4, "model": 1}
        assert mesh.device_owners == [[0], [1], [2], [3]]
        assert mesh.home == torch.device("cuda:2")
        assert tpipeline.make_pp_mesh(4).device_owners == [[0, 1, 2, 3]]
        assert tsequence.make_sp_mesh(1, 4).shape == {"workers": 1,
                                                      "seq": 4}


def _ring_step():
    """``build_sp_train_step`` over one row of two sequence shards, one a
    process: the fns and this process's placed blocks."""
    from distkeras_tpu_torch.models import gpt
    from distkeras_tpu_torch.ops import optimizers

    mesh = tsequence.make_sp_mesh(1, 2, devices=["cpu"])
    fns = tsequence.build_sp_train_step(gpt.gpt_tiny(attention="ring"),
                                        optimizers.get("sgd", 0.1), mesh)
    ids = np.zeros((2, 16), np.int32)
    return mesh, fns[2]({"input_ids": ids, "labels": ids})


def _ring_state():
    from distkeras_tpu_torch.models import gpt
    from distkeras_tpu_torch.ops import optimizers

    mesh = tsequence.make_sp_mesh(1, 2, devices=["cpu"])
    return mesh, tsequence.init_sp_state(gpt.gpt_tiny(attention="ring"),
                                         optimizers.get("sgd", 0.1), mesh)


SPANNING = [  # (build -> (mesh, extra), shape, device owners, rank 0's rows)
    # the objects whose construction raised across processes before the
    # model, sequence and pipeline axes spanned them (item 16 part 4),
    # built as rank 0 of a two-process group
    (lambda: (tsequence.make_sp_mesh(devices=["cpu"]), None),
     {"workers": 1, "seq": 1}, [[0]], [0]),
    (lambda: (tpipeline.make_pp_mesh(1, devices=["cpu"]), None),
     {"workers": 1, "stages": 1}, [[0]], [0]),
    (_ring_step, {"workers": 1, "seq": 2}, [[0, 1]], [0]),
    (lambda: (tdk.parallel.mesh.make_mesh(
        devices=["cpu"] * 2, model_parallelism=2), None),
     {"workers": 2, "model": 2}, [[0, 0], [1, 1]], [0]),
    (lambda: (tdistributed.multihost_mesh(
        1, model_parallelism=2, devices=["cpu"]), None),
     {"workers": 1, "model": 2}, [[0, 1]], [0]),
    (lambda: (tdk.PjitTrainer(_tmodel(), device="cpu", num_workers=2,
                              model_parallelism=2, batch_size=32).mesh,
              None), {"workers": 2, "model": 2}, [[0, 0], [1, 1]], [0]),
    (_ring_state, {"workers": 1, "seq": 2}, [[0, 1]], [0]),
]


@pytest.mark.parametrize("case", range(len(SPANNING)))
def test_spanning_objects_build_in_a_group(case):
    """Each object builds as rank 0 of a (faked) two-process group with
    every process's devices laid end to end: its mesh's shape, each
    device's owner, each row's lead and the rows rank 0 runs; a sequence
    row over both ranks places rank 1's block as a ``Remote``, and its
    state lives on rank 0's home."""
    from distkeras_tpu_torch.ops.ring_attention import Remote
    from distkeras_tpu_torch.parallel import mesh as tmesh

    build, shape, owners, rows = SPANNING[case]
    mesh, extra = _multi_process(build)()
    assert mesh.shape == shape
    assert mesh.device_owners == owners
    assert mesh.owners == [row[0] for row in owners]
    with _rank0_of_two():
        assert tmesh.local_worker_positions(mesh) == rows
        assert mesh.home == torch.device("cpu")
    if isinstance(extra, dict):  # placed blocks: rank 1's is Remote
        row = extra["input_ids"][0]
        assert isinstance(row[0], torch.Tensor) and row[0].shape == (2, 8)
        assert isinstance(row[1], Remote) and row[1].rank == 1
    elif extra is not None:  # the state's module on rank 0's home
        assert next(extra.model.parameters()).device == mesh.home


def _mlm_rows(n=32, t=16, vocab=128):
    rng = np.random.default_rng(0)
    ids = rng.integers(1, vocab, (n, t)).astype(np.int32)
    labels = np.where(rng.random((n, t)) < 0.15, ids, -1).astype(np.int32)
    return tdk.Dataset.from_arrays(features=ids, label=labels)


NOW_PORTED = {  # name -> (build, dataset): paths that raised before
    # a trainer's precision= on a built model re-stamps it (item 12)
    "single_bf16": (lambda: tdk.SingleTrainer(
        _tmodel(), device="cpu", precision="bf16", batch_size=32),
        lambda: tdk.synthetic_mnist(n=64)),
    "adag_bf16": (lambda: tdk.ADAG(
        _tmodel(), num_workers=1, device="cpu", precision="bf16",
        batch_size=16, communication_window=2),
        lambda: tdk.synthetic_mnist(n=64)),
    "dynsgd_bert_int8": (lambda: tdk.DynSGD(
        tdk.models.bert_tiny(vocab_size=128), num_workers=1, device="cpu",
        precision="int8", loss="masked_lm", metrics=(), batch_size=8,
        communication_window=2), _mlm_rows),
    # the workers x model mesh, PjitTrainer and sharded scoring (item 16)
    "model_predictor_mesh": (lambda: tdk.ModelPredictor(
        _tmodel(), mesh=tdk.parallel.mesh.Mesh(["cpu", "cpu"]),
        batch_size=8), lambda: tdk.synthetic_mnist(n=20)),
    "make_mesh_model_2": (lambda: tdk.PjitTrainer(
        _tmodel(), batch_size=32, mesh=tdk.parallel.mesh.make_mesh(
            devices=["cpu"] * 2, model_parallelism=2)),
        lambda: tdk.synthetic_mnist(n=64)),
    "pjit_trainer": (lambda: tdk.PjitTrainer(
        _tmodel(), device="cpu", num_workers=2, batch_size=32),
        lambda: tdk.synthetic_mnist(n=64)),
    # the one-process data plane: host_async workers fed by a data
    # service (item 19)
    "data_service": (lambda: tdk.DOWNPOUR(
        _tmodel(), num_workers=1, device="cpu", mode="host_async",
        batch_size=16, communication_window=2,
        data_service=_started_coordinator(tdk.synthetic_mnist(n=64))),
        lambda: None),
}


def _started_coordinator(ds):
    from distkeras_tpu_torch.data.service import DataCoordinator

    coord = DataCoordinator(dataset=ds, range_size=32)
    coord.start()
    return coord


@pytest.mark.parametrize("name", sorted(NOW_PORTED))
def test_ported_paths_build_and_step(name):
    """Each path that raised NotImplementedError before builds and runs
    on the CPU: a trainer trains (finite losses; a re-stamped model
    carries the policy), a predictor scores every row."""
    build, data = NOW_PORTED[name]
    built, ds = build(), data()
    service = getattr(built, "data_service", None)
    if service is not None:
        try:
            built.train(ds)
        finally:
            service.stop()
        assert len(built.get_history()) == 64 // 16
        assert list(service.cursor_carry()) == [1, service.num_ranges]
        return
    if isinstance(built, tdk.ModelPredictor):
        out = built.predict(ds)["prediction"]
        assert out.shape == (len(ds), 10) and np.isfinite(out).all()
        assert [d.type for d in built.devices] == ["cpu", "cpu"]
        return
    built.train(ds)
    losses = [h["loss"] for h in built.get_history()]
    assert losses and np.isfinite(losses).all()
    if built.precision is not None:
        assert built.model.precision == built.precision
    if name == "make_mesh_model_2":
        assert built.mesh.shape == {"workers": 1, "model": 2}


def test_host_async_plain_run_counts_like_jax():
    """DOWNPOUR ``mode="host_async"`` with K = 2 threads: every scheduled
    window commits once, in both packages (the clock counts commits, the
    history holds every step, one staleness sample a commit), and the
    loss is finite. Thread interleaving differs between runs, so values
    are not compared; the K = 1 runner is held to JAX's in
    tests/test_torch_host_async.py."""
    kw = dict(mode="host_async", num_workers=2, batch_size=16,
              communication_window=2, learning_rate=0.05,
              worker_optimizer="sgd", metrics=("accuracy",))
    out = {}
    for pkg, model, place in ((jdk, _jmodel(), {}),
                              (tdk, _tmodel(), dict(device="cpu"))):
        t = pkg.DOWNPOUR(model, **kw, **place)
        t.train(pkg.synthetic_mnist(n=256))
        out[pkg.__name__] = (t.num_updates, len(t.get_history()),
                             len(t.staleness_history),
                             sorted(t.get_history()[0]))
        assert all(np.isfinite(h["loss"]) for h in t.get_history())
    assert out["distkeras_tpu"] == out["distkeras_tpu_torch"] == (
        8, 16, 8, ["accuracy", "loss"])


@pytest.mark.parametrize("kw", [dict(ps_shards=2), dict(ps_standby=True),
                                dict(ps_placement="spread")])
def test_host_async_fleet_kwargs_accepted_like_jax(kw):
    """In one process the JAX trainer validates the fleet kwargs and runs
    one in-process server; the port keeps the same attributes."""
    attrs = ("ps_shards", "ps_standby", "ps_placement", "num_workers",
             "mode", "codec", "comms_overlap")
    j = jdk.DOWNPOUR(_jmodel(), mode="host_async", num_workers=2, **kw)
    t = tdk.DOWNPOUR(_tmodel(), mode="host_async", num_workers=2,
                     device="cpu", **kw)
    assert [getattr(t, a) for a in attrs] == [getattr(j, a) for a in attrs]


@pytest.mark.parametrize("trainer", ["SingleTrainer", "PjitTrainer",
                                     "replicated"])
def test_global_shards_are_refused(tmp_path, trainer):
    """JAX's rejections: the trainers that consume row streams refuse a
    pool and name ``data_layout='host_sharded'``, where a pool is
    re-dealt; so does a DistributedTrainer under ``"replicated"``."""
    from distkeras_tpu_torch.data.global_shards import GlobalShards

    np.save(tmp_path / "f.npy", np.zeros((64, 784), np.float32))
    np.save(tmp_path / "l.npy", np.zeros((64, 10), np.float32))
    pool = GlobalShards({"features": [str(tmp_path / "f.npy")],
                         "label": [str(tmp_path / "l.npy")]})
    build = {
        "SingleTrainer": lambda: tdk.SingleTrainer(_tmodel(), device="cpu"),
        "PjitTrainer": lambda: tdk.PjitTrainer(_tmodel(), device="cpu"),
        "replicated": lambda: tdk.ADAG(_tmodel(), num_workers=1,
                                       device="cpu"),
    }[trainer]
    with pytest.raises(ValueError, match="host_sharded") as err:
        build().train(pool)
    assert "processes" not in str(err.value)


# -- the twin of examples/mnist_mlp.py -------------------------------------

def _example_flow(pkg, trainer_name, model, place, score_place):
    raw = pkg.synthetic_mnist(n=1024)
    ds = pkg.Pipeline([
        pkg.MinMaxTransformer(o_min=-1.0, o_max=1.0),
        pkg.OneHotTransformer(10, input_col="label_index",
                              output_col="label"),
    ]).transform(raw)
    # EAMSGD refuses worker_optimizer in both packages (its local step is
    # its own Nesterov rule), so it runs at the default
    opt = {} if trainer_name == "EAMSGD" else {"worker_optimizer": "momentum"}
    trainer = getattr(pkg, trainer_name)(
        model, learning_rate=0.3, batch_size=64, num_epoch=3,
        communication_window=4, **opt, **place)
    params = trainer.train(ds, shuffle=True)
    scored = pkg.ModelClassifier(model, params, batch_size=512,
                                 **score_place).predict(ds)
    return pkg.AccuracyEvaluator("prediction", "label_index").evaluate(
        scored)


@pytest.mark.parametrize("name", ["ADAG", "DOWNPOUR", "DynSGD", "AEASGD",
                                  "EAMSGD"])
def test_mnist_example_twin_matches_jax_accuracy(name):
    from distkeras_tpu.models import mnist_mlp as jmnist_mlp
    from distkeras_tpu_torch.models import mnist_mlp

    start = _flax(jmnist_mlp().init(jax.random.key(0),
                                    jnp.zeros((1, 784)))["params"])
    jacc = _example_flow(jdk, name, jmnist_mlp(), dict(num_workers=K), {})
    tacc = _example_flow(tdk, name,
                         bridge.load_flax_params(mnist_mlp(), start),
                         dict(num_workers=1, parallelism_factor=K,
                              device="cpu"), dict(device="cpu"))
    print(f"{name}: port {tacc:.4f}, JAX {jacc:.4f}")
    assert abs(tacc - jacc) <= 0.005, (tacc, jacc)


@pytest.mark.parametrize("name", ["ADAG", "SingleTrainer"])
def test_train_starts_from_the_module_weights(name):
    """The port trains from the weights the module holds (the JAX
    trainer initializes from ``jax.random.key(seed)``): at learning rate
    0 the result is the module's weights, whatever the seed."""
    model = MLP(features=(8,))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    place = dict(device="cpu", learning_rate=0.0, batch_size=16, seed=5)
    if name != "SingleTrainer":
        place.update(num_workers=1, parallelism_factor=2,
                     communication_window=2)
    params = getattr(tdk, name)(model, **place).train(
        tdk.synthetic_mnist(n=256))
    for n, p in before.items():
        assert torch.equal(params[n], p)


def test_host_sharded_layout_is_the_replicated_case_in_one_process():
    ds = tdk.synthetic_mnist(n=512)
    start = MLP(features=(8,)).state_dict()

    def run(layout):
        model = MLP(features=(8,))
        model.load_state_dict(start)
        t = tdk.ADAG(model, num_workers=1, parallelism_factor=2,
                     communication_window=2, batch_size=16, device="cpu",
                     data_layout=layout)
        return t.train(ds), [h["loss"] for h in t.history]

    (p_rep, h_rep), (p_hs, h_hs) = run("replicated"), run("host_sharded")
    assert h_rep == h_hs
    assert all(torch.equal(p_rep[n], p_hs[n]) for n in p_rep)
