"""The port's ``GlobalShards`` against the JAX package's.

Twins of tests/test_global_shards.py's in-process tests (the
two-process demonstration is ROADMAP.md Queue A, item 16): the
per-epoch re-deal, the preserved global multiset, lazy views, the typed
validation errors, and the trainers re-resolving ``epoch_dataset`` each
epoch (sync and ``host_async``), on ``device="cpu"``. Side by side with
JAX, on the same seeded ``.npy`` shard files:

- ``epoch_assignment`` is identical for the same ``(seed, epoch,
  process_count)``, and ``epoch_dataset`` holds the same rows;
- with no ``torch.distributed`` group up, the process count and index
  are 1 and 0;
- ``ADAG`` over a pool under ``data_layout="host_sharded"`` gives JAX's
  history and final center from bridged weights: sync at K = 4
  (tests/test_torch_trainers.py's bounds, rtol 1e-4 / atol 1e-5) and
  ``host_async`` at K = 1 (rtol 1e-5 / atol 1e-6).
"""

import numpy as np
import pytest

from distkeras_tpu_torch.data.dataset import ShardedColumn
from distkeras_tpu_torch.data.global_shards import GlobalShards


def _write_pool(directory, shards=8, rows=64, width=4, seed=None):
    """``shards`` files of ``rows`` rows. Without a seed, rows are
    numbered globally for traceability (label = row number); with one,
    MNIST-shaped seeded features and one-hot labels."""
    feat_paths, lab_paths = [], []
    rng = None if seed is None else np.random.default_rng(seed)
    for i in range(shards):
        if rng is None:
            nums = np.arange(i * rows, (i + 1) * rows, dtype=np.float32)
            feats = np.repeat(nums[:, None], width, axis=1)
            labs = nums.astype(np.int32)
        else:
            feats = rng.standard_normal((rows, 784)).astype(np.float32)
            labs = np.eye(10, dtype=np.float32)[rng.integers(0, 10, rows)]
        fp, lp = directory / f"f{i}.npy", directory / f"l{i}.npy"
        np.save(fp, feats)
        np.save(lp, labs)
        feat_paths.append(str(fp))
        lab_paths.append(str(lp))
    return {"features": feat_paths, "label": lab_paths}


@pytest.fixture()
def pool(tmp_path):
    return GlobalShards(_write_pool(tmp_path), seed=3)


def test_assignment_re_deals_hosts_every_epoch(pool):
    a0 = pool.epoch_assignment(0, process_count=2)
    a1 = pool.epoch_assignment(1, process_count=2)
    assert a0 == pool.epoch_assignment(0, process_count=2)
    assert set(a0[0]) != set(a1[0])
    for a in (a0, a1):
        assert sorted(a[0] + a[1]) == list(range(8))


def test_epoch_dataset_rows_change_but_global_multiset_preserved(pool):
    def rows(epoch, pi):
        ds = pool.epoch_dataset(epoch, process_index=pi, process_count=2)
        return set(np.asarray(ds["label"]).tolist())

    assert rows(1, 0) != rows(2, 0)
    for e in (0, 1, 2):
        assert rows(e, 0) | rows(e, 1) == set(range(512))
        assert len(rows(e, 0)) == 256
        assert not (rows(e, 0) & rows(e, 1))


def test_epoch_dataset_is_lazy(pool):
    ds = pool.epoch_dataset(0, process_index=0, process_count=2)
    assert isinstance(ds["features"], (ShardedColumn, np.memmap))
    assert len(ds) == 256


def test_validation_errors(tmp_path, pool):
    with pytest.raises(ValueError, match="evenly"):
        pool.epoch_assignment(0, process_count=3)
    np.save(tmp_path / "short.npy", np.zeros((32, 4), np.float32))
    with pytest.raises(ValueError, match="SAME row count"):
        GlobalShards({"features": [str(tmp_path / "f0.npy"),
                                   str(tmp_path / "short.npy")],
                      "label": [str(tmp_path / "l0.npy"),
                                str(tmp_path / "l1.npy")]})
    with pytest.raises(ValueError, match="SAME shard count"):
        GlobalShards({"features": [str(tmp_path / "f0.npy")],
                      "label": [str(tmp_path / "l0.npy"),
                                str(tmp_path / "l1.npy")]})


def test_one_process_is_the_whole_pool(pool):
    """No ``torch.distributed`` group: count 1, index 0, so epoch e's
    view is the whole pool in the epoch's permuted shard order."""
    for e in (0, 1):
        assert pool.epoch_assignment(e) == \
            pool.epoch_assignment(e, process_count=1)
        labels = np.asarray(pool.epoch_dataset(e)["label"])
        assert sorted(labels.tolist()) == list(range(512))
        order = pool.epoch_assignment(e, process_count=1)[0]
        assert labels[::64].tolist() == [64 * i for i in order]


def test_trainer_re_deals_per_epoch_single_process(tmp_path):
    """host_sharded + GlobalShards re-resolves the epoch dataset each
    epoch (a recording wrapper), and the rows differ between epochs."""
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.models.mlp import MLP

    gs = GlobalShards(_write_pool(tmp_path, seed=0), seed=1)
    seen = []
    orig = gs.epoch_dataset

    def recording(epoch, *a, **kw):
        ds = orig(epoch, *a, **kw)
        seen.append((epoch, tuple(np.asarray(ds["label"]).argmax(-1)[:8])))
        return ds

    gs.epoch_dataset = recording
    t = ADAG(MLP(features=(16,)), worker_optimizer="sgd",
             learning_rate=0.05, metrics=(), batch_size=8,
             communication_window=2, num_epoch=3, num_workers=1,
             parallelism_factor=8, data_layout="host_sharded", device="cpu")
    t.train(gs)
    epochs_seen = [e for e, _ in seen]
    assert epochs_seen.count(1) >= 1 and epochs_seen.count(2) >= 1
    by_epoch = {e: rows for e, rows in seen}
    assert by_epoch[0] != by_epoch[1] or by_epoch[1] != by_epoch[2]
    assert len(t.history) > 0
    assert np.isfinite([h["loss"] for h in t.history]).all()


def test_replicated_layout_rejects_global_shards(tmp_path):
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.models.mlp import MLP

    np.save(tmp_path / "f.npy", np.zeros((64, 784), np.float32))
    np.save(tmp_path / "l.npy", np.zeros((64, 10), np.float32))
    gs = GlobalShards({"features": [str(tmp_path / "f.npy")],
                       "label": [str(tmp_path / "l.npy")]})
    t = ADAG(MLP(features=(16,)), num_workers=1, parallelism_factor=8,
             batch_size=8, communication_window=2, device="cpu")
    with pytest.raises(ValueError, match="host_sharded"):
        t.train(gs)


def test_host_async_with_global_shards(tmp_path):
    """The live-center mode re-deals too: one epoch's view staged per
    epoch, so every epoch's shards are trained."""
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.models.mlp import MLP

    gs = GlobalShards(_write_pool(tmp_path, shards=4, seed=0))
    t = ADAG(MLP(features=(16,)), mode="host_async", worker_optimizer="sgd",
             learning_rate=0.05, metrics=(), batch_size=8,
             communication_window=2, num_epoch=2, num_workers=4,
             data_layout="host_sharded", device="cpu")
    t.train(gs)
    assert t.num_updates == 2 * 4 * (64 // 16)


# -- the two packages side by side -------------------------------------------

@pytest.mark.parametrize("seed,count", [(0, 1), (3, 2), (7, 4), (11, 8)])
def test_epoch_assignment_and_rows_equal_jax(tmp_path, seed, count):
    from distkeras_tpu.data.global_shards import GlobalShards as JShards

    paths = _write_pool(tmp_path)
    port, jax_pool = GlobalShards(paths, seed=seed), JShards(paths, seed=seed)
    assert port.rows_per_shard == jax_pool.rows_per_shard
    assert len(port) == len(jax_pool)
    for epoch in range(3):
        assignment = port.epoch_assignment(epoch, process_count=count)
        assert assignment == jax_pool.epoch_assignment(
            epoch, process_count=count)
        for pi in range(count):
            a = port.epoch_dataset(epoch, process_index=pi,
                                   process_count=count)
            b = jax_pool.epoch_dataset(epoch, process_index=pi,
                                       process_count=count)
            for col in ("features", "label"):
                np.testing.assert_array_equal(np.asarray(a[col]),
                                              np.asarray(b[col]))


@pytest.mark.parametrize("mode", ["sync", "host_async"])
def test_adag_over_a_pool_matches_jax(tmp_path, mode):
    import jax

    import distkeras_tpu as jdk
    from distkeras_tpu.data.global_shards import GlobalShards as JShards
    from distkeras_tpu.models.mlp import MLP as JMLP
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.models.mlp import MLP
    from distkeras_tpu_torch.utils import bridge

    paths = _write_pool(tmp_path, shards=4, seed=5)
    kw = dict(learning_rate=0.05, batch_size=8, communication_window=2,
              num_epoch=2, worker_optimizer="sgd", metrics=("accuracy",),
              data_layout="host_sharded", mode=mode)
    if mode == "sync":  # K = 4: JAX on 4 CPU devices, the port's replicas
        jplace, tplace, rtol, atol = dict(num_workers=4), dict(
            num_workers=1, parallelism_factor=4), 1e-4, 1e-5
    else:  # K = 1 is deterministic
        jplace, tplace, rtol, atol = dict(num_workers=1), dict(
            num_workers=1), 1e-5, 1e-6
    jmodel = JMLP(features=(16,), dropout_rate=0.0)
    params = jmodel.init(jax.random.key(0), np.zeros((1, 784), np.float32),
                         train=False)["params"]
    jt = jdk.ADAG(jmodel, **kw, **jplace)
    jt.train(JShards(paths, seed=2))
    tt = ADAG(bridge.load_flax_params(MLP(features=(16,)), params),
              device="cpu", **kw, **tplace)
    tt.train(GlobalShards(paths, seed=2))
    assert len(tt.history) == len(jt.history) > 0
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose([h[key] for h in tt.history],
                                   [h[key] for h in jt.history],
                                   rtol=rtol, atol=atol, err_msg=key)
    got = bridge.state_dict_to_flax(tt.params)
    for mod, leaves in jt.params.items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(got[mod][leaf], np.asarray(want),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{mod}/{leaf}")
    assert tt.num_updates == jt.num_updates
