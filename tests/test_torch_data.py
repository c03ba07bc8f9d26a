"""The port's data path, transformers, predictors, evaluators and the MLP
and CIFAR CNN models against the JAX package's.

Bounds: the dataset operations and every transformer are numpy code in
both packages and must agree bitwise; model forwards on bridged flax
params within 1e-5 abs (float32); ``ModelPredictor`` outputs within 1e-5
abs, ``ModelClassifier`` indices and ``AccuracyEvaluator`` equal, and
``LossEvaluator`` within 1e-5 abs.
"""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import evaluators as jev
from distkeras_tpu import predictors as jpred
from distkeras_tpu import transformers as jtr
from distkeras_tpu.data import dataset as jds
from distkeras_tpu.models import cnn as jcnn
from distkeras_tpu.models import mlp as jmlp
from distkeras_tpu_torch import evaluators as tev
from distkeras_tpu_torch import predictors as tpred
from distkeras_tpu_torch import transformers as ttr
from distkeras_tpu_torch.data import dataset as tds
from distkeras_tpu_torch.data.prefetch import prefetch
from distkeras_tpu_torch.models import cnn as tcnn
from distkeras_tpu_torch.models import mlp as tmlp
from distkeras_tpu_torch.utils import bridge


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _same_dataset(t, j):
    assert t.columns == j.columns and len(t) == len(j)
    for c in j.columns:
        _equal(t[c], j[c])


def test_synthetic_mnist_shuffle_take_select_are_jax_bitwise():
    t, j = tds.synthetic_mnist(n=300, seed=4), jds.synthetic_mnist(n=300,
                                                                  seed=4)
    _same_dataset(t, j)
    _same_dataset(t.shuffle(9), j.shuffle(9))
    _same_dataset(t.take(17), j.take(17))
    _same_dataset(t.select(["label_index"]), j.select(["label_index"]))
    _same_dataset(t.with_column("z", np.arange(300)),
                  j.with_column("z", np.arange(300)))


@pytest.mark.parametrize("parts", [1, 3, 7])
def test_repartition_and_batches_are_jax_bitwise(parts):
    t, j = tds.synthetic_mnist(n=250), jds.synthetic_mnist(n=250)
    for ts, js in zip(t.repartition(parts), j.repartition(parts)):
        _same_dataset(ts, js)
    for drop in (True, False):
        tb = list(t.batches(32, cols=["features", "label"],
                            drop_remainder=drop))
        jb = list(j.batches(32, cols=["features", "label"],
                            drop_remainder=drop))
        assert len(tb) == len(jb) == t.num_batches(32, drop)
        for a, b in zip(tb, jb):
            for c in b:
                _equal(a[c], b[c])


def test_file_backed_columns_shuffle_and_concat_are_jax_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        p = tmp_path / f"x{i}.npy"
        np.save(p, rng.standard_normal((40 + i, 5)).astype(np.float32))
        paths.append(str(p))
    y = tmp_path / "y.npy"
    np.save(y, np.arange(123, dtype=np.int32))
    cols = {"x": paths, "y": str(y)}
    t, j = tds.Dataset.from_files(cols), jds.Dataset.from_files(cols)
    assert isinstance(t["x"], tds.ShardedColumn)
    _same_dataset(t, j)
    ts, js = t.shuffle(3), j.shuffle(3)
    assert isinstance(ts["x"], tds.PermutedColumn)
    _equal(ts["x"][10:50], js["x"][10:50])
    _equal(ts["x"][[5, 0, 99]], js["x"][[5, 0, 99]])
    _equal(ts["x"][7], js["x"][7])
    _same_dataset(ts.shuffle(5), js.shuffle(5))
    for a, b in zip(ts.repartition(4), js.repartition(4)):
        _same_dataset(a, b)
    _same_dataset(tds.Dataset.concat([t, t.take(9)]),
                  jds.Dataset.concat([j, j.take(9)]))
    _equal(t["x"][-1], j["x"][-1])
    with pytest.raises(IndexError):
        t["x"][[500]]
    eager = tds.Dataset.from_arrays(x=np.ones((2, 5), np.float64),
                                    y=np.zeros(2, np.int32))
    _same_dataset(tds.Dataset.concat([t.take(2), eager]),
                  jds.Dataset.concat([j.take(2), jds.Dataset.from_arrays(
                      x=np.ones((2, 5), np.float64),
                      y=np.zeros(2, np.int32))]))


def test_dataset_validation_matches_jax():
    for mod in (tds, jds):
        with pytest.raises(ValueError, match="at least one column"):
            mod.Dataset({})
        with pytest.raises(ValueError, match="length mismatch"):
            mod.Dataset({"a": np.zeros(2), "b": np.zeros(3)})
        with pytest.raises(ValueError, match="at least one part"):
            mod.ShardedColumn([])


TRANSFORMERS = [
    lambda m: m.MinMaxTransformer(o_min=-1.0, o_max=1.0),
    lambda m: m.MinMaxTransformer(c_min=-2.0, c_max=3.0, output_col="mm"),
    lambda m: m.DenseTransformer(output_col="dense"),
    lambda m: m.OneHotTransformer(10, input_col="label_index",
                                  output_col="onehot"),
    lambda m: m.ReshapeTransformer("features", "image", (28, 28, 1)),
    lambda m: m.LabelIndexTransformer(input_col="label"),
    lambda m: m.Pipeline([m.MinMaxTransformer(),
                          m.OneHotTransformer(10, input_col="label_index",
                                              output_col="label")]),
]


@pytest.mark.parametrize("case", range(len(TRANSFORMERS)))
def test_transformer_is_jax_bitwise(case):
    make = TRANSFORMERS[case]
    t = make(ttr).transform(tds.synthetic_mnist(n=64, seed=1))
    j = make(jtr).transform(jds.synthetic_mnist(n=64, seed=1))
    _same_dataset(t, j)


def test_binary_and_object_column_transformers_are_jax_bitwise():
    scores = np.array([[-2.0], [0.1], [0.3], [3.0]], np.float32)
    rows = np.empty(3, dtype=object)
    rows[:] = [[1, 2], [3, 4], [5, 6]]
    for kw in (dict(from_logits=True), dict(activation_threshold=0.2)):
        t = ttr.LabelIndexTransformer(**kw).transform(
            tds.Dataset.from_arrays(prediction=scores))
        j = jtr.LabelIndexTransformer(**kw).transform(
            jds.Dataset.from_arrays(prediction=scores))
        _same_dataset(t, j)
    t = ttr.DenseTransformer().transform(tds.Dataset({"features": rows}))
    j = jtr.DenseTransformer().transform(jds.Dataset({"features": rows}))
    _equal(t["features"], j["features"])
    with pytest.raises(ValueError, match="out of range"):
        ttr.OneHotTransformer(3).transform(
            tds.Dataset.from_arrays(label=np.array([0, 3])))


def test_prefetch_keeps_order_and_reraises_with_producer_frames():
    assert list(prefetch(iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise KeyError("disk")

    it = prefetch(broken())
    assert next(it) == 1
    with pytest.raises(KeyError) as info:
        next(it)
    assert "broken" in info.value.producer_traceback
    with pytest.raises(ValueError, match="depth"):
        list(prefetch(iter(()), depth=0))


# -- models, predictors, evaluators on bridged weights ----------------------

def _flax(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def mlp_pair():
    x = np.random.default_rng(2).standard_normal((37, 784)).astype(
        np.float32)
    jm = jmlp.mnist_mlp()
    params = _flax(jm.init(jax.random.key(3), x[:1])["params"])
    return jm, params, x


def test_mnist_mlp_forward_matches_flax(mlp_pair):
    jm, params, x = mlp_pair
    model = bridge.load_flax_params(tmlp.mnist_mlp(), params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params},
                                                        x)), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("uint8", [True, False])
def test_cifar10_cnn_forward_matches_flax(uint8):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8) if uint8 \
        else rng.standard_normal((3, 32 * 32 * 3)).astype(np.float32)
    kw = dict(channels=(8, 16), dense_width=64)
    jm = jcnn.cifar10_cnn(**kw)
    params = _flax(jm.init(jax.random.key(4), x)["params"])
    model = bridge.load_flax_params(tcnn.cifar10_cnn(**kw), params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params},
                                                        x)), rtol=0,
                               atol=1e-5)
    assert bridge.state_dict_to_flax(model.state_dict()).keys() == \
        params.keys()


def test_predictors_and_evaluators_match_jax(mlp_pair):
    jm, params, x = mlp_pair
    y = np.eye(10, dtype=np.float32)[np.arange(37) % 10]
    jdata = jds.Dataset.from_arrays(features=x, label=y)
    tdata = tds.Dataset.from_arrays(features=x, label=y)
    model = bridge.load_flax_params(tmlp.mnist_mlp(), params)
    jout = jpred.ModelPredictor(jm, params, batch_size=16).predict(jdata)
    tout = tpred.ModelPredictor(model, batch_size=16, device="cpu").predict(tdata)
    np.testing.assert_allclose(tout["prediction"], jout["prediction"],
                               rtol=0, atol=1e-5)
    # trained params are loaded into a copy of the model
    tcopy = tpred.ModelPredictor(tmlp.mnist_mlp(), bridge.flax_to_state_dict(
        params), batch_size=16, device="cpu").predict(tdata)
    np.testing.assert_array_equal(tcopy["prediction"], tout["prediction"])
    jcls = jpred.ModelClassifier(jm, params, batch_size=16).predict(jdata)
    tcls = tpred.ModelClassifier(model, batch_size=16,
                                  device="cpu").predict(tdata)
    _equal(tcls["prediction"], jcls["prediction"])
    for jcol, tcol in ((jcls, tcls), (jdata.with_column(
            "prediction", y), tdata.with_column("prediction", y))):
        assert tev.AccuracyEvaluator("prediction", "label").evaluate(
            tcol) == jev.AccuracyEvaluator("prediction", "label").evaluate(
                jcol)
    for loss in ("categorical_crossentropy", "mse"):
        want = jev.LossEvaluator(loss).evaluate(jout)
        got = tev.LossEvaluator(loss).evaluate(tout)
        assert abs(got - want) <= 1e-5, (loss, got, want)
    empty = tds.Dataset.from_arrays(prediction=np.zeros((0, 3)),
                                    label=np.zeros((0, 3)))
    assert np.isnan(tev.AccuracyEvaluator().evaluate(empty))
    assert np.isnan(tev.LossEvaluator().evaluate(empty))
