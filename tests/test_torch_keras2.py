"""The port's keras2 facade (``analytics_zoo_tpu_torch.keras2``) against
the JAX package's, on the CPU: each keras2 case of
``tests/test_examples_keras2.py`` built in both packages, the JAX model's
weights carried into the port's by ``bridge.state_dict_from_jax``; the
outputs within 1e-5 in f32, and where a case trains, a 2-step fit's last
loss and updated weights within 1e-5 of JAX's.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu import keras2 as jk2
from analytics_zoo_tpu_torch import keras2 as tk2
from analytics_zoo_tpu_torch.bridge import params_to_numpy, state_dict_from_jax

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _pair(build, seed=0, **compile_kw):
    """The JAX and the port model from one recipe, compiled alike, the
    port's holding the JAX model's initial weights."""
    jm, tm = build(jk2, jk2.Sequential, jk2.Model), build(
        tk2, lambda: tk2.Sequential(device="cpu"),
        lambda i, o: tk2.Model(i, o, device="cpu"))
    params, state = _np(jm.build(jax.random.PRNGKey(seed)))
    tm.load_state_dict(state_dict_from_jax(params, state))
    jm.compile(mesh=_mesh(), **compile_kw)
    jm.set_initial_weights(params, state)
    tm.compile(**compile_kw)
    return jm, tm


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _fit_both(jm, tm, x, y, batch_size):
    """One epoch of two steps in both; the last loss and every updated
    weight within TOL."""
    jm.fit(x, y, batch_size=batch_size, nb_epoch=1)
    tm.fit(x, y, batch_size=batch_size, nb_epoch=1)
    assert tm.estimator.trainer_state.iteration == 2
    _close(jm.estimator.trainer_state.last_loss,
           tm.estimator.trainer_state.last_loss)
    got = params_to_numpy(tm)
    for slot, leaves in _np(jm.estimator.train_state["params"]).items():
        for leaf, v in leaves.items():
            _close(v, got[slot][leaf])


def test_keras2_sequential_trains():
    def build(k2, seq, _):
        m = seq()
        m.add(k2.InputLayer((6,)))
        m.add(k2.Dense(16, activation="relu"))
        m.add(k2.Dropout(rate=0.1))
        m.add(k2.Dense(2, activation="softmax"))
        return m

    jm, tm = _pair(build, optimizer="sgd",
                   loss="sparse_categorical_crossentropy",
                   metrics=["accuracy"])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 6)).astype("float32")
    y = (x.sum(1) > 0).astype("int32")
    _close(jm.predict(x), tm.predict(x))
    _fit_both(jm, tm, x, y, batch_size=32)
    assert tm.predict(x).shape == (64, 2)


def test_keras2_conv_pool_names():
    def build(k2, seq, _):
        m = seq()
        m.add(k2.InputLayer((16, 16, 3)))
        m.add(k2.Conv2D(filters=4, kernel_size=3, padding="same",
                        activation="relu"))
        m.add(k2.MaxPooling2D(pool_size=2))
        m.add(k2.BatchNormalization(momentum=0.9))
        m.add(k2.Flatten())
        m.add(k2.Dense(units=2))
        return m

    jm, tm = _pair(build, optimizer="sgd", loss="mse")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16, 16, 3)).astype("float32")
    _close(jm.predict(x), tm.predict(x))
    _fit_both(jm, tm, x, rng.standard_normal((4, 2)).astype("float32"),
              batch_size=2)


def test_keras2_functional_merge():
    def build(k2, _, model):
        a = k2.Input((4,))
        b = k2.Input((4,))
        ha = k2.Dense(8, activation="relu")(a)
        hb = k2.Dense(8, activation="relu")(b)
        merged = k2.Concatenate()([ha, hb])
        return model([a, b], k2.Dense(1)(merged))

    jm, tm = _pair(build, optimizer="sgd", loss="mse")
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((8, 4)).astype("float32") for _ in range(2)]
    _close(jm.predict(xs), tm.predict(xs))
    _fit_both(jm, tm, xs, rng.standard_normal((8, 1)).astype("float32"),
              batch_size=4)


def test_keras2_separate_initializers_and_unit_forget_bias():
    """The deterministic initializers give JAX's values exactly; the
    random one draws from the port's generator (JAX's spread, not its
    bits)."""
    gen = torch.Generator().manual_seed(0)
    jl = jk2.LSTM(6, kernel_initializer="he_normal",
                  recurrent_initializer="zeros", bias_initializer="ones",
                  unit_forget_bias=True)
    tl = tk2.LSTM(6, kernel_initializer="he_normal",
                  recurrent_initializer="zeros", bias_initializer="ones",
                  unit_forget_bias=True)
    jp, _ = jl.build(jax.random.PRNGKey(0), (5, 3))
    tl.build((5, 3), gen)
    _close(jp["recurrent_kernel"], tl.recurrent_kernel.detach(), 0)
    _close(jp["bias"], tl.bias.detach(), 0)
    assert float(tl.kernel.detach().abs().max()) > 0.0
    assert tl.kernel.shape == jp["kernel"].shape
    jz = jk2.LSTM(6, unit_forget_bias=True)
    tz = tk2.LSTM(6, unit_forget_bias=True)
    jpz, _ = jz.build(jax.random.PRNGKey(0), (5, 3))
    tz.build((5, 3), gen)
    _close(jpz["bias"], tz.bias.detach(), 0)
    b = tz.bias.detach().numpy()
    np.testing.assert_array_equal(b[6:12], 1.0)   # forget gate
    np.testing.assert_array_equal(b[:6], 0.0)
    jd, td = jk2.Dense(4, bias_initializer="ones"), tk2.Dense(
        4, bias_initializer="ones")
    jpd, _ = jd.build(jax.random.PRNGKey(1), (3,))
    td.build((3,), gen)
    _close(jpd["bias"], td.bias.detach(), 0)


def test_keras2_channels_first_data_format():
    def build(first):
        def make(k2, seq, _):
            m = seq()
            if first:
                m.add(k2.InputLayer((3, 8, 8)))
                m.add(k2.Conv2D(4, 3, padding="same",
                                data_format="channels_first"))
                m.add(k2.MaxPooling2D(2, data_format="channels_first"))
            else:
                m.add(k2.InputLayer((8, 8, 3)))
                m.add(k2.Conv2D(4, 3, padding="same"))
                m.add(k2.MaxPooling2D(2))
            return m
        return make

    rng = np.random.default_rng(0)
    x_first = rng.standard_normal((2, 3, 8, 8)).astype("float32")  # NCHW
    jm, tm = _pair(build(True), optimizer="sgd", loss="mse")
    assert "1_channelsfirstwrapper.kernel" in tm.state_dict()
    y_first = tm.predict(x_first)
    assert y_first.shape == (2, 4, 4, 4)                            # NCHW out
    _close(jm.predict(x_first), y_first)
    # the same kernel in a channels-last model gives the same values in the
    # other layout
    _, tl = _pair(build(False), optimizer="sgd", loss="mse")
    with torch.no_grad():
        tl.state_dict()["1_convolution2d.kernel"].copy_(
            tm.state_dict()["1_channelsfirstwrapper.kernel"])
        tl.state_dict()["1_convolution2d.bias"].copy_(
            tm.state_dict()["1_channelsfirstwrapper.bias"])
    _close(np.transpose(y_first, (0, 2, 3, 1)),
           tl.predict(np.transpose(x_first, (0, 2, 3, 1))))
    # global pooling under channels_first gives (B, C) directly
    jg = jk2.GlobalAveragePooling2D(data_format="channels_first")
    tg = tk2.GlobalAveragePooling2D(data_format="channels_first")
    yg, _ = jg.apply({}, {}, x_first)
    got = tg(torch.from_numpy(x_first))
    _close(yg, got)
    _close(x_first.mean(axis=(2, 3)), got, 1e-6)
    assert tg.compute_output_shape((3, 8, 8)) == \
        jg.compute_output_shape((3, 8, 8))


def test_keras2_reference_name_coverage():
    """Every reference keras2 layer file has a counterpart symbol, and the
    facade exports the JAX package's names."""
    ref_files = ["Activation", "Average", "AveragePooling1D", "Conv1D",
                 "Conv2D", "Cropping1D", "Dense", "Dropout", "Flatten",
                 "GlobalAveragePooling1D", "GlobalAveragePooling2D",
                 "GlobalAveragePooling3D", "GlobalMaxPooling1D",
                 "GlobalMaxPooling2D", "GlobalMaxPooling3D",
                 "LocallyConnected1D", "MaxPooling1D", "Maximum", "Minimum",
                 "Softmax"]
    assert not [n for n in ref_files if not hasattr(tk2, n)]
    assert sorted(tk2.__all__) == sorted(jk2.__all__)
    assert all(hasattr(tk2, n) for n in tk2.__all__)


@pytest.mark.parametrize("merge", ["Minimum", "Maximum", "Add", "Multiply",
                                   "Average"])
def test_keras2_merge_layers(merge):
    def build(k2, _, model):
        a = k2.Input((4,))
        b = k2.Input((4,))
        return model([a, b], getattr(k2, merge)()([a, b]))

    jm, tm = _pair(build, optimizer="sgd", loss="mse")
    rng = np.random.default_rng(1)
    xa = rng.standard_normal((6, 4)).astype("float32")
    xb = rng.standard_normal((6, 4)).astype("float32")
    _close(jm.predict([xa, xb]), tm.predict([xa, xb]))
    if merge == "Minimum":
        _close(np.minimum(xa, xb), tm.predict([xa, xb]), 1e-6)


def test_keras2_locally_connected():
    def build(k2, seq, _):
        m = seq()
        m.add(k2.LocallyConnected1D(5, 3, input_shape=(9, 2)))
        return m

    jm, tm = _pair(build, optimizer="sgd", loss="mse")
    x = np.random.default_rng(1).standard_normal((2, 9, 2)).astype("float32")
    y = tm.predict(x)
    assert y.shape == (2, 7, 5)
    _close(jm.predict(x), y)
