"""Seq2seq and GANEstimator of the PyTorch port against the JAX package, on
the CPU, at the sizes of ``tests/test_model_zoo.py``'s Seq2seq cases and
``tests/test_gan_profiling.py``.

Held, with the JAX weights loaded through the bridge: Seq2seq outputs
within 1e-5 (LSTM and GRU stacks, the dense, densenonlinear and custom
bridges, an embedding and a generator); two f32 Adam steps through
``fit`` with per-step losses and final parameters within 1e-5 of the JAX
Estimator's (Adam ``epsilon=1e-4``, as in ``tests/test_torch_training.py``:
a gate in a saturated ``hard_sigmoid`` has a rounding-noise gradient);
``infer``'s outputs within 1e-5 and its greedy token stream identical;
bundles loading in either direction. GANEstimator: its step keys and the
noise's uniform bits bit for bit JAX's (the normal draws through
``erf_inv`` within an ulp, as ``tests/test_torch_prng.py`` holds them),
two training steps' losses, parameters and BatchNorm statistics within
1e-5 of the JAX trainer's (Adam ``epsilon=1e-4``: the BatchNorm in the
discriminator cancels a shift of the generator's output, whose bias then
has a rounding-noise gradient), ``generate``'s samples, and the refusal
before ``fit``.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.engine import gan as jgan
from analytics_zoo_tpu.models import seq2seq as js2s
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu_torch.bridge import (params_from_jax, params_to_numpy,
                                            state_dict_from_jax)
from analytics_zoo_tpu_torch.common import prng
from analytics_zoo_tpu_torch.engine import GANEstimator
from analytics_zoo_tpu_torch.models import seq2seq as ts2s
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.topology import Sequential as TSequential

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
VOCAB = 30


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _make(pkg, L, kind, **kw):
    """The Seq2seq of a case in package ``pkg`` with layers ``L``."""
    if kind in ("lstm_dense", "gru_nonlinear", "lstm_none", "gru_custom"):
        rnn = kind.split("_")[0]
        bridge = {"lstm_dense": lambda: pkg.Bridge.initialize("dense", 8),
                  "gru_nonlinear": lambda: pkg.Bridge.initialize(
                      "densenonlinear", 8),
                  "lstm_none": lambda: None,
                  "gru_custom": lambda: pkg.Bridge.initialize_from_fn(
                      lambda states: [s * 0.5 for s in states])}[kind]()
        return pkg.Seq2seq(pkg.RNNEncoder.initialize(rnn, 2, 8),
                           pkg.RNNDecoder.initialize(rnn, 2, 8),
                           input_shape=(5, 4), output_shape=(6, 4),
                           bridge=bridge, **kw)
    # the embedding + generator case
    enc = pkg.RNNEncoder.initialize("gru", 1, 8, embedding=L.Embedding(
        VOCAB, 8, init="uniform"))
    dec = pkg.RNNDecoder.initialize("gru", 1, 8, embedding=L.Embedding(
        VOCAB, 8, init="uniform"))
    gen = L.TimeDistributed(L.Dense(VOCAB, activation="softmax"))
    return pkg.Seq2seq(enc, dec, input_shape=(7,), output_shape=(5,),
                       bridge=pkg.Bridge.initialize("densenonlinear", 8),
                       generator=gen, **kw)


def _data(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "tokens":
        return ([rng.integers(0, VOCAB, size=(n, 7)).astype("int32"),
                 rng.integers(0, VOCAB, size=(n, 5)).astype("int32")],
                rng.integers(0, VOCAB, size=(n, 5)).astype("int32"))
    return ([rng.normal(size=(n, 5, 4)).astype("float32"),
             rng.normal(size=(n, 6, 4)).astype("float32")],
            rng.normal(size=(n, 6, 8)).astype("float32"))


def _pair(kind, seed=0):
    jm = _make(js2s, JL, kind)
    params, state = jax.jit(jm.build)(jax.random.PRNGKey(seed))
    tm = _make(ts2s, TL, kind, device="cpu")
    tm.load_state_dict(params_from_jax(_np(params)))
    return jm, params, state, tm


KINDS = ["lstm_dense", "gru_nonlinear", "lstm_none", "gru_custom",
         "tokens"]


@pytest.mark.parametrize("kind", KINDS)
def test_seq2seq_outputs_match_jax(kind):
    jm, params, state, tm = _pair(kind)
    x, _ = _data(kind, 6, 0)
    want, _ = jm.apply(params, state, x)
    with torch.no_grad():
        got = tm.apply([torch.from_numpy(a) for a in x])
    assert tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert tm.compute_output_shape() == jm.compute_output_shape(None)


@pytest.mark.parametrize("kind", ["lstm_dense", "tokens"])
def test_seq2seq_two_fit_steps_match_jax(kind):
    jm, params, state, tm = _pair(kind, seed=1)
    x, y = _data(kind, 32, 1)
    loss = ("sparse_categorical_crossentropy" if kind == "tokens"
            else "mse")
    jm.compile(optimizer=jopt.Adam(lr=0.01, epsilon=1e-4), loss=loss,
               mesh=_mesh())
    jest = jm.estimator
    jest.initial_weights = (params, state)
    want, step = [], jest._make_train_step()

    def jrecord(st, b):
        st, (lo, gnorm) = step(st, b)
        want.append(float(lo))
        return st, (lo, gnorm)

    jest._train_step = jrecord
    jm.fit(x, y, batch_size=16, nb_epoch=1, seed=3)
    tm.compile(optimizer=topt.Adam(lr=0.01, epsilon=1e-4), loss=loss)
    got, tstep = [], tm.estimator._step

    def trecord(b):
        lo, gnorm = tstep(b)
        got.append(float(lo))
        return lo, gnorm

    tm.estimator._step = trecord
    tm.fit(x, y, batch_size=16, nb_epoch=1, seed=3)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    flat = params_from_jax(_np(jest.train_state["params"]))
    mine = params_from_jax(params_to_numpy(tm))
    assert sorted(flat) == sorted(mine)
    for name, v in flat.items():
        np.testing.assert_allclose(mine[name].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    # the trained model predicts as JAX's does
    want_p = np.asarray(jm.predict(x, batch_size=16))
    np.testing.assert_allclose(tm.predict(x, batch_size=16), want_p,
                               rtol=0, atol=1e-5)


def test_seq2seq_infer_matches_jax():
    jm, params, state, tm = _pair("lstm_dense", seed=2)
    x, _ = _data("lstm_dense", 4, 2)
    jm.compile(optimizer="adam", loss="mse", mesh=_mesh())
    jm.estimator.initial_weights = (params, state)
    jm.estimator.train_state = jm.estimator._init_state((x, None))
    tm.compile(optimizer="adam", loss="mse")
    start = np.zeros((2, 4), "float32")
    kw = dict(start_sign=start, max_seq_len=4,
              build_output=lambda y: y[:, :4])
    want = np.asarray(jm.infer(x[0][:2], **kw))
    got = tm.infer(x[0][:2], **kw)
    assert got.shape == want.shape == (2, 4, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # stop_sign: an output equal to it ends generation early
    stop = np.asarray(want[:, 0])
    assert tm.infer(x[0][:2], stop_sign=stop, **kw).shape == (2, 1, 8)


def test_seq2seq_greedy_tokens_identical():
    jm, params, state, tm = _pair("tokens", seed=3)
    x, _ = _data("tokens", 3, 3)
    jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               mesh=_mesh())
    jm.estimator.initial_weights = (params, state)
    jm.estimator.train_state = jm.estimator._init_state((x, None))
    tm.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    kw = dict(start_sign=np.zeros((3,), "int32"), max_seq_len=6,
              build_output=lambda y: y.argmax(-1).astype("int32"))
    want = np.asarray(jm.infer(x[0], **kw))
    got = tm.infer(x[0], **kw)
    assert got.shape == want.shape == (3, 6, VOCAB)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_seq2seq_bundles_load_either_way(tmp_path):
    jm, params, state, tm = _pair("lstm_dense", seed=4)
    x, _ = _data("lstm_dense", 4, 4)
    tm.compile(optimizer="adam", loss="mse")
    tm.save_model(str(tmp_path / "port"))
    back = ts2s.Seq2seq.load_model(str(tmp_path / "port"), device="cpu")
    back.compile(optimizer="adam", loss="mse")
    np.testing.assert_array_equal(back.predict(x), tm.predict(x))
    jback = js2s.Seq2seq.load_model(str(tmp_path / "port"))
    jback.compile(optimizer="adam", loss="mse", mesh=_mesh())
    np.testing.assert_allclose(np.asarray(jback.predict(x)), tm.predict(x),
                               rtol=0, atol=1e-5)
    jm.compile(optimizer="adam", loss="mse", mesh=_mesh())
    jm.estimator.initial_weights = (params, state)
    jm.estimator.train_state = jm.estimator._init_state((x, None))
    jm.save_model(str(tmp_path / "jax"))
    tback = ts2s.Seq2seq.load_model(str(tmp_path / "jax"), device="cpu")
    tback.compile(optimizer="adam", loss="mse")
    np.testing.assert_allclose(tback.predict(x), tm.predict(x), rtol=0,
                               atol=1e-6)
    # a custom architecture's bundle names none to rebuild
    custom = _make(ts2s, TL, "tokens", device="cpu")
    custom.save_model(str(tmp_path / "custom"))
    with pytest.raises(ValueError, match="custom architecture"):
        ts2s.Seq2seq.load_model(str(tmp_path / "custom"), device="cpu")


def test_seq2seq_checks():
    with pytest.raises(TypeError, match="cannot be None"):
        ts2s.Seq2seq(ts2s.RNNEncoder.initialize("lstm", 1, 8),
                     ts2s.RNNDecoder.initialize("lstm", 1, 8), None, (6, 4),
                     device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        ts2s.Seq2seq(ts2s.RNNEncoder.initialize("lstm", 1, 8),
                     ts2s.RNNDecoder.initialize("lstm", 1, 8), (5, 4),
                     (6, 4), bridge=ts2s.Bridge.initialize("dense", 4),
                     device="cpu")
    with pytest.raises(Exception, match="lstm\\|gru\\|simplernn"):
        ts2s.RNNEncoder.initialize("transformer", 1, 8)
    with pytest.raises(ValueError, match="bridge_type"):
        ts2s.Bridge("sparse", 8)
    assert sorted(ts2s.__all__) == sorted(js2s.__all__)


# ------------------------------------------------------------------ GAN

def _gan_nets(pkg_seq, L, bn, **kw):
    gen = pkg_seq([L.Dense(8, activation="relu", input_shape=(4,)),
                   L.Dense(2)], **kw)
    if bn:
        # no bias before the BatchNorm, which would cancel it: its
        # gradient is rounding noise in both packages
        disc = pkg_seq([L.Dense(8, use_bias=False, input_shape=(2,)),
                        L.BatchNormalization(), L.Activation("relu"),
                        L.Dense(1)], **kw)
    else:
        disc = pkg_seq([L.Dense(8, activation="relu", input_shape=(2,)),
                        L.Dense(1)], **kw)
    return gen, disc


def _gan_pair(bn, d_steps=1):
    jg, jd = _gan_nets(JSequential, JL, bn)
    jest = jgan.GANEstimator(jg, jd, noise_dim=4,
                             gen_optimizer=jopt.Adam(lr=5e-3, epsilon=1e-4),
                             disc_optimizer=jopt.Adam(lr=5e-3,
                                                      epsilon=1e-4),
                             d_steps=d_steps, seed=5)
    jest._init((2,))
    tg, td = _gan_nets(TSequential, TL, bn, device="cpu")
    st = _np(jest.state)
    tg.load_state_dict(state_dict_from_jax(st["g_params"], st["g_state"]))
    td.load_state_dict(state_dict_from_jax(st["d_params"], st["d_state"]))
    test = GANEstimator(tg, td, noise_dim=4,
                        gen_optimizer=topt.Adam(lr=5e-3, epsilon=1e-4),
                        disc_optimizer=topt.Adam(lr=5e-3, epsilon=1e-4),
                        d_steps=d_steps,
                        seed=5)
    return jest, test


def test_gan_noise_is_jax_bits():
    jest, test = _gan_pair(bn=False, d_steps=2)
    test._init()
    kt = jax.random.split(jax.random.PRNGKey(5), 3)[2]
    assert tuple(prng.as_key(np.asarray(kt))) == tuple(test.state["rng"])
    for step, idx, parts in ((0, 0, 4), (0, 2, 3), (3, 1, 4)):
        k = jax.random.fold_in(kt, step * 3 + idx)
        kz = jax.random.split(k, parts)[0]
        want = np.asarray(jax.random.normal(kz, (16, 4)))
        tk = prng.fold_in(test.state["rng"], step * 3 + idx)
        tz = prng.split(tk, parts)[0]
        assert tuple(prng.as_key(np.asarray(kz))) == tuple(tz)
        # the uniform bits exactly; the normal through erf_inv within an
        # ulp (tests/test_torch_prng.py)
        lo = np.nextafter(np.float32(-1), np.float32(0))
        np.testing.assert_array_equal(
            prng.uniform(tz, (16, 4), float(lo), 1.0).numpy(),
            np.asarray(jax.random.uniform(kz, (16, 4), minval=lo,
                                          maxval=1.0)))
        got = test._noise(tz, 16).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (5, 4)))
    np.testing.assert_allclose(test._noise(prng.PRNGKey(7), 5).numpy(),
                               want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bn,d_steps", [(False, 1), (True, 2)])
def test_gan_two_steps_match_jax(bn, d_steps):
    jest, test = _gan_pair(bn, d_steps)
    real = (np.random.default_rng(1).standard_normal((64, 2)) + 5.0
            ).astype("float32")
    want, jstep = [], jest._step

    def jrecord(st, b):
        st, (d_l, g_l) = jstep(st, b)
        want.append((float(d_l), float(g_l)))
        return st, (d_l, g_l)

    jest._step = jrecord
    jest.fit(real, batch_size=32, epochs=1)
    got, tstep = [], test._train_step

    def trecord(b):
        d_l, g_l = tstep(b)
        got.append((float(d_l), float(g_l)))
        return d_l, g_l

    test._train_step = trecord
    test.fit(real, batch_size=32, epochs=1)
    assert len(got) == len(want) == 2 and test.state["step"] == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    st = _np(jest.state)
    for module, params, state in ((test.generator, st["g_params"],
                                   st["g_state"]),
                                  (test.discriminator, st["d_params"],
                                   st["d_state"])):
        ref = state_dict_from_jax(params, state)
        mine = module.state_dict()
        assert sorted(ref) == sorted(mine)
        for name, v in ref.items():
            np.testing.assert_allclose(mine[name].numpy(), v.numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
    if bn:
        moved = [v for k, v in test.discriminator.state_dict().items()
                 if k.endswith(("moving_mean", "moving_var"))]
        assert any(float(v.abs().max()) not in (0.0, 1.0) for v in moved)
    np.testing.assert_allclose(test.generate(8, seed=3),
                               np.asarray(jest.generate(8, seed=3)),
                               rtol=0, atol=1e-5)


def test_gan_generate_requires_fit():
    tg = TSequential([TL.Dense(2, input_shape=(4,))], device="cpu")
    td = TSequential([TL.Dense(1, input_shape=(2,))], device="cpu")
    est = GANEstimator(tg, td, noise_dim=4)
    with pytest.raises(RuntimeError, match="not fitted"):
        est.generate(4)
