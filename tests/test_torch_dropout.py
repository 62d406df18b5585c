"""Training-mode dropout of the PyTorch port against the JAX package, on
the CPU.

Held: ``prng.uniform`` and ``prng.bernoulli`` bit for bit with
``jax.random.uniform`` and ``jax.random.bernoulli`` over several keys,
shapes, ranges and rates; the ``Dropout`` layer (identity at inference, a
raise without a key in training, JAX's output within 1e-5 with a key) and
``TransformerLayer(dropout=...)`` in training within 1e-5 of the JAX
layer with its own weights; containers handing each layer the key JAX's
do; and 5 ``fit`` steps of a small ``Sequential`` holding a ``Dropout``,
whose per-step losses and final parameters are within 1e-5 of the JAX
Estimator's (the step and micro-step keys folded as JAX folds them, also
under gradient accumulation).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.graph import Input as JInput
from analytics_zoo_tpu.nn.layers.attention import \
    TransformerLayer as JTransformerLayer
from analytics_zoo_tpu.nn.topology import Model as JModel
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu_torch.bridge import params_from_jax, params_to_numpy
from analytics_zoo_tpu_torch.common import prng
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.graph import Input
from analytics_zoo_tpu_torch.nn.layers.attention import TransformerLayer
from analytics_zoo_tpu_torch.nn.topology import Model, Sequential

TOL = 1e-5
AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
LOSS = "sparse_categorical_crossentropy"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _key(seed, data=None):
    k = jax.random.PRNGKey(seed)
    return k if data is None else jax.random.fold_in(k, data)


@pytest.mark.parametrize("seed,data", [(0, None), (7, 3), (123456, 99),
                                       (2 ** 31 - 1, 5)])
@pytest.mark.parametrize("shape", [(5,), (3, 4, 5), (1, 256, 33), (4099,)])
def test_uniform_and_bernoulli_are_jax_bits(seed, data, shape):
    jk = _key(seed, data)
    tk = prng.as_key(np.asarray(jk))
    u = np.asarray(jax.random.uniform(jk, shape))
    assert np.array_equal(u.view(np.uint32),
                          prng.uniform(tk, shape).numpy().view(np.uint32))
    for lo, hi in ((-2.5, 3.1), (-0.05, 0.05)):
        u = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
        got = prng.uniform(tk, shape, lo, hi).numpy()
        assert np.array_equal(u.view(np.uint32), got.view(np.uint32))
    for p in (0.1, 0.5, 0.8, 0.9, 0.999):
        want = np.asarray(jax.random.bernoulli(jk, p, shape))
        got = prng.bernoulli(tk, p, shape).numpy()
        assert got.dtype == np.bool_ and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_layer_matches_jax(dtype):
    x = np.random.default_rng(0).normal(size=(6, 40)).astype(np.float32)
    jx = jax.numpy.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jl, tl = JL.Dropout(0.3), TL.Dropout(0.3)
    # inference (the default): the identity
    assert torch.equal(tl(tx), tx)
    assert not tl.training
    tl.train()
    with pytest.raises(ValueError, match="needs an rng"):
        tl(tx)
    for seed in (1, 2, 3):
        jk = _key(seed)
        want, _ = jl.apply({}, {}, jx, training=True, rng=jk)
        got = tl(tx, rng=prng.as_key(np.asarray(jk)))
        assert got.dtype == tx.dtype
        want = np.asarray(want.astype(jax.numpy.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=TOL if dtype == "float32" else 0)
        assert np.array_equal(got.float().numpy() == 0, want == 0)
    tl.eval()
    assert torch.equal(tl(tx, rng=(0, 1)), tx)


@pytest.mark.parametrize("strategy", ["full", "flash"])
def test_transformer_layer_dropout_matches_jax(strategy):
    jl = JTransformerLayer(32, 4, causal=True, dropout=0.3,
                           attn_strategy=strategy)
    params, _ = jl.build(jax.random.PRNGKey(2), (None, 32))
    tl = TransformerLayer(32, 4, causal=True, dropout=0.3,
                          attn_strategy=strategy)
    tl.load_state_dict(params_from_jax(_np(params)))
    x = np.random.default_rng(1).normal(size=(2, 16, 32)).astype(np.float32)
    tx = torch.from_numpy(x)
    tl.train()
    with torch.no_grad():
        for seed in (5, 6):
            jk = _key(seed)
            want, _ = jl.apply(params, {}, x, training=True, rng=jk)
            got = tl.apply(tx, rng=prng.as_key(np.asarray(jk)))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=TOL)
        # no key or inference mode: no dropout, as the JAX layer
        plain, _ = jl.apply(params, {}, x)
        np.testing.assert_allclose(tl.apply(tx).numpy(), np.asarray(plain),
                                   rtol=0, atol=TOL)
        tl.eval()
        np.testing.assert_allclose(tl.apply(tx, rng=(0, 5)).numpy(),
                                   np.asarray(plain), rtol=0, atol=TOL)


def test_graph_model_hands_each_layer_its_key():
    """A functional graph splits its key over every node (inputs
    included), as the JAX GraphModule does: two Dropouts draw different
    masks, each JAX's."""
    ji = JInput((12,))
    jh = JL.Dropout(0.5)(JL.Dense(12, activation="relu")(ji))
    jm = JModel(ji, JL.Dropout(0.5)(jh))
    params, state = jm.build(jax.random.PRNGKey(0))
    ti = Input((12,))
    th = TL.Dropout(0.5)(TL.Dense(12, activation="relu")(ti))
    tm = Model(ti, TL.Dropout(0.5)(th), device="cpu")
    tm.load_state_dict(params_from_jax(_np(params)))
    x = np.random.default_rng(3).normal(size=(4, 12)).astype(np.float32)
    jk = _key(11)
    want, _ = jm.apply(params, state, x, training=True, rng=jk)
    tm.train()
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(x), rng=prng.as_key(np.asarray(jk)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def _sequential_pair(seed=0):
    jm = JSequential([JL.Dense(16, activation="relu", input_shape=(6,)),
                      JL.Dropout(0.4), JL.Dense(8, activation="relu"),
                      JL.Dropout(0.2),
                      JL.Dense(3, activation="softmax")])
    params, state = jm.build(jax.random.PRNGKey(seed))
    tm = Sequential([TL.Dense(16, activation="relu", input_shape=(6,)),
                     TL.Dropout(0.4), TL.Dense(8, activation="relu"),
                     TL.Dropout(0.2), TL.Dense(3, activation="softmax")],
                    device="cpu")
    tm.load_state_dict(params_from_jax(_np(params)))
    return jm, params, state, tm


@pytest.mark.parametrize("accum", [1, 2])
def test_fit_with_dropout_matches_jax_estimator(accum):
    """5 f32 Adam steps through a Sequential with two Dropouts: losses and
    parameters within 1e-5 (the masks are JAX's at every step and
    micro-step)."""
    jm, params, state, tm = _sequential_pair()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(80, 6)).astype(np.float32)
    y = rng.integers(0, 3, 80).astype(np.int32)
    jest = JEstimator(jm, optimizer=jopt.Adam(lr=0.01), loss=LOSS,
                      mesh=_mesh(), config=jconfig.TrainConfig(
                          grad_accum_steps=accum))
    jest.initial_weights = (params, state)
    want, step = [], jest._make_train_step()

    def jrecord(st, b):
        st, (loss, gnorm) = step(st, b)
        want.append(float(loss))
        return st, (loss, gnorm)

    jest._train_step = jrecord
    jest.fit((x, y), batch_size=16, epochs=1, seed=3)
    est = Estimator(tm, optimizer=topt.Adam(lr=0.01), loss=LOSS,
                    config=TrainConfig(grad_accum_steps=accum))
    got, tstep = [], est._step

    def trecord(b):
        loss, gnorm = tstep(b)
        got.append(float(loss))
        return loss, gnorm

    est._step = trecord
    est.fit((x, y), batch_size=16, epochs=1, seed=3)
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    jp, tp = _np(jest.train_state["params"]), params_to_numpy(tm)
    for slot, d in jp.items():
        for leaf, v in d.items():
            np.testing.assert_allclose(tp[slot][leaf], v, rtol=0, atol=TOL,
                                       err_msg=f"{slot}.{leaf}")
    # fit leaves the model in inference mode: no dropout in predict
    assert not any(m.training for m in tm.modules())
