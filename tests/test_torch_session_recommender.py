"""SessionRecommender of the PyTorch port against the JAX package, on the
CPU, with and without the history tower.

The same numpy-seeded sessions go through both packages, the port
carrying the JAX model's ``build`` weights through
``bridge.state_dict_from_jax``. Held: the forward within 1e-5 in f32; a
4-step f32 ``fit`` (stacked GRUs, the history sum, Adam) whose per-step
losses and final parameters are within 1e-5 of the JAX Estimator's; the
bf16 update fed the same bf16 gradients in both packages (masters within
1e-6, bf16 params within one bf16 step); ``recommend_for_session``'s
items (inputs without ties) and probabilities within 1e-6; the three pair
methods raising; and weight bundles both ways with the same predictions.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
from analytics_zoo_tpu.models.recommendation import \
    SessionRecommender as JSession
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu_torch.bridge import params_to_numpy, state_dict_from_jax
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.models.common import MODEL_REGISTRY
from analytics_zoo_tpu_torch.models.recommendation import SessionRecommender
from analytics_zoo_tpu_torch.nn import optimizers as topt

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
ITEMS, EMBED, SESSION, HISTORY = 50, 8, 6, 4
N, BATCH = 128, 32
WIDTHS = dict(rnn_hidden_layers=(12, 10), mlp_hidden_layers=(16, 8))
LOSS = "sparse_categorical_crossentropy"


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _kw(history):
    return dict(session_length=SESSION, include_history=history,
                history_length=HISTORY if history else 0, **WIDTHS)


def _data(history, n=N, seed=0):
    """1-based item ids as float32 (0 pads a history), 0-based labels."""
    rng = np.random.default_rng(seed)
    sess = rng.integers(1, ITEMS + 1, (n, SESSION)).astype(np.float32)
    hist = rng.integers(0, ITEMS + 1, (n, HISTORY)).astype(np.float32)
    y = rng.integers(0, ITEMS, n).astype(np.int32)
    return ([sess, hist] if history else sess), y


def _models(history, seed=0):
    jm = JSession(ITEMS, EMBED, **_kw(history))
    tm = SessionRecommender(ITEMS, EMBED, device="cpu", **_kw(history))
    params, state = jm.build(jax.random.PRNGKey(seed))
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    return jm, params, state, tm


def _torch(x):
    if isinstance(x, list):
        return [torch.from_numpy(a) for a in x]
    return torch.from_numpy(x)


@pytest.mark.parametrize("history", [False, True])
def test_forward_matches_jax(history):
    jm, params, state, tm = _models(history)
    x, _ = _data(history)
    want, _ = jm.apply(params, state, x)
    with torch.no_grad():
        got = tm.apply(_torch(x)).numpy()
    assert got.shape == (N, ITEMS)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    assert sorted(tm.state_dict()) == sorted(
        f"{slot}.{leaf}" for slot, d in params.items() for leaf in d)
    assert tm.constructor_config() == jm.constructor_config()
    assert MODEL_REGISTRY["SessionRecommender"] is SessionRecommender


def test_constructor_checks():
    with pytest.raises(ValueError, match="session_length"):
        SessionRecommender(ITEMS, EMBED, device="cpu")
    with pytest.raises(ValueError, match="history_length"):
        SessionRecommender(ITEMS, EMBED, session_length=3,
                           include_history=True, device="cpu")


@pytest.mark.parametrize("history", [False, True])
def test_fit_matches_jax_estimator(history):
    """4 steps in f32, streaming at the default prefetch depth (2)."""
    jm, params, state, tm = _models(history, seed=1)
    data = _data(history, seed=2)
    jest = JEstimator(jm, optimizer=jopt.Adam(lr=0.01), loss=LOSS,
                      mesh=_mesh())
    jest.initial_weights = (params, state)
    want, step = [], jest._make_train_step()

    def jrecord(st, b):
        st, (loss, gnorm) = step(st, b)
        want.append(float(loss))
        return st, (loss, gnorm)

    jest._train_step = jrecord
    jest.fit(data, batch_size=BATCH, epochs=1, seed=1)
    est = Estimator(tm, optimizer=topt.Adam(lr=0.01), loss=LOSS,
                    config=TrainConfig())
    got, tstep = [], est._step

    def trecord(b):
        loss, gnorm = tstep(b)
        got.append(float(loss))
        return loss, gnorm

    est._step = trecord
    est.fit(data, batch_size=BATCH, epochs=1, seed=1)
    assert len(got) == len(want) == N // BATCH
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jparams, tparams = _np(jest.train_state["params"]), params_to_numpy(tm)
    for slot, d in jparams.items():
        for leaf, v in d.items():
            np.testing.assert_allclose(tparams[slot][leaf], v, rtol=0,
                                       atol=1e-5, err_msg=f"{slot}.{leaf}")


@pytest.mark.parametrize("history", [False, True])
def test_bf16_update_matches_jax_on_the_same_gradients(history):
    jm, params, state, tm = _models(history)
    flat = {f"{s}.{l}": np.asarray(v) for s, d in _np(params).items()
            for l, v in d.items()}
    rng = np.random.default_rng(11)
    grads = [{n: torch.from_numpy(
        (rng.normal(size=v.shape) * 10.0 ** rng.uniform(-4, -1))
        .astype(np.float32)).to(torch.bfloat16) for n, v in flat.items()}
        for _ in range(4)]

    def jtree(gs):
        out = {}
        for n, g in gs.items():
            slot, leaf = n.split(".", 1)
            out.setdefault(slot, {})[leaf] = jax.numpy.asarray(
                g.float().numpy(), jax.numpy.bfloat16)
        return out

    jest = JEstimator(jm, optimizer=jopt.Adam(lr=0.01), loss=LOSS,
                      mesh=_mesh(),
                      config=jconfig.TrainConfig(compute_dtype="bfloat16"))
    jest.initial_weights = (params, state)
    jstate = jest._init_state(_data(history, n=BATCH), seed=0)
    jest._grads_fn = lambda micro_constraint=None: (
        lambda p, mstate, rng_, b: (jax.numpy.float32(0), mstate, b))
    jstep = jest._make_train_step()
    jnorms = []
    for gs in grads:
        jstate, (_, gnorm) = jstep(jstate, jtree(gs))
        jnorms.append(float(gnorm))
    est = Estimator(tm, optimizer=topt.Adam(lr=0.01), loss=LOSS,
                    config=TrainConfig(compute_dtype="bfloat16"))
    est._init_state(0)
    est._grads = lambda b, rng=None: (torch.zeros(()), b)
    norms = [float(est._step(gs)[1]) for gs in grads]
    masters = est.train_state["opt_state"].master
    jmasters, jp = _np(jstate["opt_state"].master), _np(jstate["params"])
    tparams = dict(tm.named_parameters())
    for s, d in jmasters.items():
        for l, v in d.items():
            n = f"{s}.{l}"
            np.testing.assert_allclose(masters[n].numpy(), v, rtol=0,
                                       atol=1e-6, err_msg=n)
            assert torch.equal(tparams[n].detach(),
                               masters[n].to(torch.bfloat16)), n
            np.testing.assert_allclose(
                tparams[n].detach().float().numpy(),
                np.asarray(jp[s][l], np.float32), rtol=2 ** -7, atol=0,
                err_msg=n)
    np.testing.assert_allclose(norms, jnorms, rtol=1e-6)


@pytest.mark.parametrize("history", [False, True])
def test_recommend_for_session_matches_jax(history):
    jm, params, state, tm = _models(history, seed=3)
    x, _ = _data(history, n=40, seed=5)
    jm.compile(optimizer="adam", loss=LOSS, mesh=_mesh())
    jm.estimator.initial_weights = (params, state)
    tm.compile(optimizer="adam", loss=LOSS, device="cpu")
    for zero_based in (True, False):
        want = jm.recommend_for_session(x, max_items=5,
                                        zero_based_label=zero_based)
        got = tm.recommend_for_session(x, max_items=5,
                                       zero_based_label=zero_based)
        assert len(got) == len(want) == 40
        for g, w in zip(got, want):
            assert [i for i, _ in g] == [i for i, _ in w]
            np.testing.assert_allclose([p for _, p in g],
                                       [p for _, p in w], rtol=0, atol=1e-6)
    probs = tm.predict(x)
    top = np.sort(probs, axis=-1)[:, ::-1][:, :6]
    assert np.all(np.diff(top, axis=-1) < 0), "ties in the top 6"
    for name in ("recommend_for_user", "recommend_for_item",
                 "predict_user_item_pair"):
        with pytest.raises(Exception, match="Unsupported"):
            getattr(tm, name)(np.zeros((2, 2), np.int32), 3)


@pytest.mark.parametrize("history", [False, True])
def test_bundles_load_both_ways(tmp_path, history):
    jm, params, state, _ = _models(history, seed=4)
    x, _ = _data(history, n=40, seed=6)
    jm.compile(optimizer="adam", loss=LOSS, mesh=_mesh())
    jm.estimator.initial_weights = (params, state)
    want = np.asarray(jm.predict(x))
    jm.save_model(str(tmp_path / "jax"))
    tm = SessionRecommender.load_model(str(tmp_path / "jax"), device="cpu")
    tm.compile(optimizer="adam", loss=LOSS, device="cpu")
    np.testing.assert_allclose(tm.predict(x), want, rtol=0, atol=1e-6)
    other = SessionRecommender(ITEMS, EMBED, device="cpu", seed=9,
                               **_kw(history))
    other.compile(optimizer="adam", loss=LOSS, device="cpu")
    mine = other.predict(x)
    other.save_model(str(tmp_path / "port"))
    jback = JSession.load_model(str(tmp_path / "port"))
    jback.compile(optimizer="adam", loss=LOSS, mesh=_mesh())
    np.testing.assert_allclose(np.asarray(jback.predict(x)), mine, rtol=0,
                               atol=1e-6)
