"""BatchNormalization in training mode in the PyTorch port against the JAX
package, on the CPU.

Held: the layer in training mode (2-D and NHWC inputs, the channel axis
last and first) gives JAX's output, new moving statistics and gradients
within 1e-5; the Estimator trains a conv + BN model 3 Adam steps with
per-step losses, parameters and moving statistics within 1e-5 of the
JAX Estimator's, alone, under ``grad_accum_steps=2`` (two updates a
step, in micro-batch order) and with a regularized Dense (the penalty
in each micro-batch's loss); a recomputed (``torch.utils.checkpoint``)
forward does not move the buffers twice; ``graph_checks`` records a step
without touching the real buffers, and a fit with it gives the same bits
as one without; a forward given fewer channels than BN was built for (an
input left sharded over a model-parallel axis) raises, naming the axis.
The mesh cases (dp: global statistics under the replicated update, local
ones then a mean under the flat one; sp, pp, ep, tp and their mixes with
dp and fsdp: the global batch's, BN's input being whole on those ranks)
are in ``tests/test_torch_update_sharding.py``, whose rank pool they
share.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils.checkpoint import checkpoint

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn import regularizers as jreg
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu_torch.bridge import params_to_numpy, state_dict_from_jax
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn import regularizers as treg
from analytics_zoo_tpu_torch.nn.topology import Sequential

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
TOL = 1e-5
N_ROWS, BATCH, IMG = 48, 16, (6, 6, 3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(want, got, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("shape,axis", [((8, 5), -1), ((4, 3, 3, 6), -1),
                                        ((4, 6, 3, 3), 1)])
def test_layer_in_training_matches_jax(shape, axis):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    cot = rng.normal(size=shape).astype(np.float32)
    jl = JL.BatchNormalization(axis=axis)
    params, state = _np(jl.build(jax.random.PRNGKey(0), shape[1:]))
    c = shape[axis]
    params = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "beta": rng.normal(size=c).astype(np.float32)}
    state = {"moving_mean": rng.normal(size=c).astype(np.float32),
             "moving_var": rng.uniform(0.5, 2, c).astype(np.float32)}

    def f(p, x):
        return jl.apply(p, state, x, training=True)

    want, new = f(params, x)
    _, vjp = jax.vjp(lambda p, x: f(p, x)[0], params, x)
    gp, gx = vjp(cot)
    tl = TL.BatchNormalization(axis=axis)
    tl.build(shape[1:], None)
    tl.load_state_dict(state_dict_from_jax(params, state))
    assert not tl.training                # inference mode until train()
    xt = torch.from_numpy(x).requires_grad_()
    y = tl.train()(xt)
    (y * torch.from_numpy(cot)).sum().backward()
    _close(want, y)
    _close(new["moving_mean"], tl.moving_mean)
    _close(new["moving_var"], tl.moving_var)
    _close(gx, xt.grad)
    _close(gp["gamma"], tl.gamma.grad)
    _close(gp["beta"], tl.beta.grad)


def test_a_recomputed_forward_moves_the_buffers_once():
    """torch.utils.checkpoint runs the forward again inside the backward;
    the buffers move only in the first run."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 5)).astype(np.float32))
    plain, ckpt = TL.BatchNormalization(), TL.BatchNormalization()
    for bn in (plain, ckpt):
        bn.build((5,), None)
        bn.train()
    plain(x.requires_grad_()).square().sum().backward()
    for reentrant in (False, True):
        ckpt.moving_mean.zero_()
        ckpt.moving_var.fill_(1.0)
        xc = x.detach().clone().requires_grad_()
        checkpoint(ckpt, xc, use_reentrant=reentrant).square().sum() \
            .backward()
        assert torch.equal(ckpt.moving_mean, plain.moving_mean)
        assert torch.equal(ckpt.moving_var, plain.moving_var)
        assert torch.equal(xc.grad, x.grad)


def _model(m, reg=False):
    kw = {}
    if reg:
        r = jreg if m is JL else treg
        kw = dict(w_regularizer=r.L2(0.05), b_regularizer=r.L1(0.02))
    # no conv bias before BN, as in the backbones: BN cancels it, so its
    # gradient is rounding noise that Adam would scale up to lr a step
    return [m.Convolution2D(4, 3, 3, use_bias=False, input_shape=IMG),
            m.BatchNormalization(), m.Activation("relu"),
            m.GlobalAveragePooling2D(), m.Dense(3, **kw)]


def _data(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_ROWS,) + IMG).astype(np.float32) * 2 + 1,
            rng.normal(size=(N_ROWS, 3)).astype(np.float32))


def _weights(jm, seed=0):
    params, state = jm.build(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    state = {k: {"moving_mean": rng.normal(size=v["moving_mean"].shape)
                 .astype(np.float32),
                 "moving_var": rng.uniform(0.5, 2, v["moving_var"].shape)
                 .astype(np.float32)} if v else v
             for k, v in _np(state).items()}
    return _np(params), state


def _jax_fit(cfg, reg, params, state):
    jm = JSequential(_model(JL, reg))
    jest = JEstimator(jm, optimizer=jopt.Adam(lr=0.01), loss="mse",
                      mesh=Mesh(np.array(jax.devices()[:1]).reshape(
                          (1,) * 6), AXES),
                      config=jconfig.TrainConfig(**cfg))
    jest.initial_weights = (params, state)
    want, step = [], jest._make_train_step()

    def record(st, b):
        st, (loss, gnorm) = step(st, b)
        want.append(float(loss))
        return st, (loss, gnorm)

    jest._train_step = record
    jest.fit(_data(), batch_size=BATCH, epochs=1, seed=4)
    return (want, _np(jest.train_state["params"]),
            _np(jest.train_state["model_state"]))


def _port_fit(cfg, reg, params, state, record_losses=True):
    tm = Sequential(_model(TL, reg), device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, state))
    est = Estimator(tm, optimizer=topt.Adam(lr=0.01), loss="mse",
                    config=TrainConfig(**cfg))
    got, step = [], est._step

    def record(b):
        loss, gnorm = step(b)
        got.append(float(loss))
        return loss, gnorm

    if record_losses:
        est._step = record
    est.fit(_data(), batch_size=BATCH, epochs=1, seed=4)
    return got, params_to_numpy(tm), tm


CASES = {"single": ({}, False), "accum2": ({"grad_accum_steps": 2}, False),
         "regularized": ({}, True),
         "regularized_accum2": ({"grad_accum_steps": 2}, True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_estimator_training_matches_jax(case):
    cfg, reg = CASES[case]
    params, state = _weights(JSequential(_model(JL, reg)))
    want, jp, js = _jax_fit(cfg, reg, params, state)
    got, tp, tm = _port_fit(cfg, reg, params, state)
    assert len(got) == len(want) == N_ROWS // BATCH
    _close(want, got, what="losses")
    for tree in (jp, js):
        for slot, d in tree.items():
            for leaf, v in d.items():
                _close(v, tp[slot][leaf], what=f"{slot}.{leaf}")
    # every step moved the statistics (K times a step under accumulation)
    assert not np.array_equal(js["1_batchnormalization"]["moving_mean"],
                              state["1_batchnormalization"]["moving_mean"])
    assert not tm.training


def test_graph_checks_leave_the_real_buffers_untouched():
    params, state = _weights(JSequential(_model(JL)))
    tm = Sequential(_model(TL), device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, state))
    est = Estimator(tm, optimizer=topt.Adam(lr=0.01), loss="mse",
                    config=TrainConfig(graph_checks="raise"))
    est._init_state(4)
    tm.train()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    est._run_graph_checks(FeatureSet.from_numpy(*_data()), BATCH)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    # and a fit with the checks gives the bits of one without (the
    # recorded step is the Estimator's own: no loss read inside it)
    _, tp, _ = _port_fit({"graph_checks": "raise"}, False, params, state,
                         record_losses=False)
    _, tp0, _ = _port_fit({}, False, params, state, record_losses=False)
    for slot, d in tp0.items():
        for leaf, v in d.items():
            np.testing.assert_array_equal(tp[slot][leaf], v)


class _StubMesh:
    size, rank = 1, None

    def __init__(self, **axes):
        self.shape = {a: axes.get(a, 1) for a in AXES}


@pytest.mark.parametrize("axis", ["tp", "sp", "pp", "ep"])
def test_an_input_narrower_than_built_raises_naming_the_axis(axis):
    """BN's moments are summed over the batch axes alone, which is right
    only while its input is whole on the model-parallel ranks: a forward
    given a block of the channels raises, naming the mesh's axis."""
    from analytics_zoo_tpu_torch.parallel import comm

    bn = TL.BatchNormalization()
    bn.build((8,), None)
    bn.train()
    shard = comm.BatchShard(0, 1, ("dp",), mesh=_StubMesh(**{axis: 4}))
    with comm.batch_shard(shard):
        with pytest.raises(ValueError, match=rf"sharded over {axis}"):
            bn(torch.zeros(4, 2))
        assert bn(torch.ones(4, 8)).shape == (4, 8)
