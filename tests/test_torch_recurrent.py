"""The recurrent layers, the core layers Wide & Deep and SessionRecommender
need, and the new activations of the PyTorch port against the JAX
package, on the CPU.

The same numpy-seeded inputs go through both packages, the port carrying
the JAX layer's own ``build`` weights through ``bridge.params_from_jax``.
Held within 1e-5 in f32: ``SimpleRNN``, ``LSTM`` and ``GRU`` (each with
``go_backwards`` and ``return_sequences`` on and off), ``Bidirectional``
in its four merge modes and ``TimeDistributed``, forward and the
gradients of a seeded projection of the output with respect to the input
and every parameter; ``SparseDense``, ``Select`` and ``Lambda``;
``hard_sigmoid`` and ``tanh``. The parameter names and shapes are the JAX
tree's. The JAX side runs at ``jax_default_matmul_precision="highest"``
(``tests/conftest.py``), and the port hoists the input projection of all
steps into one product, which sums in another order than JAX's per-step
product: within 1e-5, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.nn import activations as jact
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu_torch.bridge import params_from_jax
from analytics_zoo_tpu_torch.nn import activations as tact
from analytics_zoo_tpu_torch.nn import layers as TL

B, T, D, H = 3, 5, 4, 6
TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(jl, tl, in_shape, seed=1):
    """Build the JAX layer, build the port's and load the JAX weights."""
    params, state = jl.build(jax.random.PRNGKey(seed), in_shape)
    tl.build(in_shape, torch.Generator().manual_seed(0))
    tl.built = True
    tl.load_state_dict(params_from_jax(_np(params)))
    return params, state


def _check_forward_and_grads(jl, tl, x, params, state, tol=TOL):
    """Forward, then d(sum(y * w))/d(x, params) for a seeded ``w``, both
    packages, within ``tol``."""
    want, _ = jl.apply(params, state, x)
    w = np.random.default_rng(7).normal(size=np.shape(want)).astype(
        np.float32)

    def objective(p, xx):
        y, _ = jl.apply(p, state, xx)
        return jnp.sum(y * w)

    gp, gx = jax.grad(objective, argnums=(0, 1))(params, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tl.apply(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=tol)
    flat = params_from_jax(_np(gp))
    named = dict(tl.named_parameters())
    assert sorted(named) == sorted(flat)
    for name, g in flat.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   rtol=0, atol=tol, err_msg=name)


def _x(shape=(B, T, D), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("go_backwards", [False, True])
@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
def test_rnn_matches_jax(cls, go_backwards, return_sequences):
    kw = dict(go_backwards=go_backwards, return_sequences=return_sequences)
    jl, tl = getattr(JL, cls)(H, **kw), getattr(TL, cls)(H, **kw)
    params, state = _pair(jl, tl, (T, D))
    assert tl.compute_output_shape((T, D)) == jl.compute_output_shape((T, D))
    _check_forward_and_grads(jl, tl, _x(), params, state)


def test_lstm_unit_forget_bias_and_activations_match_jax():
    jl = JL.LSTM(H, unit_forget_bias=True, activation="relu",
                 inner_activation="sigmoid", return_sequences=True)
    tl = TL.LSTM(H, unit_forget_bias=True, activation="relu",
                 inner_activation="sigmoid", return_sequences=True)
    params, _ = jl.build(jax.random.PRNGKey(2), (T, D))
    tl.build((T, D), torch.Generator().manual_seed(0))
    want = np.zeros(4 * H, np.float32)
    want[H:2 * H] = 1.0
    np.testing.assert_array_equal(np.asarray(params["bias"]), want)
    np.testing.assert_array_equal(tl.bias.detach().numpy(), want)
    tl.load_state_dict(params_from_jax(_np(params)))
    _check_forward_and_grads(jl, tl, _x(seed=3), params, {})


@pytest.mark.parametrize("merge_mode", ["concat", "sum", "mul", "ave"])
def test_bidirectional_matches_jax(merge_mode):
    jl = JL.Bidirectional(JL.GRU(H, return_sequences=True),
                          merge_mode=merge_mode)
    tl = TL.Bidirectional(TL.GRU(H, return_sequences=True),
                          merge_mode=merge_mode)
    params, state = _pair(jl, tl, (T, D))
    assert set(params) == {"forward", "backward"}
    assert tl.compute_output_shape((T, D)) == jl.compute_output_shape((T, D))
    assert tl._modules["backward"].name.endswith("_bwd")
    assert tl._modules["backward"].go_backwards
    assert not tl._modules["forward"].go_backwards
    _check_forward_and_grads(jl, tl, _x(seed=4), params, state)


def test_bidirectional_rejects_what_jax_rejects_and_built_layers():
    with pytest.raises(ValueError, match="merge_mode"):
        TL.Bidirectional(TL.LSTM(H), merge_mode="max")
    built = TL.LSTM(H)
    built.build((T, D), torch.Generator().manual_seed(0))
    built.built = True
    with pytest.raises(ValueError, match="unbuilt"):
        TL.Bidirectional(built)


def test_time_distributed_matches_jax_with_the_flat_tree():
    jl = JL.TimeDistributed(JL.Dense(7, activation="relu"))
    tl = TL.TimeDistributed(TL.Dense(7, activation="relu"))
    params, state = _pair(jl, tl, (T, D))
    assert sorted(tl.state_dict()) == sorted(params) == ["bias", "kernel"]
    assert tl.compute_output_shape((T, D)) == jl.compute_output_shape((T, D))
    _check_forward_and_grads(jl, tl, _x(seed=5), params, state)
    tl.train()
    assert tl.layer.training
    tl.eval()
    assert not tl.layer.training


def test_recurrent_stack_in_a_graph_matches_jax():
    """Embedding -> GRU (sequences) -> LSTM, in a functional model: the
    slot keys and the forward are the JAX model's."""
    from analytics_zoo_tpu.nn.graph import Input as JInput
    from analytics_zoo_tpu.nn.topology import Model as JModel
    from analytics_zoo_tpu_torch.bridge import state_dict_from_jax
    from analytics_zoo_tpu_torch.nn.graph import Input as TInput
    from analytics_zoo_tpu_torch.nn.topology import Model as TModel

    def build(L, Input, Model, **kw):
        i = Input((T,))
        x = L.Embedding(30, D)(i)
        x = L.GRU(H, return_sequences=True)(x)
        x = L.Bidirectional(L.LSTM(H), merge_mode="sum")(x)
        return Model(i, L.Dense(3, activation="softmax")(x), **kw)

    jm = build(JL, JInput, JModel)
    tm = build(TL, TInput, TModel, device="cpu")
    params, state = jm.build(jax.random.PRNGKey(0))
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    ids = np.random.default_rng(0).integers(0, 30, (8, T)).astype(np.int32)
    want, _ = jm.apply(params, state, ids)
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["hard_sigmoid", "tanh"])
def test_new_activations_match_jax(name):
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = jact.get_activation(name)(x)
    got = tact.get_activation(name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_sparse_dense_matches_jax():
    jl, tl = JL.SparseDense(5), TL.SparseDense(5)
    params, state = _pair(jl, tl, (9,))
    x = (np.random.default_rng(1).random((6, 9)) < 0.3).astype(np.float32)
    _check_forward_and_grads(jl, tl, x, params, state)
    assert isinstance(tl, TL.Dense)


@pytest.mark.parametrize("dim,index", [(0, 1), (1, 0), (-1, 2), (0, -1)])
def test_select_matches_jax_and_keeps_float_ids(dim, index):
    x = np.random.default_rng(2).integers(0, 6040, (4, 3, 5)).astype(
        np.float32)
    want, _ = JL.Select(dim, index).apply({}, {}, x)
    got = TL.Select(dim, index).apply(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert TL.Select(dim, index).compute_output_shape((3, 5)) == \
        JL.Select(dim, index).compute_output_shape((3, 5))


def test_lambda_matches_jax():
    x = _x((4, 3, 5), seed=6)
    jl = JL.Lambda(lambda t: jnp.sum(t, axis=1),
                   output_shape_fn=lambda s: (s[-1],))
    tl = TL.Lambda(lambda t: torch.sum(t, 1),
                   output_shape_fn=lambda s: (s[-1],))
    _check_forward_and_grads(jl, tl, x, {}, {})
    assert tl.compute_output_shape((3, 5)) == jl.compute_output_shape((3, 5))
    # a list of inputs is spread over the function's arguments
    pair = [torch.from_numpy(x), torch.from_numpy(x * 2)]
    got = TL.Lambda(lambda a, b: a - b).apply(pair)
    np.testing.assert_array_equal(got.numpy(), -x)
    assert TL.Lambda(torch.relu).compute_output_shape((3, 5)) == (3, 5)
