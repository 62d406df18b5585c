"""The layer library of the PyTorch port against the JAX package's layers,
on the CPU: every layer of ``nn/layers`` that the port adds beside the
ones of the earlier slices (core, convolution, extended convolution,
advanced activations, elementwise, CRF, ConvLSTM, merge modes), the
regularizers and initializers, and the names of ``nn.layers.__all__``.

Each layer is built by JAX, its parameters (moved away from their
initial constants where those are trivial) loaded into the port's layer
through ``analytics_zoo_tpu_torch.bridge``, and both run on the same
seeded input: outputs within 1e-5 (and, for the layers with parameters,
the gradients of a seeded cotangent with respect to the parameters and
the input). The random layers in training mode (GaussianNoise,
GaussianDropout, RReLU, the spatial dropouts, GaussianSampler) take the
same key in both: the bernoulli and uniform draws are JAX's bits, so
their masks and slopes are equal; the normal draws are JAX's within
about one ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn import module as jmod
from analytics_zoo_tpu.nn import regularizers as jreg
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu_torch.bridge import state_dict_from_jax
from analytics_zoo_tpu_torch.common import prng
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn import module as tmod
from analytics_zoo_tpu_torch.nn import regularizers as treg
from analytics_zoo_tpu_torch.nn.topology import Sequential

TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_() if grad else t


def _leaves(v):
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in _leaves(e)]
    return [v]


def _close(want, got, tol=TOL, scaled=False):
    """Equal shapes, equal integers, floats within ``tol`` (``scaled``:
    times the largest magnitude when above 1, for gradients that sum
    over many positions)."""
    want, got = _leaves(want), _leaves(got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w = np.asarray(w)
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else \
            np.asarray(g)
        assert w.shape == g.shape, (w.shape, g.shape)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w)
        else:
            scale = max(1.0, float(np.abs(w).max())) if scaled and w.size \
                else 1.0
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)


def check(jl, tl, xs, *, training=False, key=None, randomize=False,
          grads=False, tol=TOL, seed=0):
    """Build both layers from the JAX weights, hold the outputs (and with
    ``grads`` the gradients of a seeded cotangent) to JAX's."""
    multi = isinstance(xs, list)
    in_shape = [x.shape[1:] for x in xs] if multi else xs.shape[1:]
    params, state = jl.build(jax.random.PRNGKey(seed), in_shape)
    params, state = _np(params), _np(state)
    if randomize:
        rng = np.random.default_rng(seed + 100)
        params = jax.tree_util.tree_map(
            lambda a: (a + rng.normal(size=a.shape) * 0.3).astype(a.dtype),
            params)
    tl.build(in_shape, torch.Generator().manual_seed(0))
    tl.built = True
    if params or state:
        tl.load_state_dict(state_dict_from_jax(params, state))
    jkey = jax.random.PRNGKey(key) if key is not None else None
    tkw = {"rng": prng.PRNGKey(key)} if key is not None else {}

    def japply(p, x):
        return jl.apply(p, state, x, training=training, rng=jkey)[0]

    want = japply(params, xs)
    tl.train(training)
    tx = [_to_t(x, grads) for x in xs] if multi else _to_t(xs, grads)
    got = tl(tx, **tkw)
    _close(want, got, tol)
    if grads:
        cot = np.random.default_rng(seed + 7).normal(
            size=np.shape(want)).astype(np.float32)
        _, vjp = jax.vjp(japply, params, xs)
        gp, gx = vjp(jnp.asarray(cot))
        (got * torch.from_numpy(cot)).sum().backward()
        for name, p in tl.named_parameters():
            _close(gp[name], p.grad, tol, scaled=True)
        _close(gx, [t.grad for t in tx] if multi else tx.grad, tol,
               scaled=True)
    return want, got


def _x(*shape, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ the names
def test_every_name_of_the_jax_layers_is_ported():
    missing = set(JL.__all__) - set(TL.__all__)
    assert missing == set()
    assert all(hasattr(TL, n) for n in TL.__all__)
    for alias, name in [("Conv1D", "Convolution1D"),
                        ("Conv2D", "Convolution2D"),
                        ("Conv3D", "Convolution3D"),
                        ("ShareConv2D", "ShareConvolution2D"),
                        ("Input", "InputLayer"),
                        ("LayerNorm", "LayerNormalization")]:
        assert getattr(TL, alias) is getattr(TL, name)


# ------------------------------------------------------- elementwise math
MATH = {
    "AddConstant": lambda m: m.AddConstant(2.5),
    "MulConstant": lambda m: m.MulConstant(-3.0),
    "Exp": lambda m: m.Exp(), "Log": lambda m: m.Log(),
    "Power": lambda m: m.Power(2.0, scale=3.0, shift=1.0),
    "Sqrt": lambda m: m.Sqrt(), "Square": lambda m: m.Square(),
    "Negative": lambda m: m.Negative(), "Identity": lambda m: m.Identity(),
    "ERF": lambda m: m.ERF(),
}


@pytest.mark.parametrize("name", sorted(MATH))
def test_elementwise_math_layers(name):
    check(MATH[name](JL), MATH[name](TL), _x(4, 5, lo=0.5, hi=2.0))


THRESH = {
    "Threshold": lambda m: m.Threshold(0.2, -1.5),
    "BinaryThreshold": lambda m: m.BinaryThreshold(0.1),
    "HardTanh": lambda m: m.HardTanh(-0.5, 0.7),
    "HardShrink": lambda m: m.HardShrink(0.4),
    "SoftShrink": lambda m: m.SoftShrink(0.4),
}


@pytest.mark.parametrize("name", sorted(THRESH))
def test_threshold_family(name):
    check(THRESH[name](JL), THRESH[name](TL), _x(6, 7, seed=1))


LEARNABLE = {
    "Mul": lambda m: m.Mul(), "CAdd": lambda m: m.CAdd((1, 5)),
    "CMul": lambda m: m.CMul((1, 5)), "Scale": lambda m: m.Scale((1, 5)),
}


@pytest.mark.parametrize("name", sorted(LEARNABLE))
def test_learnable_pointwise_layers(name):
    check(LEARNABLE[name](JL), LEARNABLE[name](TL), _x(3, 4, 5, seed=2),
          randomize=True, grads=True)


# ------------------------------------------------------- shape and table
def test_shape_and_table_layers():
    x = _x(2, 6, 4, seed=3)
    check(JL.GetShape(), TL.GetShape(), x)
    for rv in (True, False):
        check(JL.Max(1, return_value=rv), TL.Max(1, return_value=rv), x)
    check(JL.SelectTable(1), TL.SelectTable(1), [x, x * 2, x * 3])
    check(JL.SplitTensor(1, 2), TL.SplitTensor(1, 2), x)
    check(JL.Expand((2, 6, 4)), TL.Expand((2, 6, 4)), x[:, :1, :])
    check(JL.MM(trans_b=True), TL.MM(trans_b=True), [x, _x(2, 5, 4)])
    check(JL.MM(trans_a=True), TL.MM(trans_a=True), [x, _x(2, 6, 3)])


CORE = {
    "Flatten": (lambda m: m.Flatten(), (2, 3, 4, 5)),
    "Reshape": (lambda m: m.Reshape((-1, 10)), (2, 3, 4, 5)),
    "Permute": (lambda m: m.Permute((3, 1, 2)), (2, 3, 4, 5)),
    "RepeatVector": (lambda m: m.RepeatVector(3), (2, 5)),
    "Squeeze": (lambda m: m.Squeeze(1), (2, 3, 1, 5)),
    "ExpandDim": (lambda m: m.ExpandDim(1), (2, 3, 5)),
}


@pytest.mark.parametrize("name", sorted(CORE))
def test_core_shape_layers(name):
    make, shape = CORE[name]
    jl, tl = make(JL), make(TL)
    want, _ = check(jl, tl, _x(*shape, seed=4))
    assert tuple(want.shape[1:]) == tuple(tl.compute_output_shape(shape[1:]))


def test_masking_zeroes_masked_steps():
    x = _x(3, 5, 4, seed=5)
    x[0, 1] = 0.0
    x[2, 3] = 0.0
    want, _ = check(JL.Masking(0.0), TL.Masking(0.0), x)
    assert np.all(np.asarray(want)[0, 1] == 0)


@pytest.mark.parametrize("name", ["GaussianNoise", "GaussianDropout"])
def test_gaussian_noise_layers_draw_jax_normals(name):
    make = {"GaussianNoise": lambda m: m.GaussianNoise(0.3),
            "GaussianDropout": lambda m: m.GaussianDropout(0.2)}[name]
    x = _x(4, 6, 3, seed=6)
    want, got = check(make(JL), make(TL), x, training=True, key=5, tol=1e-6)
    assert not np.allclose(np.asarray(want), x)
    check(make(JL), make(TL), x)                     # the identity at eval


def test_highway_and_maxout_dense():
    x = _x(8, 5, seed=7)
    check(JL.Highway(activation="relu"), TL.Highway(activation="relu"), x,
          randomize=True, grads=True)
    check(JL.MaxoutDense(3, nb_feature=4), TL.MaxoutDense(3, nb_feature=4),
          x, randomize=True, grads=True)


# --------------------------------------------------- advanced activations
ACT = {
    "LeakyReLU": lambda m: m.LeakyReLU(0.3), "ELU": lambda m: m.ELU(1.2),
    "ThresholdedReLU": lambda m: m.ThresholdedReLU(0.8),
    "Softmax": lambda m: m.Softmax(), "PReLU": lambda m: m.PReLU(),
    "PReLU_per_channel": lambda m: m.PReLU(6),
    "RReLU_eval": lambda m: m.RReLU(0.1, 0.3),
}


@pytest.mark.parametrize("name", sorted(ACT))
def test_parametric_activations(name):
    check(ACT[name](JL), ACT[name](TL), _x(5, 6, seed=8),
          randomize=name.startswith("PReLU"),
          grads=name.startswith("PReLU"))


def test_rrelu_training_draws_jax_slopes():
    x = _x(5, 6, seed=9)
    want, got = check(JL.RReLU(0.1, 0.3), TL.RReLU(0.1, 0.3), x,
                      training=True, key=7, tol=0)
    neg = x < 0
    ratio = np.asarray(want)[neg] / x[neg]
    assert ratio.min() >= 0.1 - 1e-6 and ratio.max() <= 0.3 + 1e-6


@pytest.mark.parametrize("shared", [None, (1, 2)])
def test_srelu(shared):
    check(JL.SReLU(shared_axes=shared), TL.SReLU(shared_axes=shared),
          _x(3, 4, 5, 3, seed=10) * 2, randomize=True, grads=True)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_spatial_dropout_masks_equal_jax(n):
    jl = getattr(JL, f"SpatialDropout{n}D")(0.5)
    tl = getattr(TL, f"SpatialDropout{n}D")(0.5)
    x = _x(*((4,) + (3,) * n + (8,)), seed=11)
    want, _ = check(jl, tl, x, training=True, key=3, tol=0)
    per = np.asarray(want).reshape(4, -1, 8)
    assert ((per == 0).all(axis=1) | (per != 0).all(axis=1)).all()
    assert (per == 0).any()
    check(jl, tl, x)                                 # the identity at eval


# ------------------------------------------------- sampler and wrapper
def test_gaussian_sampler_and_wrapper():
    mean, log_var = _x(8, 3, seed=12), _x(8, 3, seed=13)
    check(JL.GaussianSampler(), TL.GaussianSampler(), [mean, log_var],
          training=True, key=0, tol=1e-6)
    check(JL.GaussianSampler(), TL.GaussianSampler(), [mean, log_var])
    check(JL.KerasLayerWrapper(JL.Dense(4)),
          TL.KerasLayerWrapper(TL.Dense(4)), mean, grads=True)
    check(JL.KerasLayerWrapper(lambda x: x * 2),
          TL.KerasLayerWrapper(lambda x: x * 2), mean)


# ------------------------------------------------------- convolutions
@pytest.mark.parametrize("padding,stride", [("valid", 1), ("same", 2)])
def test_conv3d(padding, stride):
    kw = dict(border_mode=padding, subsample=(stride,) * 3,
              activation="relu")
    check(JL.Convolution3D(4, 2, 3, 2, **kw), TL.Convolution3D(4, 2, 3, 2, **kw),
          _x(2, 5, 6, 5, 3, seed=14), randomize=True, grads=True)


@pytest.mark.parametrize("stride", [(1, 1), (2, 3)])
def test_deconvolution2d_is_jax_conv_transpose(stride):
    jl = JL.Deconvolution2D(4, 3, 2, subsample=stride)
    tl = TL.Deconvolution2D(4, 3, 2, subsample=stride)
    want, _ = check(jl, tl, _x(2, 5, 4, 3, seed=15), randomize=True,
                    grads=True)
    # JAX's VALID transpose: in * s + max(k - s, 0) a dim (its
    # compute_output_shape says (in - 1) * s + k, one short at s > k)
    assert tuple(want.shape[1:]) == tl.compute_output_shape((5, 4, 3))


@pytest.mark.parametrize("padding", ["valid", "same"])
def test_atrous_convolutions(padding):
    check(JL.AtrousConvolution2D(4, 3, 3, atrous_rate=(2, 2),
                                 border_mode=padding),
          TL.AtrousConvolution2D(4, 3, 3, atrous_rate=(2, 2),
                                 border_mode=padding),
          _x(2, 9, 10, 3, seed=16), randomize=True, grads=True)
    check(JL.AtrousConvolution1D(4, 3, atrous_rate=2, border_mode=padding),
          TL.AtrousConvolution1D(4, 3, atrous_rate=2, border_mode=padding),
          _x(2, 11, 3, seed=17), randomize=True, grads=True)


@pytest.mark.parametrize("padding,stride,mult", [("valid", 1, 1),
                                                 ("same", 2, 2)])
def test_separable_convolution(padding, stride, mult):
    kw = dict(border_mode=padding, subsample=(stride, stride),
              depth_multiplier=mult)
    check(JL.SeparableConvolution2D(5, 3, 3, **kw),
          TL.SeparableConvolution2D(5, 3, 3, **kw),
          _x(2, 9, 8, 3, seed=18), randomize=True, grads=True)


@pytest.mark.parametrize("padding,stride,mult", [("same", 1, 1),
                                                 ("same", 2, 2),
                                                 ("valid", 2, 1)])
def test_depthwise_conv2d(padding, stride, mult):
    """Asymmetric SAME padding at stride 2, channel order c·mult + j."""
    kw = dict(border_mode=padding, subsample=(stride, stride),
              depth_multiplier=mult)
    check(JL.DepthwiseConv2D((3, 3), **kw), TL.DepthwiseConv2D((3, 3), **kw),
          _x(2, 8, 9, 4, seed=19), grads=True)


@pytest.mark.parametrize("propagate_back", [True, False])
def test_share_convolution(propagate_back):
    kw = dict(pad_h=1, pad_w=2, propagate_back=propagate_back)
    jl, tl = JL.ShareConvolution2D(4, 3, 3, **kw), \
        TL.ShareConvolution2D(4, 3, 3, **kw)
    x = _x(2, 6, 7, 3, seed=20)
    if propagate_back:
        check(jl, tl, x, randomize=True, grads=True)
    else:
        check(jl, tl, x, randomize=True)
        xt = _to_t(x, True)
        tl(xt).sum().backward()
        assert xt.grad is None or not xt.grad.any()


def test_locally_connected_layers():
    check(JL.LocallyConnected2D(3, 2, 3, subsample=(2, 1)),
          TL.LocallyConnected2D(3, 2, 3, subsample=(2, 1)),
          _x(2, 7, 6, 3, seed=21), randomize=True, grads=True)
    check(JL.LocallyConnected1D(3, 3, subsample_length=2),
          TL.LocallyConnected1D(3, 3, subsample_length=2),
          _x(2, 9, 4, seed=22), randomize=True, grads=True)


CROP_PAD_UP = {
    "Cropping1D": (lambda m: m.Cropping1D((1, 2)), (2, 8, 3)),
    "Cropping2D": (lambda m: m.Cropping2D(((1, 0), (2, 1))), (2, 6, 7, 3)),
    "Cropping3D": (lambda m: m.Cropping3D(((1, 1), (0, 1), (1, 0))),
                   (2, 4, 5, 6, 3)),
    "ZeroPadding1D": (lambda m: m.ZeroPadding1D((1, 2)), (2, 5, 3)),
    "ZeroPadding2D": (lambda m: m.ZeroPadding2D((1, 2)), (2, 4, 5, 3)),
    "ZeroPadding3D": (lambda m: m.ZeroPadding3D((1, 0, 2)),
                      (2, 3, 4, 2, 3)),
    "UpSampling1D": (lambda m: m.UpSampling1D(3), (2, 4, 3)),
    "UpSampling2D": (lambda m: m.UpSampling2D((2, 3)), (2, 3, 4, 2)),
    "UpSampling3D": (lambda m: m.UpSampling3D((2, 1, 3)), (2, 2, 3, 2, 2)),
}


@pytest.mark.parametrize("name", sorted(CROP_PAD_UP))
def test_crop_pad_upsample(name):
    make, shape = CROP_PAD_UP[name]
    tl = make(TL)
    want, _ = check(make(JL), tl, _x(*shape, seed=23))
    assert tuple(want.shape[1:]) == tuple(tl.compute_output_shape(shape[1:]))


POOLS = {
    "MaxPooling1D": (lambda m: m.MaxPooling1D(3, 2, "same"), (2, 9, 3)),
    "AveragePooling1D": (lambda m: m.AveragePooling1D(3, 2, "same"),
                         (2, 9, 3)),
    "AveragePooling1D_valid": (lambda m: m.AveragePooling1D(2), (2, 9, 3)),
    "AveragePooling2D": (lambda m: m.AveragePooling2D((3, 3), (2, 2),
                                                      "same"), (2, 7, 8, 3)),
    "AveragePooling2D_valid": (lambda m: m.AveragePooling2D(), (2, 7, 8, 3)),
    "MaxPooling3D": (lambda m: m.MaxPooling3D((2, 2, 2)), (2, 5, 4, 6, 3)),
    "MaxPooling3D_same": (lambda m: m.MaxPooling3D((3, 2, 3), (2, 2, 2),
                                                   "same"), (2, 5, 4, 6, 3)),
    "AveragePooling3D": (lambda m: m.AveragePooling3D((3, 2, 3), (2, 2, 2),
                                                      "same"),
                         (2, 5, 4, 6, 3)),
    "GlobalAveragePooling1D": (lambda m: m.GlobalAveragePooling1D(),
                               (2, 5, 3)),
    "GlobalMaxPooling2D": (lambda m: m.GlobalMaxPooling2D(), (2, 4, 5, 3)),
    "GlobalMaxPooling3D": (lambda m: m.GlobalMaxPooling3D(),
                           (2, 3, 4, 5, 3)),
    "GlobalAveragePooling3D": (lambda m: m.GlobalAveragePooling3D(),
                               (2, 3, 4, 5, 3)),
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pooling_layers(name):
    make, shape = POOLS[name]
    tl = make(TL)
    want, _ = check(make(JL), tl, _x(*shape, seed=24))
    assert tuple(want.shape[1:]) == tuple(tl.compute_output_shape(shape[1:]))


@pytest.mark.parametrize("out,align", [((7, 9), False), ((3, 2), False),
                                       ((7, 9), True), ((1, 1), True)])
def test_resize_bilinear_keeps_tf1_coordinates(out, align):
    check(JL.ResizeBilinear(*out, align_corners=align),
          TL.ResizeBilinear(*out, align_corners=align),
          _x(2, 4, 5, 3, seed=25), grads=True)


@pytest.mark.parametrize("n", [5, 4])
def test_lrn_layers_pad_as_xla(n):
    """An even window pads one more high than low (XLA SAME)."""
    x = _x(2, 5, 6, 7, seed=26) * 3
    check(JL.LRN2D(alpha=1e-2, n=n), TL.LRN2D(alpha=1e-2, n=n), x,
          grads=True)
    check(JL.WithinChannelLRN2D(size=n, alpha=0.5),
          TL.WithinChannelLRN2D(size=n, alpha=0.5), x, grads=True)


# ----------------------------------------------------------- ConvLSTM
@pytest.mark.parametrize("padding,stride,seq,back", [
    ("valid", 1, False, False), ("same", 2, True, False),
    ("same", 1, True, True)])
def test_conv_lstm_2d(padding, stride, seq, back):
    kw = dict(border_mode=padding, subsample=stride, return_sequences=seq,
              go_backwards=back)
    tl = TL.ConvLSTM2D(4, 3, **kw)
    want, _ = check(JL.ConvLSTM2D(4, 3, **kw), tl, _x(2, 3, 6, 7, 2,
                                                      seed=27),
                    randomize=True, grads=True)
    assert tuple(want.shape[1:]) == tl.compute_output_shape((3, 6, 7, 2))


def test_conv_lstm_3d():
    check(JL.ConvLSTM3D(3, 2, border_mode="same", return_sequences=True),
          TL.ConvLSTM3D(3, 2, border_mode="same", return_sequences=True),
          _x(2, 3, 3, 4, 3, 2, seed=28), randomize=True, grads=True)


# --------------------------------------------------------------- merge
@pytest.mark.parametrize("mode", ["mul", "ave", "max", "min", "dot", "cos"])
def test_merge_modes(mode):
    xs = [_x(3, 5, seed=29), _x(3, 5, seed=30)]
    tl = TL.Merge(mode=mode)
    want, _ = check(JL.Merge(mode=mode), tl, xs, grads=True)
    assert tuple(want.shape[1:]) == tl.compute_output_shape([(5,), (5,)])
    xs[1][0] = 0.0                    # a zero vector: cos's 1e-8 matters
    check(JL.Merge(mode=mode), TL.Merge(mode=mode), xs)


# ------------------------------------------------------------------ CRF
def _crf_inputs(seed=31, b=3, t=6, e=4):
    rng = np.random.default_rng(seed)
    em = rng.normal(size=(b, t, e)).astype(np.float32)
    tags = rng.integers(0, e, (b, t)).astype(np.int32)
    lengths = np.array([t, t - 2, 1])
    mask = np.arange(t)[None] < lengths[:, None]
    trans = rng.normal(size=(e, e)).astype(np.float32)
    start, end = rng.normal(size=(2, e)).astype(np.float32)
    return em, tags, mask, trans, start, end


def test_crf_log_likelihood_and_decode():
    em, tags, mask, trans, start, end = _crf_inputs()
    want = JL.crf_log_likelihood(em, tags, mask, trans, start, end)
    got = TL.crf_log_likelihood(*map(_to_t, (em, tags, mask, trans, start,
                                             end)))
    _close(want, got)
    want = JL.crf_decode(em, mask, trans, start, end)
    got = TL.crf_decode(*map(_to_t, (em, mask, trans, start, end)))
    _close(want, got)


def test_crf_layer_nll_and_gradients():
    from analytics_zoo_tpu.nn.layers.crf import \
        crf_nll_from_packed as jnll

    em, tags, mask, *_ = _crf_inputs(seed=32)
    tags = np.where(mask, tags, -1).astype(np.int32)
    jl, tl = JL.CRF(4), TL.CRF(4)
    params, _ = jl.build(jax.random.PRNGKey(0), (6, 4))
    params = jax.tree_util.tree_map(
        lambda a: np.random.default_rng(a.size).normal(size=a.shape).astype(
            np.float32), _np(params))
    tl.build((6, 4), None)
    tl.load_state_dict(state_dict_from_jax(params))

    def jloss(p, e):
        out, _ = jl.apply(p, {}, e)
        return jnll(jnp.asarray(tags), *out)

    want, (gp, ge) = jax.value_and_grad(jloss, argnums=(0, 1))(params, em)
    et = _to_t(em, True)
    got = TL.crf_nll_from_packed(_to_t(tags), *tl(et))
    got.backward()
    _close(want, got)
    _close(ge, et.grad)
    for name, p in tl.named_parameters():
        _close(gp[name], p.grad)


# ------------------------------------------------ regularizers, inits
def test_regularizers_match_jax():
    w = _x(4, 5, seed=33)
    for j, t in [(jreg.L1(0.03), treg.L1(0.03)), (jreg.L2(0.02),
                                                  treg.L2(0.02)),
                 (jreg.L1L2(0.01, 0.04), treg.L1L2(0.01, 0.04))]:
        _close(j(w), t(_to_t(w)))
    for name in ("l1", "l2", "l1l2", "l1_l2"):
        assert type(treg.get_regularizer(name)).__name__ == type(
            jreg.get_regularizer(name)).__name__
    with pytest.raises(ValueError, match="unknown regularizer"):
        treg.get_regularizer("l3")
    # a Dense's term is JAX's; CAdd's and CMul's are their one tensor's
    jd = JL.Dense(3, w_regularizer="l2", b_regularizer=jreg.L1(0.5))
    td = TL.Dense(3, w_regularizer="l2", b_regularizer=treg.L1(0.5))
    check(jd, td, w, randomize=True)
    params = {"kernel": td.kernel.detach().numpy(),
              "bias": td.bias.detach().numpy()}
    _close(jd.regularization(params), td.regularization())
    ca = TL.CAdd((5,), b_regularizer="l2")
    ca.build((5,), None)
    with torch.no_grad():
        ca.bias.fill_(2.0)
    _close(np.float32(0.01 * 4.0 * 5), ca.regularization())
    cm = TL.CMul((5,), w_regularizer=treg.L1(0.1))
    cm.build((5,), None)
    _close(np.float32(0.1 * 5), cm.regularization())


@pytest.mark.parametrize("name", ["glorot_normal", "he_normal",
                                  "lecun_normal", "glorot_uniform",
                                  "normal", "uniform"])
def test_initializers_have_the_jax_spread(name):
    """The port draws from a torch generator: its fans and spread are
    JAX's, not its bits."""
    shape = (3, 3, 32, 64)
    want = np.asarray(jmod.get_initializer(name)(jax.random.PRNGKey(0),
                                                 shape, jnp.float32))
    got = tmod.get_initializer(name)(torch.Generator().manual_seed(0),
                                     shape).numpy()
    assert got.shape == shape and got.dtype == np.float32
    assert abs(got.std() / want.std() - 1) < 0.03
    assert abs(got.mean()) < 0.03 * want.std()
    with pytest.raises(ValueError, match="unknown initializer"):
        tmod.get_initializer("orthogonal")


# ----------------------------------------------------- in a Sequential
def test_new_layers_train_in_a_sequential():
    """A Sequential of new layers: the forward and the gradient of its
    loss with the JAX weights."""
    def build(m, seq):
        return seq([m.Convolution2D(4, 3, 3, border_mode="same",
                                    input_shape=(8, 8, 3)),
                    m.PReLU(4), m.LRN2D(alpha=1e-2, n=3),
                    m.SeparableConvolution2D(6, 3, 3, border_mode="same"),
                    m.AveragePooling2D(), m.Flatten(),
                    m.Highway(activation="tanh"),
                    m.Dense(3, w_regularizer=m_reg(m))])

    def m_reg(m):
        return (jreg if m is JL else treg).L2(0.01)

    jm = build(JL, JSequential)
    params, state = jm.build(jax.random.PRNGKey(2))
    tm = build(TL, lambda ls: Sequential(ls, device="cpu"))
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    x = _x(4, 8, 8, 3, seed=34)

    def jloss(p):
        y, _ = jm.apply(p, state, x, training=True)
        return jnp.mean(y * y) + jm.regularization(p)

    want, grads = jax.value_and_grad(jloss)(params)
    tm.train()
    y = tm.apply(_to_t(x))
    got = torch.mean(y * y) + tm.regularization()
    got.backward()
    _close(want, got)
    for name, p in tm.named_parameters():
        slot, leaf = name.split(".")
        _close(grads[slot][leaf], p.grad)
