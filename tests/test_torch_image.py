"""Parity of the port's image path with the JAX package, on the CPU: the
layers of the ResNet backbones, the graph containers and their slot names,
ResNet-50 in float and after ``quantize_int8``, and ImageClassifier.

Weights are the JAX layers' own ``build`` draws, loaded through
``analytics_zoo_tpu_torch.bridge``; BatchNormalization's moving statistics
are seeded away from (0, 1) so that they matter. Layers agree within 1e-5,
the float ResNet-50 within 1e-4; the int8 ResNet-50 is held to the JAX
InferenceModel on the TPU's route (fused Pallas kernels interpreted, the
TPU's tiling floor) within 1e-4 with the same argmax.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.inference import InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.models.image import backbones as jbb
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.ops import int8_fused as jfused
from analytics_zoo_tpu.ops import tuning
from analytics_zoo_tpu_torch.bridge import params_from_jax, state_dict_from_jax
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.image import backbones as tbb
from analytics_zoo_tpu_torch.models.image.classification import ImageClassifier
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.ops.int8 import quantize_weight

TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(want, got, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert want.shape == got.shape
    err = float(np.abs(want - got).max())
    assert err <= tol, f"max |diff| {err} > {tol}"


def _bn_state(state, seed=0):
    """Moving statistics away from (0, 1), the same on both sides."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in _np(state).items():
        out[k] = dict(v)
        if "moving_mean" in v:
            out[k]["moving_mean"] = (rng.normal(size=v["moving_mean"].shape)
                                     * 0.1).astype(np.float32)
            out[k]["moving_var"] = rng.uniform(
                0.5, 2.0, size=v["moving_var"].shape).astype(np.float32)
    return out


def _layer_pair(jlayer, tlayer, in_shape, seed=0):
    """Build both layers, load the JAX weights (and state) into the port's."""
    params, state = jlayer.build(jax.random.PRNGKey(seed), in_shape)
    state = _bn_state({"s": state}, seed)["s"] if state else {}
    tlayer.build(in_shape, torch.Generator().manual_seed(0))
    tlayer.load_state_dict(state_dict_from_jax(_np(params), state))
    return params, state, tlayer.eval()


@pytest.mark.parametrize("stride,padding,k", [
    (1, "same", 3), (1, "valid", 3), (2, "same", 1), (2, "valid", 3),
    (2, "same", 7)])
def test_convolution2d_matches_jax(stride, padding, k):
    x = np.random.default_rng(k).normal(size=(2, 11, 12, 3)).astype(
        np.float32)
    kw = dict(subsample=(stride, stride), border_mode=padding,
              activation="relu")
    j = JL.Convolution2D(8, k, k, **kw)
    p, s, t = _layer_pair(j, TL.Convolution2D(8, k, k, **kw), (11, 12, 3))
    want, _ = j.apply(p, s, x)
    _close(want, t(torch.from_numpy(x)))
    assert tuple(want.shape[1:]) == t.compute_output_shape((11, 12, 3))


def test_batchnorm_inference_matches_jax():
    x = (np.random.default_rng(1).normal(size=(2, 5, 5, 16)) * 2 + 1
         ).astype(np.float32)
    j = JL.BatchNormalization()
    p, s, t = _layer_pair(j, TL.BatchNormalization(), (5, 5, 16))
    p = {"gamma": np.linspace(0.5, 1.5, 16, dtype=np.float32),
         "beta": np.linspace(-1, 1, 16, dtype=np.float32)}
    t.load_state_dict(state_dict_from_jax(p, s))
    want, _ = j.apply(p, s, x)
    _close(want, t(torch.from_numpy(x)))
    # training mode: the batch statistics, and the moving ones moved once
    want, new = j.apply(p, s, x, training=True)
    _close(want, t.train()(torch.from_numpy(x)))
    _close(new["moving_mean"], t.moving_mean)
    _close(new["moving_var"], t.moving_var)


@pytest.mark.parametrize("padding,pool,stride", [
    ("same", 3, 2), ("valid", 3, 2), ("valid", 2, None), ("same", 3, 1)])
def test_maxpooling_matches_jax(padding, pool, stride):
    x = np.random.default_rng(2).normal(size=(2, 9, 10, 4)).astype(
        np.float32)
    strides = None if stride is None else (stride, stride)
    j = JL.MaxPooling2D((pool, pool), strides=strides, border_mode=padding)
    t = TL.MaxPooling2D((pool, pool), strides=strides, border_mode=padding)
    want, _ = j.apply({}, {}, x)
    _close(want, t(torch.from_numpy(x)))
    assert tuple(want.shape[1:]) == t.compute_output_shape((9, 10, 4))


def test_global_average_pooling_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 7, 7, 32)).astype(
        np.float32)
    want, _ = JL.GlobalAveragePooling2D().apply({}, {}, x)
    _close(want, TL.GlobalAveragePooling2D()(torch.from_numpy(x)))


@pytest.mark.parametrize("mode", ["sum", "concat"])
def test_merge_matches_jax(mode):
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=(2, 3, 3, 4)).astype(np.float32) for _ in range(3)]
    want, _ = JL.Merge(mode=mode).apply({}, {}, xs)
    t = TL.Merge(mode=mode)
    _close(want, t([torch.from_numpy(x) for x in xs]))
    assert tuple(want.shape[1:]) == t.compute_output_shape(
        [(3, 3, 4)] * 3)
    # the other modes are ported too (dot and cos take two inputs)
    for other in ("mul", "ave", "max", "min", "dot", "cos"):
        ins = xs[:2] if other in ("dot", "cos") else xs
        want, _ = JL.Merge(mode=other).apply({}, {}, ins)
        _close(want, TL.Merge(mode=other)([torch.from_numpy(x)
                                           for x in ins]))


@pytest.mark.parametrize("activation", [None, "relu", "softmax"])
def test_dense_and_activation_match_jax(activation):
    x = np.random.default_rng(5).normal(size=(4, 24)).astype(np.float32)
    j = JL.Dense(10, activation=activation)
    p, s, t = _layer_pair(j, TL.Dense(10, activation=activation), (24,))
    want, _ = j.apply(p, s, x)
    _close(want, t(torch.from_numpy(x)))
    if activation is not None:
        want, _ = JL.Activation(activation).apply({}, {}, x)
        _close(want, TL.Activation(activation)(torch.from_numpy(x)))


@pytest.fixture(scope="module")
def jax_resnet():
    """The JAX ResNet-50 at 32x32 with 10 classes, its params and seeded
    state (built once: JAX draws each layer's init eagerly)."""
    jm = jbb.resnet50((32, 32, 3), 10)
    params, state = jm.build(jax.random.PRNGKey(0))
    return jm, _np(params), _bn_state(state)


@pytest.mark.parametrize("name", ["resnet-18", "vgg-16", "squeezenet",
                                  "alexnet", "mobilenet", "mobilenet-v2"])
def test_backbone_slots_equal_jax(name):
    """The port's state dict keys are the JAX params and state trees'
    paths (slot ``f"{i}_{type}"``, then the leaf name); the output shape
    is the same."""
    shape = (32, 32, 3)
    jm = jbb.build_backbone(name, shape, 10)
    params, state = jm.build(jax.random.PRNGKey(0))
    want = set(params_from_jax(_np(params))) | set(
        params_from_jax(_np(state)))
    tm = tbb.build_backbone(name, shape, 10, device="cpu")
    assert set(tm.state_dict()) == want
    assert [tm.slot(l) for l in tm.layers] == [jm.slot(l) for l in jm.layers]
    assert tm.output_shape == jm.output_shape
    with torch.no_grad():
        y = tm.apply(torch.zeros((1,) + shape))
    assert tuple(y.shape) == (1, 10)


def test_unknown_backbone_raises():
    with pytest.raises(ValueError, match="unknown backbone"):
        tbb.build_backbone("lenet", device="cpu")


def test_resnet50_float_matches_jax(jax_resnet):
    """Slot names and state dict keys as JAX's, outputs within 1e-4."""
    jm, params, state = jax_resnet
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want, _ = jm.apply(params, state, x)
    tm = tbb.resnet50((32, 32, 3), 10, device="cpu")
    assert [tm.slot(l) for l in tm.layers] == [jm.slot(l) for l in jm.layers]
    assert set(tm.state_dict()) == set(params_from_jax(params)) | set(
        params_from_jax(state))
    tm.load_state_dict(state_dict_from_jax(params, state))
    with torch.no_grad():
        _close(want, tm.apply(torch.from_numpy(x)), 1e-4)


def test_resnet50_int8_matches_jax_tpu_route(jax_resnet, tmp_path,
                                             monkeypatch):
    """quantize_int8 on both sides, JAX on the TPU's route: 53 convs and
    the head packed, probabilities within 1e-4, the same argmax."""
    monkeypatch.setenv("ZOO_INT8_FUSED", "interpret")
    monkeypatch.setattr(jfused, "_MIN_INTERPRET", 128)
    monkeypatch.setenv("ZOO_TPU_TUNING_CACHE", str(tmp_path / "t.json"))
    for ax in "MNK":
        monkeypatch.delenv(f"ZOO_INT8_BLOCK_{ax}", raising=False)
    tuning.invalidate()
    jm, params, state = jax_resnet
    x = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = JaxInferenceModel(max_batch_size=2).load(
        jm, params, state).quantize_int8().predict(x)
    tuning.invalidate()
    im = InferenceModel(max_batch_size=2, device="cpu").load(
        tbb.resnet50((32, 32, 3), 10, device="cpu"), params, state)
    got = im.quantize_int8().predict(x)
    assert len(im.packed_slots) == 54
    _close(want, got, 1e-4)
    assert np.array_equal(np.argmax(want, -1), np.argmax(got, -1))


def test_image_classifier_predicts_arrays():
    clf = ImageClassifier("resnet-18", (32, 32, 3), 10, device="cpu",
                          seed=1).set_top_n(3)
    x = np.random.default_rng(8).normal(size=(5, 32, 32, 3))
    probs = clf.predict(x, batch_size=2)
    assert probs.shape == (5, 10) and probs.dtype == np.float32
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    with torch.no_grad():
        whole = clf.model.apply(torch.from_numpy(x.astype(np.float32)))
    _close(whole, probs)
    # and it trains (BatchNormalization in training mode): one SGD step
    # from an ImageSet moves the weights and every BN's statistics
    from analytics_zoo_tpu_torch.data.image import ImageSet

    before = {k: v.clone() for k, v in clf.model.state_dict().items()}
    imgs = np.random.default_rng(9).integers(0, 256, (4, 40, 40, 3),
                                             dtype=np.uint8)
    clf.compile(optimizer="sgd").fit_image_set(
        ImageSet.from_arrays(imgs, [0, 3, 5, 9]), batch_size=4, nb_epoch=1)
    after = clf.model.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in after
               if k.endswith(("moving_mean", "moving_var", ".kernel")))
    assert not clf.model.training
    probs2 = clf.predict(x, batch_size=2)
    assert np.isfinite(probs2).all() and not np.allclose(probs2, probs)


def test_entry_points_need_cuda_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbb.resnet50((32, 32, 3), 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ImageClassifier("resnet-18", (32, 32, 3), 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceModel()


def test_pack_int8_keeps_the_state_dict_keys_and_adds_a_kernel_major_copy(
        jax_resnet):
    """quantize_int8 replaces each packed ``kernel`` by ``kernel_q`` and
    ``kernel_scale`` in the state dict, as JAX's packed tree has them; the
    kernel-major copy the kernels read (``kernel_qt``) is a buffer outside
    the state dict, equal to ``kernel_q`` transposed, and the state dict
    loads back into another packed model."""
    from analytics_zoo_tpu_torch.ops.int8_fused import kernel_major

    _, params, state = jax_resnet
    im = InferenceModel(max_batch_size=2, device="cpu").load(
        tbb.resnet50((32, 32, 3), 10, device="cpu"), params, state)
    before = set(im._module.state_dict())
    im.quantize_int8()
    after = im._module.state_dict()
    packed = {s for s in im.packed_slots}
    want = {k for k in before if k.rsplit(".", 1)[0] not in packed
            or not k.endswith(".kernel")}
    want |= {f"{s}.{leaf}" for s in packed for leaf in ("kernel_q",
                                                        "kernel_scale")}
    assert set(after) == want
    assert not any(k.endswith("kernel_qt") for k in after)
    layers = [l for l in im._module.layers if getattr(l, "is_int8", False)]
    assert len(layers) == 54
    for layer in layers:
        assert "kernel_qt" in dict(layer.named_buffers())
        assert torch.equal(layer.packed_kernel["qt"],
                           kernel_major(layer.kernel_q))
    other = InferenceModel(max_batch_size=2, device="cpu").load(
        tbb.resnet50((32, 32, 3), 10, device="cpu"), params,
        state).quantize_int8()
    other._module.load_state_dict(after)
    x = np.random.default_rng(9).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(other.predict(x), im.predict(x))


def test_kernel_major_copy_follows_a_rewritten_kernel():
    """``packed_kernel["qt"]`` is made again when ``kernel_q`` was written
    (load_state_dict copies in place) or replaced, never stale."""
    layer = TL.Dense(16, input_shape=(64,))
    layer.build((64,), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(10)
    w = rng.normal(size=(2, 64, 16)).astype(np.float32)
    layer.pack_int8(quantize_weight(w[0]))
    first = layer.packed_kernel["qt"]
    assert torch.equal(first, layer.kernel_q.t())
    assert layer.packed_kernel["qt"] is first             # made once
    new = quantize_weight(w[1])
    layer.load_state_dict({"kernel_q": torch.from_numpy(new["q"]),
                           "kernel_scale": torch.from_numpy(new["scale"]),
                           "bias": layer.bias.detach()})
    assert torch.equal(layer.packed_kernel["qt"],
                       torch.from_numpy(new["q"]).t())
    layer.kernel_q = torch.zeros_like(layer.kernel_q)
    assert not layer.packed_kernel["qt"].any()
