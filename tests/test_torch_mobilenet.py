"""The MobileNets of the PyTorch port against the JAX package, on the CPU:
MobileNet v1 at alpha 0.25 and MobileNetV2, both at 32x32x3 with 10
classes.

Held: slot names, state dict keys and output shapes equal JAX's; float
probabilities within 1e-4 with the JAX weights (BatchNormalization's
moving statistics seeded away from (0, 1)); two SGD steps of
``ImageClassifier.fit_image_set`` on a seeded ``ImageSet`` (BN in
training mode) with per-step losses, final parameters and moving
statistics within 4x the JAX Estimator's own spread under a one-ulp move
of its weights (at least 1e-5: the network at initialisation is
ill-conditioned, see the test); and ``quantize_int8``
packing the same slots as JAX's (the 1x1 convs and the head of at least
4096 weights; the depthwise convs stay float), with int8 probabilities
within 1e-4 of the JAX InferenceModel on the TPU's route (fused Pallas
kernels interpreted).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.data import image as jimg
from analytics_zoo_tpu.inference import InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.inference.inference_model import \
    _quantize_module_params as jax_quantize_params
from analytics_zoo_tpu.models.image import backbones as jbb
from analytics_zoo_tpu.models.image.classification import \
    ImageClassifier as JImageClassifier
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.ops import int8 as jint8
from analytics_zoo_tpu.ops import int8_fused as jfused
from analytics_zoo_tpu.ops import tuning
from analytics_zoo_tpu_torch.bridge import (params_from_jax, params_to_numpy,
                                            state_dict_from_jax)
from analytics_zoo_tpu_torch.data import image as timg
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.image import backbones as tbb
from analytics_zoo_tpu_torch.models.image.classification import \
    ImageClassifier
from analytics_zoo_tpu_torch.nn import optimizers as topt

SHAPE, CLASSES = (32, 32, 3), 10
AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
BUILD = {"mobilenet": dict(alpha=0.25), "mobilenet-v2": {}}
FN = {"mobilenet": "mobilenet", "mobilenet-v2": "mobilenet_v2"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bn_state(state, seed=0):
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


def _models(name, seed=0):
    jm = getattr(jbb, FN[name])(SHAPE, CLASSES, **BUILD[name])
    params, state = jm.build(jax.random.PRNGKey(seed))
    tm = getattr(tbb, FN[name])(SHAPE, CLASSES, **BUILD[name], device="cpu")
    return jm, _np(params), _bn_state(state, seed), tm


@pytest.fixture(scope="module", params=list(BUILD))
def pair(request):
    return (request.param,) + _models(request.param)


def test_slots_and_state_dict_equal_jax(pair):
    name, jm, params, state, tm = pair
    assert [tm.slot(l) for l in tm.layers] == [jm.slot(l) for l in jm.layers]
    assert set(tm.state_dict()) == set(params_from_jax(params)) | set(
        params_from_jax(state))
    for k, v in tm.state_dict().items():
        want = params_from_jax(params).get(k, params_from_jax(state).get(k))
        assert tuple(v.shape) == tuple(want.shape), k
    assert tm.output_shape == jm.output_shape == (CLASSES,)
    assert sum(type(l).__name__ == "DepthwiseConv2D" for l in tm.layers) == \
        {"mobilenet": 13, "mobilenet-v2": 17}[name]


def test_float_probabilities_match_jax(pair):
    name, jm, params, state, tm = pair
    tm.load_state_dict(state_dict_from_jax(params, state))
    x = np.random.default_rng(1).normal(size=(3,) + SHAPE).astype(
        np.float32)
    want, _ = jm.apply(params, state, x)
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    assert np.array_equal(got.argmax(-1), np.asarray(want).argmax(-1))


def _image_set(m, n=32, seed=4):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 40, 40, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, n).tolist()
    return m.ImageSet.from_arrays(imgs, labels, seed=2)


def _jax_fit(jm, params, state):
    """Two SGD steps of JAX's fit_image_set from ``(params, state)``: the
    step losses and the trained params and model state."""
    jclf = JImageClassifier("mobilenet", SHAPE, CLASSES, model=jm)
    jclf.compile(optimizer=jopt.SGD(lr=0.01),
                 mesh=Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6),
                           AXES))
    jest = jm.estimator
    jest.initial_weights = (params, state)
    losses, step = [], jest._make_train_step()

    def record(st, b):
        st, (loss, gnorm) = step(st, b)
        losses.append(float(loss))
        return st, (loss, gnorm)

    jest._train_step = record
    jclf.fit_image_set(_image_set(jimg), batch_size=16, nb_epoch=1, seed=5)
    return (np.array(losses), _np(jest.train_state["params"]),
            _np(jest.train_state["model_state"]))


def test_fit_image_set_two_steps_match_jax():
    """Two SGD steps of batch 16 through fit_image_set: BN normalises with
    the batch statistics and moves its buffers once a step.

    At initialisation this network is ill-conditioned: its 27 BN layers
    amplify rounding as it flows back (first-layer gradients of ~36), so
    an f32 implementation can only be held to the reference's own f32
    spread. That spread is measured here: JAX's run again from its
    weights each moved by one ulp up or down at random. Every step's loss,
    and the trained parameters and moving statistics (each set as one
    vector, its L2 distance), are held within 4x the reference's spread
    (at least 1e-5)."""
    jm, params, state, tm = _models("mobilenet", seed=3)
    tm.load_state_dict(state_dict_from_jax(params, state))
    want, jp, js = _jax_fit(jm, params, state)
    signs = np.random.default_rng(11)
    nudged = jax.tree_util.tree_map(
        lambda a: np.nextafter(a, np.where(signs.random(a.shape) < 0.5,
                                           np.float32(-np.inf),
                                           np.float32(np.inf))), params)
    want2, jp2, js2 = _jax_fit(getattr(jbb, "mobilenet")(
        SHAPE, CLASSES, alpha=0.25), nudged, state)

    clf = ImageClassifier("mobilenet", SHAPE, CLASSES, model=tm)
    clf.compile(optimizer=topt.SGD(lr=0.01))
    got, tstep = [], tm.estimator._step

    def trecord(b):
        loss, gnorm = tstep(b)
        got.append(float(loss))
        return loss, gnorm

    tm.estimator._step = trecord
    clf.fit_image_set(_image_set(timg), batch_size=16, nb_epoch=1, seed=5)
    got = np.array(got)
    assert len(got) == len(want) == 2
    assert np.all(np.abs(got - want) <= np.maximum(4 * np.abs(want2 - want),
                                                   1e-5))
    tp = params_to_numpy(tm)
    for tree, tree2 in ((jp, jp2), (js, js2)):
        gaps, spreads = [], []
        for slot, d in tree.items():
            for leaf, v in d.items():
                gaps.append(tp[slot][leaf] - v)
                spreads.append(tree2[slot][leaf] - v)
        gap = float(np.linalg.norm(np.concatenate([g.ravel() for g in gaps])))
        spread = float(np.linalg.norm(np.concatenate([g.ravel()
                                                      for g in spreads])))
        assert gap <= max(4 * spread, 1e-5)
    moved = sum(not np.array_equal(v, state[slot][leaf])
                for slot, d in js.items() for leaf, v in d.items())
    assert moved == 2 * 27                    # every BN's mean and var moved


def test_int8_predict_packs_jax_slots_and_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("ZOO_INT8_FUSED", "interpret")
    monkeypatch.setattr(jfused, "_MIN_INTERPRET", 128)
    monkeypatch.setenv("ZOO_TPU_TUNING_CACHE", str(tmp_path / "t.json"))
    for ax in "MNK":
        monkeypatch.delenv(f"ZOO_INT8_BLOCK_{ax}", raising=False)
    tuning.invalidate()
    jm, params, state, tm = _models("mobilenet", seed=6)
    packed, n_packed = jax_quantize_params(jm, params, 4096)
    jax_slots = sorted(s for s, p in packed.items()
                       if "kernel" in p and jint8.is_quantized(p["kernel"]))
    assert n_packed == len(jax_slots) > 0
    x = np.random.default_rng(7).normal(size=(2,) + SHAPE).astype(np.float32)
    want = JaxInferenceModel(max_batch_size=2).load(
        jm, params, state).quantize_int8().predict(x)
    tuning.invalidate()
    im = InferenceModel(max_batch_size=2, device="cpu").load(tm, params,
                                                             state)
    got = im.quantize_int8().predict(x)
    assert sorted(im.packed_slots) == jax_slots
    assert not any("depthwise" in s for s in im.packed_slots)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
