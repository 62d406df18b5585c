"""SSD object detection of the PyTorch port against the JAX package, on the
CPU: the anchors and ``encode_targets`` exactly; ``multibox_loss``'s value
and gradient within 1e-5, with and without positives (and with tied
negatives); ``L2NormScale``; ``SSD300VGG(21, base_filters=2)`` at 300x300
within 1e-4 of JAX's jitted apply on the same (bridged) weights; ssd-lite
at 64 px: a 2-step ``fit`` (the paper's SGD with momentum 0.9; Adam would
scale to ±lr the rounding noise of the gradients a BatchNorm stack
cancels) and ``recalibrate_batchnorm`` with losses within 1e-5 relative
(the multibox loss is ~18), parameters within 1e-5 and the recalibrated
BatchNorm statistics within 1e-4 of their norm; ``predict``'s
detections and ``MeanAveragePrecision`` the same; bundles loading in
either direction; the int8 predict of ssd-lite against JAX's int8 route
(``ZOO_INT8_FUSED=interpret``, as ``tests/test_torch_int8.py`` runs it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.inference import InferenceModel as JInferenceModel
from analytics_zoo_tpu.models.image import objectdetection as J
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.ops import int8_fused as jfused
from analytics_zoo_tpu_torch.bridge import (params_to_numpy,
                                            state_dict_from_jax)
from analytics_zoo_tpu_torch.inference.inference_model import \
    InferenceModel as TInferenceModel
from analytics_zoo_tpu_torch.models import image as timage
from analytics_zoo_tpu_torch.models.image import objectdetection as T
from analytics_zoo_tpu_torch.nn import optimizers as topt

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _shapes(n, size, seed):
    """``tests/test_ssd300.py``'s mini-VOC shapes: a square or a bar."""
    rng = np.random.default_rng(seed)
    imgs = np.full((n, size, size, 3), 0.1, dtype="float32")
    boxes, labels = [], []
    for i in range(n):
        cls = 1 + (i % 2)
        h = w = int(rng.integers(size // 4, size // 2))
        if cls == 2:
            h = int(rng.integers(size // 8, size // 5))
            w = int(rng.integers(size // 2, 3 * size // 4))
        y0 = int(rng.integers(0, size - h))
        x0 = int(rng.integers(0, size - w))
        imgs[i, y0:y0 + h, x0:x0 + w] = [1.0, 0.2, 0.2] if cls == 1 \
            else [0.2, 0.2, 1.0]
        boxes.append([[y0 / size, x0 / size, (y0 + h) / size,
                       (x0 + w) / size]])
        labels.append([cls])
    return imgs, boxes, labels


def _lite_pair(seed=0, **kw):
    jdet = J.ObjectDetector(num_classes=3, image_size=64, **kw)
    params, state = jax.jit(jdet.model.build)(jax.random.PRNGKey(seed))
    tdet = T.ObjectDetector(num_classes=3, image_size=64, device="cpu", **kw)
    tdet.model.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    return jdet, params, state, tdet


def test_anchors_and_targets_equal_jax():
    want = J.generate_ssd_anchors(J._SSD300_FEATURE_SIZES, J._SSD300_SCALES,
                                  J._SSD300_ASPECT_RATIOS)
    got = T.generate_ssd_anchors(T._SSD300_FEATURE_SIZES, T._SSD300_SCALES,
                                 T._SSD300_ASPECT_RATIOS)
    assert got.shape == (8732, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(T.generate_anchors([8, 4, 2]),
                                  J.generate_anchors([8, 4, 2]))
    assert [T.boxes_per_cell(a) for a in T._SSD300_ASPECT_RATIOS] == \
        [J.boxes_per_cell(a) for a in J._SSD300_ASPECT_RATIOS]
    _, boxes, labels = _shapes(6, 64, 0)
    boxes[1] = []                     # an image without objects
    labels[1] = []
    jdet, _, _, tdet = _lite_pair()
    np.testing.assert_array_equal(tdet.encode_targets(boxes, labels),
                                  jdet.encode_targets(boxes, labels))
    loc_t, cls_t = T.match_anchors(got, np.asarray(boxes[0], np.float32),
                                   np.asarray(labels[0], np.int32))
    want_loc, want_cls = J.match_anchors(want, np.asarray(boxes[0],
                                                          np.float32),
                                         np.asarray(labels[0], np.int32))
    np.testing.assert_array_equal(loc_t, want_loc)
    np.testing.assert_array_equal(cls_t, want_cls)
    assert T.DETECTION_CONFIGS.keys() == J.DETECTION_CONFIGS.keys()
    assert T.VOC_CLASSES == J.VOC_CLASSES
    assert sorted(timage.__all__) == sorted(
        __import__("analytics_zoo_tpu.models.image",
                   fromlist=["x"]).__all__)


@pytest.mark.parametrize("case", ["positives", "no_positives", "ties"])
def test_multibox_loss_and_gradient_match_jax(case):
    rng = np.random.default_rng(3)
    b, a, c = 2, 60, 4
    preds = rng.standard_normal((b, a, 4 + c)).astype("float32")
    loc_t = rng.standard_normal((b, a, 4)).astype("float32")
    cls_t = np.zeros((b, a), np.int32)
    if case != "no_positives":
        cls_t[:, ::9] = rng.integers(1, c, size=cls_t[:, ::9].shape)
    if case == "ties":
        # many negatives with the same confidence row: tied CE values
        preds[:, 20:50, 4:] = preds[:, 20:21, 4:]
    jl, jg = jax.value_and_grad(lambda p: J.multibox_loss(
        p, jnp.asarray(loc_t), jnp.asarray(cls_t), c))(jnp.asarray(preds))
    tp = torch.from_numpy(preds).requires_grad_()
    tl = T.multibox_loss(tp, torch.from_numpy(loc_t),
                         torch.from_numpy(cls_t), c)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=1e-5)
    assert torch.isfinite(tp.grad).all()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5)


def test_l2norm_scale_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 4, 4, 8)).astype(
        "float32")
    jl = J.L2NormScale(init_scale=10.0)
    params, _ = jl.build(jax.random.PRNGKey(0), (4, 4, 8))
    want, _ = jl.apply(params, {}, x)
    tl = T.L2NormScale(init_scale=10.0)
    tl.build((4, 4, 8), torch.Generator())
    np.testing.assert_array_equal(tl.scale.detach().numpy(),
                                  np.asarray(params["scale"]))
    with torch.no_grad():
        got = tl.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got,
                               np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(want), axis=-1),
                               10.0, rtol=1e-4)


def test_ssd300_vgg_forward_matches_jax():
    jm = J.SSD300VGG(21, base_filters=2)
    params, state = jax.jit(jm.build)(jax.random.PRNGKey(0))
    tm = T.SSD300VGG(21, base_filters=2, device="cpu")
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(params))
    np.testing.assert_array_equal(tm.anchors, jm.anchors)
    x = np.random.default_rng(1).uniform(0, 1, (2, 300, 300, 3)).astype(
        "float32")
    want = np.asarray(jax.jit(lambda p, s, xx: jm.apply(p, s, xx)[0])(
        params, state, x))
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8732, 25)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_ssd_lite_fit_and_recalibration_match_jax():
    jdet, params, state, tdet = _lite_pair(seed=1)
    imgs, boxes, labels = _shapes(8, 64, 1)
    jdet.compile(optimizer=jopt.SGD(lr=1e-3, momentum=0.9), mesh=_mesh())
    jest = jdet.model.estimator
    jest.initial_weights = (params, state)
    want, step = [], jest._make_train_step()

    def jrecord(st, bt):
        st, (lo, gnorm) = step(st, bt)
        want.append(float(lo))
        return st, (lo, gnorm)

    jest._train_step = jrecord
    jdet.fit(imgs, boxes, labels, batch_size=4, nb_epoch=1)
    tdet.compile(optimizer=topt.SGD(lr=1e-3, momentum=0.9))
    got, tstep = [], tdet.model.estimator._step

    def trecord(bt):
        lo, gnorm = tstep(bt)
        got.append(float(lo))
        return lo, gnorm

    tdet.model.estimator._step = trecord
    tdet.fit(imgs, boxes, labels, batch_size=4, nb_epoch=1)
    assert len(got) == len(want) == 2
    # the multibox loss is ~18 here: held within 1e-5 relative
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    ref = state_dict_from_jax(_np(jest.train_state["params"]),
                              _np(jest.train_state["model_state"]))
    mine = tdet.model.state_dict()
    assert sorted(ref) == sorted(mine)
    for name, v in ref.items():
        if name.endswith(("moving_mean", "moving_var")):
            # recalibrated statistics (f32 sums over the batch): within
            # 1e-4 of their norm, phase 21's hold on the card
            d = np.linalg.norm(mine[name].numpy() - v.numpy())
            assert d <= 1e-4 * np.linalg.norm(v.numpy()), (name, d)
        else:
            np.testing.assert_allclose(mine[name].numpy(), v.numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
    # after the fit (and the recalibration) the detections are JAX's
    x = imgs[:3]
    np.testing.assert_allclose(tdet.model.predict(x), np.asarray(
        jdet.model.predict(x)), rtol=0, atol=1e-4)


def test_predict_detections_and_map_match_jax():
    jdet, params, state, tdet = _lite_pair(seed=2, score_threshold=0.05)
    jdet.compile(mesh=_mesh())
    jdet.model.estimator.initial_weights = (params, state)
    tdet.compile()
    imgs, boxes, labels = _shapes(4, 64, 2)
    want = jdet.predict(imgs, batch_size=4)
    got = tdet.predict(imgs, batch_size=4)
    assert len(got) == len(want) == 4 and sum(map(len, want)) > 0
    for dw, dg in zip(want, got):
        assert [d[0] for d in dg] == [d[0] for d in dw]
        np.testing.assert_allclose([d[1] for d in dg], [d[1] for d in dw],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose([d[2] for d in dg], [d[2] for d in dw],
                                   rtol=0, atol=1e-5)
    jmap = J.MeanAveragePrecision(3)(want, boxes, labels)
    assert T.MeanAveragePrecision(3)(got, boxes, labels) == jmap
    # decode and NMS on the same raw outputs give the same lists
    raw = np.random.default_rng(3).standard_normal((60, 7)).astype(
        "float32")
    anchors = T.generate_anchors([4, 2])
    for a, b in zip(T.decode_predictions(raw, anchors),
                    J.decode_predictions(raw, anchors)):
        np.testing.assert_array_equal(a, b)
    bx, pr = T.decode_predictions(raw, anchors)
    assert T.nms(bx, pr[:, 1], 0.3) == J.nms(bx, pr[:, 1], 0.3)


def test_bundles_load_either_way(tmp_path):
    jdet, params, state, tdet = _lite_pair(seed=4)
    tdet.compile()
    tdet.save_model(str(tmp_path / "port"))
    jback = J.ObjectDetector.load_model(str(tmp_path / "port"))
    x = _shapes(2, 64, 4)[0]
    np.testing.assert_allclose(np.asarray(jback.model.predict(x)),
                               tdet.model.predict(x), rtol=0, atol=1e-4)
    jdet.compile(mesh=_mesh())
    jdet.model.estimator.initial_weights = (params, state)
    jdet.model.estimator.train_state = jdet.model.estimator._init_state(
        (x, None))
    jdet.save_model(str(tmp_path / "jax"))
    tback = T.ObjectDetector.load_model(str(tmp_path / "jax"), device="cpu")
    assert (tback.image_size, tback.num_classes, tback.model_name) == \
        (64, 3, "ssd-lite")
    np.testing.assert_array_equal(tback.model.predict(x),
                                  tdet.model.predict(x))
    with pytest.raises(ValueError, match="unknown detection model"):
        T.ObjectDetector.from_config("yolo-v9000", device="cpu")
    with pytest.raises(ValueError, match="needs num_classes"):
        T.ObjectDetector.from_config("ssd-lite", device="cpu")


def test_int8_predict_matches_jax_int8_route(monkeypatch, tmp_path):
    monkeypatch.setenv("ZOO_INT8_FUSED", "interpret")
    monkeypatch.setattr(jfused, "_MIN_INTERPRET", 128)
    monkeypatch.setenv("ZOO_TPU_TUNING_CACHE", str(tmp_path / "t.json"))
    jdet, params, state, tdet = _lite_pair(seed=5)
    x = _shapes(4, 64, 5)[0]
    jim = JInferenceModel(max_batch_size=4).load(jdet.model, params, state)
    tim = TInferenceModel(max_batch_size=4, device="cpu").load(tdet.model)
    floats = tim.predict(x)
    jim.quantize_int8()
    tim.quantize_int8()
    # the stride-2 trunk convs of at least 4096 weights and the 3 heads
    assert len(tim.packed_slots) == 7
    want, got = np.asarray(jim.predict(x)), tim.predict(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    gap = np.linalg.norm(got - floats) / np.linalg.norm(floats)
    assert 0 < gap < 0.05
