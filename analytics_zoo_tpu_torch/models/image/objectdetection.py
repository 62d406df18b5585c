"""SSD object detection (port of ``analytics_zoo_tpu/models/image/
objectdetection.py``): the anchors, target matching, decode and NMS on
the host in numpy (the JAX package's own functions, copied), the multibox
loss in torch, the small ``SSDModel`` and the full ``SSD300VGG``,
``ObjectDetector`` (config-driven zoo, ``fit`` with BatchNorm
recalibration, ``predict`` to per-image detections, weight bundles in the
JAX package's format) and ``MeanAveragePrecision``.

The detection head emits one dense ``(B, num_anchors, 4 + num_classes)``
tensor; matching is done once per image on the host, and the loss's hard
negative mining is a descending sort with a per-row ``k`` mask, as in the
JAX package (the sum of the top ``k`` does not depend on how ties sort).

Box convention: (cy, cx, h, w) normalized to [0, 1] for anchors; corner
boxes (y1, x1, y2, x2) at the API edge. Class 0 is background.

Served in int8 (``InferenceModel.quantize_int8``), only the heads pack:
the VGG trunk's convolutions are ``AtrousConvolution2D``, whose forward is
not ``Convolution2D``'s, so they stay float as in the JAX package, and the
six 3x3 stride-1 heads run K6.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...nn import layers as L
from ...nn.graph import Input
from ...nn.module import Layer
from ...nn.topology import Model

# ----------------------------------------------------------------- anchors


def generate_anchors(feature_sizes: Sequence[int],
                     scales: Optional[Sequence[float]] = None,
                     aspect_ratios: Sequence[float] = (1.0, 2.0, 0.5)
                     ) -> np.ndarray:
    """Anchor pyramid (SSD prior boxes): for each feature map cell, one
    anchor per aspect ratio at that level's scale. Returns (A, 4)
    center-form normalized (cy, cx, h, w), cell-major and
    aspect-ratio-minor (the head's reshape order)."""
    n_levels = len(feature_sizes)
    if scales is None:
        scales = np.linspace(0.2, 0.9, n_levels)
    out = []
    for fs, scale in zip(feature_sizes, scales):
        cy, cx = np.meshgrid(np.arange(fs), np.arange(fs), indexing="ij")
        cy = (cy.reshape(-1) + 0.5) / fs
        cx = (cx.reshape(-1) + 0.5) / fs
        per_cell = []
        for ar in aspect_ratios:
            h = scale / np.sqrt(ar)
            w = scale * np.sqrt(ar)
            per_cell.append(np.stack([cy, cx, np.full_like(cy, h),
                                      np.full_like(cx, w)], axis=1))
        level = np.stack(per_cell, axis=1)          # (cells, n_ar, 4)
        out.append(level.reshape(-1, 4))
    return np.concatenate(out, axis=0).astype("float32")


def generate_ssd_anchors(feature_sizes: Sequence[int],
                         scales: Sequence[float],
                         aspect_ratios_per_level: Sequence[Sequence[float]]
                         ) -> np.ndarray:
    """Paper-scheme SSD prior boxes (Liu et al. 2016 §2.2): per level k
    with scale s_k, one ar=1 box at s_k, one extra ar=1 box at
    sqrt(s_k·s_{k+1}), and one box per additional aspect ratio (h = s/√ar,
    w = s·√ar). ``scales`` has ``len(feature_sizes)+1`` entries. Ordering
    is cell-major, box-minor. SSD-300: sizes [38,19,10,5,3,1] → 8732
    anchors."""
    out = []
    for level, (fs, s_k) in enumerate(zip(feature_sizes, scales)):
        s_next = scales[level + 1]
        cy, cx = np.meshgrid(np.arange(fs), np.arange(fs), indexing="ij")
        cy = (cy.reshape(-1) + 0.5) / fs
        cx = (cx.reshape(-1) + 0.5) / fs
        hw = [(s_k, s_k), (np.sqrt(s_k * s_next),) * 2]
        for ar in aspect_ratios_per_level[level]:
            if ar == 1.0:
                continue
            hw.append((s_k / np.sqrt(ar), s_k * np.sqrt(ar)))
        per_cell = [np.stack([cy, cx, np.full_like(cy, h),
                              np.full_like(cx, w)], axis=1) for h, w in hw]
        out.append(np.stack(per_cell, axis=1).reshape(-1, 4))
    return np.concatenate(out, axis=0).astype("float32")


def boxes_per_cell(aspect_ratios: Sequence[float]) -> int:
    """ar=1 contributes 2 boxes (s_k + the extra sqrt scale)."""
    return len(aspect_ratios) + 1


def corner_to_center(boxes: np.ndarray) -> np.ndarray:
    y1, x1, y2, x2 = np.moveaxis(boxes, -1, 0)
    return np.stack([(y1 + y2) / 2, (x1 + x2) / 2, y2 - y1, x2 - x1],
                    axis=-1)


def center_to_corner(boxes: np.ndarray) -> np.ndarray:
    cy, cx, h, w = np.moveaxis(boxes, -1, 0)
    return np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                    axis=-1)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of corner boxes a (N,4) × b (M,4) → (N, M)."""
    a = a[:, None, :]
    b = b[None, :, :]
    inter_y1 = np.maximum(a[..., 0], b[..., 0])
    inter_x1 = np.maximum(a[..., 1], b[..., 1])
    inter_y2 = np.minimum(a[..., 2], b[..., 2])
    inter_x2 = np.minimum(a[..., 3], b[..., 3])
    ih = np.clip(inter_y2 - inter_y1, 0, None)
    iw = np.clip(inter_x2 - inter_x1, 0, None)
    inter = ih * iw
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / np.clip(area_a + area_b - inter, 1e-9, None)


# ------------------------------------------------------------------ matching


def match_anchors(anchors: np.ndarray, gt_boxes: np.ndarray,
                  gt_labels: np.ndarray, iou_threshold: float = 0.5,
                  variances=(0.1, 0.2)) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side target assignment: each anchor gets the best-overlapping
    gt (label 0 = background below threshold); every gt's best anchor is
    force-matched. Returns (loc_targets (A,4) encoded offsets, cls_targets
    (A,) int)."""
    A = anchors.shape[0]
    loc_t = np.zeros((A, 4), dtype="float32")
    cls_t = np.zeros((A,), dtype="int32")
    if len(gt_boxes) == 0:
        return loc_t, cls_t
    anchors_corner = center_to_corner(anchors)
    ious = iou_matrix(anchors_corner, gt_boxes)       # (A, G)
    best_gt = ious.argmax(axis=1)
    best_iou = ious.max(axis=1)
    best_anchor_per_gt = ious.argmax(axis=0)
    best_iou[best_anchor_per_gt] = 1.0
    best_gt[best_anchor_per_gt] = np.arange(len(gt_boxes))
    pos = best_iou >= iou_threshold
    cls_t[pos] = gt_labels[best_gt[pos]]
    matched = corner_to_center(gt_boxes[best_gt])
    vc, vs = variances
    loc = np.stack([
        (matched[:, 0] - anchors[:, 0]) / anchors[:, 2] / vc,
        (matched[:, 1] - anchors[:, 1]) / anchors[:, 3] / vc,
        np.log(np.clip(matched[:, 2] / anchors[:, 2], 1e-9, None)) / vs,
        np.log(np.clip(matched[:, 3] / anchors[:, 3], 1e-9, None)) / vs,
    ], axis=1)
    loc_t[pos] = loc[pos]
    return loc_t, cls_t


# ---------------------------------------------------------------------- loss


def multibox_loss(preds: torch.Tensor, loc_targets: torch.Tensor,
                  cls_targets: torch.Tensor, num_classes: int,
                  neg_pos_ratio: float = 3.0) -> torch.Tensor:
    """MultiBoxLoss: smooth-L1 on the positive anchors' offsets plus
    softmax CE with hard negative mining at ``neg_pos_ratio``, over the
    whole batch divided by the positive count (at least 1).

    preds: (B, A, 4 + C); loc_targets: (B, A, 4); cls_targets: (B, A) int.
    The negatives of a row are its anchors' CE sorted descending, the
    first ``k = min(ratio · positives, A - 1)`` kept; positives enter the
    sort as ``-inf`` and are read as 0, so no NaN reaches the gradient.
    Tied negatives sort as in JAX (a stable ascending sort, reversed): the
    sum does not depend on their order, which of them take the gradient
    does.
    """
    loc_pred = preds[..., :4]
    cls_pred = preds[..., 4:].float()
    pos = cls_targets > 0
    n_pos = pos.sum().clamp_min(1)

    diff = (loc_pred - loc_targets).abs()
    sl1 = torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5).sum(-1)
    loc_loss = torch.where(pos, sl1, 0.0).sum() / n_pos

    log_probs = F.log_softmax(cls_pred, dim=-1)
    ce = -log_probs.gather(-1, cls_targets.long()[..., None])[..., 0]
    pos_ce = torch.where(pos, ce, 0.0)
    neg_ce = torch.where(pos, float("-inf"), ce)
    a = neg_ce.shape[1]
    k = torch.clamp((neg_pos_ratio * pos.sum(dim=1)).to(torch.int32),
                    max=a - 1)
    # descending as JAX takes it: a stable ascending sort, reversed, so
    # tied negatives are picked (and get their gradient) as in JAX
    sorted_neg = torch.sort(neg_ce, dim=1, stable=True).values.flip(1)
    idx = torch.arange(a, device=preds.device)[None, :]
    keep = idx < k[:, None]
    finite = torch.where(torch.isfinite(sorted_neg), sorted_neg, 0.0)
    neg_loss = torch.where(keep, finite, 0.0).sum()
    cls_loss = (pos_ce.sum() + neg_loss) / n_pos
    return loc_loss + cls_loss


# -------------------------------------------------------------------- decode


def decode_predictions(preds: np.ndarray, anchors: np.ndarray,
                       variances=(0.1, 0.2)):
    """(A, 4+C) raw preds → (corner_boxes (A,4), class_probs (A,C))."""
    vc, vs = variances
    loc = preds[:, :4]
    cy = loc[:, 0] * vc * anchors[:, 2] + anchors[:, 0]
    cx = loc[:, 1] * vc * anchors[:, 3] + anchors[:, 1]
    h = np.exp(np.clip(loc[:, 2] * vs, -10, 10)) * anchors[:, 2]
    w = np.exp(np.clip(loc[:, 3] * vs, -10, 10)) * anchors[:, 3]
    boxes = center_to_corner(np.stack([cy, cx, h, w], axis=1))
    logits = preds[:, 4:] - preds[:, 4:].max(axis=1, keepdims=True)
    e = np.exp(logits)
    probs = e / e.sum(axis=1, keepdims=True)
    return boxes, probs


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.45,
        top_k: int = 200) -> List[int]:
    """Greedy per-class NMS on the host."""
    order = np.argsort(-scores)[:top_k]
    keep = []
    while len(order) > 0:
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        rest = order[1:]
        ious = iou_matrix(boxes[i:i + 1], boxes[rest])[0]
        order = rest[ious <= iou_threshold]
    return keep


# --------------------------------------------------------------------- model


class SSDModel(Model):
    """Small SSD graph: a strided conv + BN (momentum 0.9) + ReLU backbone
    tapping a detection head at every scale from stride 8 down, each head
    one 3x3 conv emitting ``len(aspect_ratios)·(4 + num_classes)`` per
    cell, reshaped and concatenated into the dense (B, A, 4+C) tensor.
    ``device``: CUDA unless the caller names another; ``seed`` draws the
    weights."""

    def __init__(self, num_classes: int, image_size: int = 96,
                 aspect_ratios: Sequence[float] = (1.0, 2.0, 0.5),
                 base_filters: int = 32, *, device=None, seed: int = 0):
        self.num_classes_ = int(num_classes)
        self.image_size = int(image_size)
        self.aspect_ratios = tuple(aspect_ratios)
        n_out = len(aspect_ratios) * (4 + num_classes)

        inp = Input((image_size, image_size, 3))
        x = inp
        feature_sizes = []
        heads = []
        filters = base_filters
        size = image_size
        level = 0
        while size > 2 and level < 6:
            x = L.Convolution2D(filters, 3, 3, subsample=(2, 2),
                                border_mode="same", use_bias=False)(x)
            x = L.BatchNormalization(momentum=0.9)(x)
            x = L.Activation("relu")(x)
            size = -(-size // 2)
            level += 1
            if level >= 3:
                feature_sizes.append(size)
                h = L.Convolution2D(n_out, 3, 3, border_mode="same")(x)
                h = L.Reshape((size * size * len(aspect_ratios),
                               4 + num_classes))(h)
                heads.append(h)
            filters = min(filters * 2, 256)
        out = heads[0] if len(heads) == 1 else L.Merge(
            mode="concat", concat_axis=0)(heads)
        super().__init__(inp, out, name="ssd", device=device, seed=seed)
        self.feature_sizes = feature_sizes
        self.anchors = generate_anchors(feature_sizes,
                                        aspect_ratios=self.aspect_ratios)


class L2NormScale(Layer):
    """Channel-wise L2 normalization with a learnable per-channel scale
    (SSD's NormalizeScale on conv4_3; init 20)."""

    def __init__(self, init_scale: float = 20.0, name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.init_scale = float(init_scale)

    def build(self, input_shape, gen: torch.Generator) -> None:
        self.scale = torch.nn.Parameter(torch.full(
            (input_shape[-1],), self.init_scale, dtype=torch.float32))
        self.built = True

    def apply(self, x):
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-10)
        return x / norm * self.scale.to(x.dtype)


# SSD-300 paper config (Liu et al. 2016, §3.1)
_SSD300_FEATURE_SIZES = (38, 19, 10, 5, 3, 1)
_SSD300_SCALES = (0.1, 0.2, 0.375, 0.55, 0.725, 0.9, 1.075)
_SSD300_ASPECT_RATIOS = ((1.0, 2.0, 0.5),
                         (1.0, 2.0, 0.5, 3.0, 1.0 / 3),
                         (1.0, 2.0, 0.5, 3.0, 1.0 / 3),
                         (1.0, 2.0, 0.5, 3.0, 1.0 / 3),
                         (1.0, 2.0, 0.5),
                         (1.0, 2.0, 0.5))

VOC_CLASSES = ("__background__", "aeroplane", "bicycle", "bird", "boat",
               "bottle", "bus", "car", "cat", "chair", "cow", "diningtable",
               "dog", "horse", "motorbike", "person", "pottedplant", "sheep",
               "sofa", "train", "tvmonitor")


class SSD300VGG(Model):
    """SSD-300 with a VGG16 feature extractor (``ssd-vgg16-300x300``):

    * VGG16 conv1_1..conv4_3 (tap 1, 38×38, L2-normalized + scaled),
    * conv5 + fc6 as a dilation-6 atrous 3×3 + fc7 1×1 (tap 2, 19×19),
    * conv8..conv11 extra feature layers (taps 3-6: 10, 5, 3, 1),
    * per level one 3x3 conv head emitting n_boxes·(4+C), reshaped
      cell-major and concatenated to the dense (B, 8732, 4+C) tensor.

    ``device``: CUDA unless the caller names another; ``seed`` draws the
    weights.
    """

    def __init__(self, num_classes: int, base_filters: int = 64, *,
                 device=None, seed: int = 0):
        self.num_classes_ = int(num_classes)
        self.image_size = 300
        bf = base_filters

        def conv(x, f, k=3, s=1, mode="same", dil=1, activation="relu"):
            return L.AtrousConvolution2D(
                f, k, k, subsample=(s, s), atrous_rate=(dil, dil),
                border_mode=mode, activation=activation)(x)

        inp = Input((300, 300, 3))
        x = inp
        for f, n in ((bf, 2), (bf * 2, 2)):
            for _ in range(n):
                x = conv(x, f)
            x = L.MaxPooling2D((2, 2), border_mode="same")(x)   # 150 → 75
        for _ in range(3):
            x = conv(x, bf * 4)
        x = L.MaxPooling2D((2, 2), border_mode="same")(x)        # 75 → 38
        for _ in range(3):
            x = conv(x, bf * 8)
        conv4_3 = L2NormScale()(x)                               # tap 1: 38
        x = L.MaxPooling2D((2, 2), border_mode="same")(x)        # 38 → 19
        for _ in range(3):
            x = conv(x, bf * 8)
        x = conv(x, bf * 16, k=3, dil=6)                         # fc6
        fc7 = conv(x, bf * 16, k=1)                              # tap 2: 19
        x = conv(fc7, bf * 4, k=1)
        conv8 = conv(x, bf * 8, s=2)                             # tap 3: 10
        x = conv(conv8, bf * 2, k=1)
        conv9 = conv(x, bf * 4, s=2)                             # tap 4: 5
        x = conv(conv9, bf * 2, k=1)
        conv10 = conv(x, bf * 4, mode="valid")                   # tap 5: 3
        x = conv(conv10, bf * 2, k=1)
        conv11 = conv(x, bf * 4, mode="valid")                   # tap 6: 1

        taps = (conv4_3, fc7, conv8, conv9, conv10, conv11)
        heads = []
        for tap, fs, ars in zip(taps, _SSD300_FEATURE_SIZES,
                                _SSD300_ASPECT_RATIOS):
            nb = boxes_per_cell(ars)
            h = L.Convolution2D(nb * (4 + num_classes), 3, 3,
                                border_mode="same")(tap)
            heads.append(L.Reshape((fs * fs * nb, 4 + num_classes))(h))
        out = L.Merge(mode="concat", concat_axis=0)(heads)
        super().__init__(inp, out, name="ssd300_vgg", device=device,
                         seed=seed)
        self.feature_sizes = list(_SSD300_FEATURE_SIZES)
        self.anchors = generate_ssd_anchors(
            _SSD300_FEATURE_SIZES, _SSD300_SCALES, _SSD300_ASPECT_RATIOS)


# the config-driven zoo ("ssd-vgg16-300x300_PASCAL_*" name scheme)
DETECTION_CONFIGS = {
    "ssd-vgg16-300x300": dict(builder=lambda C, **kw: SSD300VGG(C, **kw),
                              image_size=300, classes=VOC_CLASSES),
    "ssd-vgg16-300x300-pascal": dict(
        builder=lambda C, **kw: SSD300VGG(C, **kw), image_size=300,
        classes=VOC_CLASSES),
    "ssd-lite": dict(builder=lambda C, **kw: SSDModel(C, **kw),
                     image_size=96, classes=None),
}


class ObjectDetector:
    """User-facing SSD detector: ``fit`` on (images, gt boxes, gt labels)
    and ``predict`` → per image ``[(label, score, box), ...]``.

    ``model_name`` selects from DETECTION_CONFIGS; the default 'ssd-lite'
    is the small generic-backbone variant, 'ssd-vgg16-300x300' the full
    production architecture. ``device``: CUDA unless the caller names
    another (raises with no CUDA and no device); ``seed`` draws the
    weights.
    """

    def __init__(self, num_classes: int, image_size: int = 96,
                 score_threshold: float = 0.3, iou_threshold: float = 0.45,
                 model_name: str = "ssd-lite", class_names=None, *,
                 device=None, seed: int = 0, **model_kw):
        cfg = DETECTION_CONFIGS.get(model_name)
        if cfg is None:
            raise ValueError(f"unknown detection model {model_name!r}; "
                             f"known: {sorted(DETECTION_CONFIGS)}")
        if model_name.startswith("ssd-lite"):
            self.model = cfg["builder"](num_classes, image_size=image_size,
                                        device=device, seed=seed,
                                        **model_kw)
        else:
            self.model = cfg["builder"](num_classes, device=device,
                                        seed=seed, **model_kw)
            image_size = cfg["image_size"]
        self.model_kw = dict(model_kw)   # persisted so load_model rebuilds
        self.model_name = model_name
        self.class_names = tuple(class_names or cfg.get("classes") or ())
        self.num_classes = int(num_classes)
        self.image_size = int(image_size)
        self.score_threshold = score_threshold
        self.iou_threshold = iou_threshold

    @classmethod
    def from_config(cls, model_name: str, num_classes: Optional[int] = None,
                    **kw) -> "ObjectDetector":
        """``ObjectDetector.from_config('ssd-vgg16-300x300')`` builds the
        named architecture with its dataset's class count."""
        cfg = DETECTION_CONFIGS.get(model_name)
        if cfg is None:
            raise ValueError(f"unknown detection model {model_name!r}; "
                             f"known: {sorted(DETECTION_CONFIGS)}")
        if num_classes is None:
            classes = cfg.get("classes")
            if classes is None:
                raise ValueError(f"{model_name!r} needs num_classes")
            num_classes = len(classes)
        return cls(num_classes, model_name=model_name, **kw)

    # -- persistence (the bundle format) ------------------------------------
    def save_model(self, path: str):
        from ..common.zoo_model import save_model_bundle

        save_model_bundle(path, self.model, config={
            "model_name": self.model_name, "num_classes": self.num_classes,
            "image_size": self.image_size,
            "class_names": list(self.class_names),
            "score_threshold": self.score_threshold,
            "iou_threshold": self.iou_threshold,
            "model_kw": self.model_kw})

    @classmethod
    def load_model(cls, path: str, *, device=None) -> "ObjectDetector":
        """Rebuild the detector a bundle describes (on ``device``, CUDA
        unless given), load its weights and compile it."""
        import json
        import os

        from ..common.zoo_model import load_weights

        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)["config"]
        det = cls(config["num_classes"], image_size=config["image_size"],
                  score_threshold=config.get("score_threshold", 0.3),
                  iou_threshold=config.get("iou_threshold", 0.45),
                  model_name=config.get("model_name", "ssd-lite"),
                  class_names=config.get("class_names") or None,
                  device=device, **config.get("model_kw", {}))
        load_weights(path, det.model)
        det.compile()
        return det

    def compile(self, optimizer="adam", **kw):
        C = self.num_classes

        def loss(y_true, y_pred):
            loc_t = y_true[..., :4]
            cls_t = y_true[..., 4].to(torch.int32)
            return multibox_loss(y_pred, loc_t, cls_t, C)

        self.model.compile(optimizer=optimizer, loss=loss, **kw)
        return self

    def encode_targets(self, gt_boxes_list, gt_labels_list) -> np.ndarray:
        """Per-image gt → dense (A, 5) targets [loc(4), cls(1)]."""
        out = []
        for boxes, labels in zip(gt_boxes_list, gt_labels_list):
            loc_t, cls_t = match_anchors(self.model.anchors,
                                         np.asarray(boxes, dtype="float32"),
                                         np.asarray(labels, dtype="int32"))
            out.append(np.concatenate(
                [loc_t, cls_t[:, None].astype("float32")], axis=1))
        return np.stack(out)

    def fit(self, images, gt_boxes_list, gt_labels_list,
            recalibrate_bn: bool = True, **kw):
        """Train on NHWC images and their gt; then (``recalibrate_bn``)
        re-estimate BatchNorm's statistics under the trained weights
        (``Estimator.recalibrate_batchnorm``): a short detector fit leaves
        the moving statistics lagging the weights."""
        targets = self.encode_targets(gt_boxes_list, gt_labels_list)
        images = np.asarray(images, dtype="float32")
        self.model.fit(images, targets, **kw)
        if recalibrate_bn:
            self.model.estimator.recalibrate_batchnorm(
                images, batch_size=int(kw.get("batch_size", 16)))
        return self

    def predict(self, images, batch_size: int = 16):
        """Per image, a list of (class_id, score, (y1, x1, y2, x2)),
        highest score first: decode and per-class NMS on the host."""
        raw = np.asarray(self.model.predict(
            np.asarray(images, dtype="float32"), batch_size=batch_size))
        return self._detections(raw)

    def _detections(self, raw: np.ndarray):
        """The detections of raw (N, A, 4+C) head outputs, as ``predict``
        returns them."""
        results = []
        for pred in raw:
            boxes, probs = decode_predictions(pred, self.model.anchors)
            dets = []
            for c in range(1, self.num_classes):
                scores = probs[:, c]
                mask = scores >= self.score_threshold
                if not mask.any():
                    continue
                kept = nms(boxes[mask], scores[mask], self.iou_threshold)
                idx = np.nonzero(mask)[0][kept]
                dets.extend((c, float(scores[i]), tuple(boxes[i].tolist()))
                            for i in idx)
            dets.sort(key=lambda d: -d[1])
            results.append(dets)
        return results


# ---------------------------------------------------------------- evaluation


class MeanAveragePrecision:
    """VOC-style mAP: 11-point interpolated AP per class over ranked
    detections."""

    def __init__(self, num_classes: int, iou_threshold: float = 0.5):
        self.num_classes = num_classes
        self.iou_threshold = iou_threshold

    def __call__(self, detections, gt_boxes_list, gt_labels_list) -> float:
        aps = []
        for c in range(1, self.num_classes):
            aps.append(self._ap_for_class(c, detections, gt_boxes_list,
                                          gt_labels_list))
        aps = [a for a in aps if a is not None]
        return float(np.mean(aps)) if aps else 0.0

    def _ap_for_class(self, c, detections, gt_boxes_list, gt_labels_list):
        scores, tps = [], []
        n_gt = 0
        for dets, gboxes, glabels in zip(detections, gt_boxes_list,
                                         gt_labels_list):
            gboxes = np.asarray(gboxes, dtype="float32").reshape(-1, 4)
            glabels = np.asarray(glabels)
            cls_gt = gboxes[glabels == c]
            n_gt += len(cls_gt)
            used = np.zeros(len(cls_gt), dtype=bool)
            for (dc, score, box) in sorted([d for d in dets if d[0] == c],
                                           key=lambda d: -d[1]):
                scores.append(score)
                hit = False
                if len(cls_gt):
                    ious = iou_matrix(np.asarray([box], dtype="float32"),
                                      cls_gt)[0]
                    j = int(ious.argmax())
                    if ious[j] >= self.iou_threshold and not used[j]:
                        used[j] = True
                        hit = True
                tps.append(hit)
        if n_gt == 0:
            return None
        if not scores:
            return 0.0
        order = np.argsort(-np.asarray(scores))
        tp = np.asarray(tps, dtype="float64")[order]
        cum_tp = np.cumsum(tp)
        recall = cum_tp / n_gt
        precision = cum_tp / (np.arange(len(tp)) + 1)
        ap = 0.0
        for r in np.linspace(0, 1, 11):
            p = precision[recall >= r]
            ap += (p.max() if len(p) else 0.0) / 11
        return float(ap)


__all__ = ["DETECTION_CONFIGS", "L2NormScale", "MeanAveragePrecision",
           "ObjectDetector", "SSD300VGG", "SSDModel", "VOC_CLASSES",
           "boxes_per_cell", "center_to_corner", "corner_to_center",
           "decode_predictions", "generate_anchors", "generate_ssd_anchors",
           "iou_matrix", "match_anchors", "multibox_loss", "nms"]
