"""ImageClassifier (port of ``analytics_zoo_tpu/models/image/
classification.py``): a named backbone, its label map and top-n, with
``predict`` over arrays, ``predict_image_set`` over an ``ImageSet``
(``ImagenetConfig.preprocessing()``: resize, center crop and channel-mean
normalisation on the host, then the top-n ``(label, probability)`` lists),
training (``compile``, ``fit`` over arrays, ``fit_image_set`` over an
``ImageSet`` through the same preprocessing as ``predict_image_set``), and
``save_model``/``load_model`` as a weight bundle in the JAX package's
format (its config holds the model name, input shape, class count and
label map).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...data.image import (ImageCenterCrop, ImageChannelNormalize,
                           ImageResize, ImageSet)
from ..common.zoo_model import load_weights, save_model_bundle
from .backbones import build_backbone


class ImagenetConfig:
    """The ImageNet preprocessing recipe: resize (256/224 of the crop by
    default), center crop, subtract the channel means."""

    MEANS = (123.68, 116.779, 103.939)

    @staticmethod
    def preprocessing(crop_h: int = 224, crop_w: int = 224,
                      resize: Optional[int] = None):
        if resize is None:
            resize = max(crop_h, crop_w) * 256 // 224
        return (ImageResize(resize, resize)
                >> ImageCenterCrop(crop_h, crop_w)
                >> ImageChannelNormalize(*ImagenetConfig.MEANS))


class ImageClassifier:
    """Named-backbone classifier. ``device``: CUDA unless the caller names
    another (raises with no CUDA and no device); ``seed`` draws the
    backbone's weights."""

    def __init__(self, model_name: str = "resnet-50",
                 input_shape: Tuple[int, int, int] = (224, 224, 3),
                 num_classes: int = 1000,
                 label_map: Optional[Sequence[str]] = None,
                 model=None, *, device=None, seed: int = 0):
        self.model_name = model_name
        self.input_shape = tuple(input_shape)
        self.num_classes = int(num_classes)
        self.label_map = list(label_map) if label_map is not None else None
        self.model = model if model is not None else build_backbone(
            model_name, self.input_shape, self.num_classes, device=device,
            seed=seed)
        self.top_n = 5

    def set_top_n(self, n: int) -> "ImageClassifier":
        self.top_n = int(n)
        return self

    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        """Class probabilities (N, num_classes) for NHWC images ``x``, in
        batches of ``batch_size``; bf16 outputs come back as f32."""
        x = np.asarray(x, np.float32)
        dev = next(self.model.parameters()).device
        outs = []
        with torch.no_grad():
            for lo in range(0, x.shape[0], batch_size):
                xb = torch.from_numpy(np.ascontiguousarray(
                    x[lo:lo + batch_size])).to(dev)
                outs.append(self.model.apply(xb).float().cpu().numpy())
        return np.concatenate(outs, axis=0) if outs else np.zeros(
            (0, self.num_classes), np.float32)

    def _preprocess_set(self, image_set: ImageSet) -> np.ndarray:
        h, w, _ = self.input_shape
        processed = image_set.transform(ImagenetConfig.preprocessing(h, w))
        return np.stack([f.get_image().astype("float32")
                         for f in processed.features])

    def predict_image_set(self, image_set: ImageSet, batch_size: int = 32):
        """Per image, the top-n ``(class index or label, probability)``
        pairs, after ``ImagenetConfig.preprocessing`` at the model's input
        size."""
        probs = self.predict(self._preprocess_set(image_set), batch_size)
        order = np.argsort(-probs, axis=1)[:, :self.top_n]
        results = []
        for row, idx in zip(probs, order):
            labels = [self.label_map[i] if self.label_map else int(i)
                      for i in idx]
            results.append(list(zip(labels, row[idx].tolist())))
        return results

    def compile(self, optimizer="adam",
                loss="sparse_categorical_crossentropy",
                metrics=("accuracy",), **kw) -> "ImageClassifier":
        """The backbone's Estimator (``KerasNet.compile``)."""
        self.model.compile(optimizer=optimizer, loss=loss,
                           metrics=list(metrics), **kw)
        return self

    def fit(self, x, y=None, **kw) -> "ImageClassifier":
        """Train on NHWC arrays (or a FeatureSet), as ``KerasNet.fit``."""
        self.model.fit(x, y, **kw)
        return self

    def fit_image_set(self, image_set: ImageSet, labels=None,
                      **kw) -> "ImageClassifier":
        """Train with the same preprocessing chain ``predict_image_set``
        applies; ``labels`` default to the set's own."""
        x = self._preprocess_set(image_set)
        y = np.asarray(labels if labels is not None
                       else image_set.get_labels(), dtype="int32")
        self.model.fit(x, y, **kw)
        return self

    def save_model(self, path: str):
        save_model_bundle(path, self.model, config={
            "model_name": self.model_name,
            "input_shape": list(self.input_shape),
            "num_classes": self.num_classes, "label_map": self.label_map})

    @classmethod
    def load_model(cls, path: str, *, device=None) -> "ImageClassifier":
        """Rebuild the classifier a bundle describes (on ``device``, CUDA
        unless given) and load its weights."""
        import json
        import os

        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)["config"]
        clf = cls(model_name=config["model_name"],
                  input_shape=tuple(config["input_shape"]),
                  num_classes=config["num_classes"],
                  label_map=config.get("label_map"), device=device)
        load_weights(path, clf.model)
        return clf


__all__ = ["ImageClassifier", "ImagenetConfig"]
