"""ImageClassifier (port of ``analytics_zoo_tpu/models/image/
classification.py``): a named backbone, its label map and top-n, with
``predict`` over arrays, and ``save_model``/``load_model`` as a weight
bundle in the JAX package's format (its config holds the model name,
input shape, class count and label map).

Not ported: training (``compile``/``fit``: BatchNormalization's training
mode) and the ``ImageSet`` paths (``predict_image_set``, ``fit_image_set``,
the ImagenetConfig preprocessing chain), which need ``data/image.py``
(ROADMAP Queue 1, item 11).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.zoo_model import load_weights, save_model_bundle
from .backbones import build_backbone

_ROADMAP = "ROADMAP Queue 1, item 11"


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

    def predict_image_set(self, image_set, batch_size: int = 32):
        raise NotImplementedError(f"ImageSet prediction ({_ROADMAP})")

    def fit_image_set(self, image_set, labels=None, **kw):
        raise NotImplementedError(f"ImageSet training ({_ROADMAP})")

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


__all__ = ["ImageClassifier"]
