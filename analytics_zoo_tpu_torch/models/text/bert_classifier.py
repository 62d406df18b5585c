"""BERTClassifier: sequence classification over the BERT encoder (port of
``models/text/bert_classifier.py``): the pooled output through a dense
head, softmax taken in f32. The encoder plumbing, weights, device and
bundle are :class:`~.bert_estimators._BERTHeadBase`'s; the head has no
dropout, as in the JAX model."""

from __future__ import annotations

import torch

from ..common.zoo_model import register_model
from .bert_estimators import _BERTHeadBase


@register_model("BERTClassifier")
class BERTClassifier(_BERTHeadBase):
    """ids (B, T) [or [ids, segment_ids]] → class probabilities (B, C)."""

    def __init__(self, num_classes: int, dropout: float = 0.0, **kw):
        self.num_classes = int(num_classes)
        super().__init__(head_units=self.num_classes, dropout=dropout, **kw)

    def apply(self, x, rng=None):
        _seq, pooled = self.bert.apply(x, rng=rng)
        logits = pooled @ self.head_kernel.to(pooled.dtype) \
            + self.head_bias.to(pooled.dtype)
        return torch.softmax(logits.float(), dim=-1)

    def compute_output_shape(self, input_shape):
        return (self.num_classes,)

    def constructor_config(self):
        return dict(num_classes=self.num_classes,
                    **super().constructor_config())

    @classmethod
    def load_model(cls, path: str, *, device=None) -> "BERTClassifier":
        from ..common.zoo_model import load_model_bundle

        model, _ = load_model_bundle(path, device=device)
        return model


__all__ = ["BERTClassifier"]
