"""BERT fine-tuning heads beyond classification: token tagging (NER) and
extractive QA (SQuAD) (port of ``models/text/bert_estimators.py``).

``BERTNER`` is a dense softmax over the encoder's final sequence output,
trained with a masked token-level cross entropy; ``BERTSQuAD`` a 2-unit
dense head whose columns are the start and end span logits, trained with
the mean of the start and end cross entropies. Padding rides the labels
(``PAD_TAG`` = -1), not an input mask, so a step is a fixed-shape (ids,
labels) pair.

Parameters keep the JAX tree: ``bert`` (``nn/layers/attention.py::BERT``:
``token_embeddings``, ``block{i}.attn.qkv_kernel``, ...), ``head_kernel``
and ``head_bias``, so ``bridge.params_from_jax`` loads a JAX head's
params and a weight bundle loads in either package. The weights are drawn
at construction from ``torch.Generator().manual_seed(seed)`` (the BERT's
in its own order, then the head kernel); ``device``: CUDA unless given.
In training (``train()``, the Estimator's ``fit``) with a key, the head
splits it as JAX does, ``k_bert, k_drop = split(rng)``, and drops the
sequence output with ``k_drop``'s mask (``common/prng.py``: JAX's bits).
On CUDA every block's attention is K1 (no causal mask), and K3/K4 in
training.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...common import prng
from ...nn.layers.attention import BERT
from ...nn.module import Layer, glorot_uniform, resolve_device, zeros_init
from ...nn.topology import KerasNet
from ..common.zoo_model import register_model

PAD_TAG = -1


def ner_token_loss(y_true, y_pred):
    """Masked token-level cross entropy: summed over real tokens and
    divided by their count. ``y_true`` (B, T) int with ``PAD_TAG`` on
    padding; ``y_pred`` (B, T, E) log-probabilities."""
    y_pred = y_pred.float()
    y_true = torch.as_tensor(y_true, device=y_pred.device)
    mask = (y_true != PAD_TAG).float()
    labels = y_true.clamp(min=0).long()
    ll = y_pred.gather(-1, labels[..., None])[..., 0]
    return -(ll * mask).sum() / (mask.sum() + 1e-12)


def squad_span_loss(y_true, y_pred):
    """Mean of the start and end position cross entropies. ``y_true``
    (B, 2) int [start, end]; ``y_pred`` (B, 2, T) log-softmax over
    positions."""
    y_pred = y_pred.float()
    y_true = torch.as_tensor(y_true, device=y_pred.device).long()
    ll = y_pred.gather(-1, y_true[..., None])[..., 0]           # (B, 2)
    return -ll.mean()


class _BERTHeadBase(KerasNet, Layer):
    """The encoder plumbing the fine-tune heads share."""

    def __init__(self, head_units: int, vocab: int = 30522,
                 hidden_size: int = 256, n_block: int = 4, n_head: int = 4,
                 seq_len: int = 128, intermediate_size: Optional[int] = None,
                 dropout: float = 0.1, name=None, *, device=None,
                 seed: int = 0):
        super().__init__(name=name)
        self.device = resolve_device(device)
        self.head_units = int(head_units)
        self.dropout = float(dropout)
        self.cfg = dict(vocab=vocab, hidden_size=hidden_size, n_block=n_block,
                        n_head=n_head, seq_len=seq_len,
                        intermediate_size=intermediate_size or 4 * hidden_size)
        self.bert = BERT(vocab=vocab, hidden_size=hidden_size,
                         n_block=n_block, n_head=n_head, seq_len=seq_len,
                         intermediate_size=self.cfg["intermediate_size"],
                         name=f"{self.name}_bert")
        gen = torch.Generator().manual_seed(int(seed))
        self.bert.build((seq_len,), gen)
        self.head_kernel = torch.nn.Parameter(
            glorot_uniform(gen, (hidden_size, self.head_units)))
        self.head_bias = torch.nn.Parameter(zeros_init((self.head_units,)))
        self.built = True
        self.to(self.device)
        self.eval()

    @property
    def input_shape(self):
        return (self.cfg["seq_len"],)

    def _sequence_logits(self, x, rng):
        """(B, T, head_units) logits over the encoder's sequence output."""
        from .sequence_models import _dropout

        k_bert = k_drop = rng
        if rng is not None:
            k_bert, k_drop = prng.split(rng)
        seq, _pooled = self.bert.apply(x, rng=k_bert)
        seq = _dropout(seq, self.dropout, self.training, k_drop)
        return seq @ self.head_kernel.to(seq.dtype) \
            + self.head_bias.to(seq.dtype)

    def constructor_config(self):
        return dict(dropout=self.dropout, **self.cfg)

    def save_model(self, path: str):
        from ..common.zoo_model import save_model_bundle

        save_model_bundle(path, self, config=self.constructor_config())


@register_model("BERTNER")
class BERTNER(_BERTHeadBase):
    """ids (B, T) [or [ids, segment_ids]] → per-token entity log-probs
    (B, T, num_entities). Train with :func:`ner_token_loss` (labels padded
    with ``PAD_TAG``)."""

    def __init__(self, num_entities: int, **kw):
        self.num_entities = int(num_entities)
        super().__init__(head_units=self.num_entities, **kw)

    loss = staticmethod(ner_token_loss)

    def apply(self, x, rng=None):
        logits = self._sequence_logits(x, rng)
        return torch.log_softmax(logits.float(), dim=-1)

    def predict_tags(self, x, batch_size: int = 32) -> np.ndarray:
        """The argmax entity ids (B, T)."""
        return np.argmax(self.predict(x, batch_size=batch_size), axis=-1)

    def compute_output_shape(self, input_shape):
        return (self.cfg["seq_len"], self.num_entities)

    def constructor_config(self):
        return dict(num_entities=self.num_entities,
                    **super().constructor_config())

    @classmethod
    def load_model(cls, path: str, *, device=None) -> "BERTNER":
        """A bundle rebuilt and compiled (Adam, :func:`ner_token_loss`),
        ready to predict."""
        from ..common.zoo_model import load_model_bundle

        model, _ = load_model_bundle(path, device=device)
        model.compile(optimizer="adam", loss=cls.loss)
        return model


@register_model("BERTSQuAD")
class BERTSQuAD(_BERTHeadBase):
    """ids (B, T) [or [ids, segment_ids]] → (B, 2, T) start/end position
    log-probs. Train with :func:`squad_span_loss` on (B, 2) [start, end]
    labels; ``predict_spans`` returns the argmax span of each example."""

    def __init__(self, **kw):
        super().__init__(head_units=2, **kw)

    loss = staticmethod(squad_span_loss)

    def apply(self, x, rng=None):
        logits = self._sequence_logits(x, rng)
        # (B, T, 2) -> (B, 2, T): each row a distribution over positions
        return torch.log_softmax(logits.transpose(1, 2).float(), dim=-1)

    def predict_spans(self, x, batch_size: int = 32):
        """``(start, end)`` argmax positions, each (B,)."""
        logp = self.predict(x, batch_size=batch_size)
        return logp[:, 0].argmax(-1), logp[:, 1].argmax(-1)

    def compute_output_shape(self, input_shape):
        return (2, self.cfg["seq_len"])

    @classmethod
    def load_model(cls, path: str, *, device=None) -> "BERTSQuAD":
        from ..common.zoo_model import load_model_bundle

        model, _ = load_model_bundle(path, device=device)
        model.compile(optimizer="adam", loss=cls.loss)
        return model


__all__ = ["BERTNER", "BERTSQuAD", "PAD_TAG", "ner_token_loss",
           "squad_span_loss"]
