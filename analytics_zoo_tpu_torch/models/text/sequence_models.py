"""Keras-level sequence-labelling text models: NER, SequenceTagger (POS +
chunk) and IntentEntity (joint intent + slots) (port of
``models/text/sequence_models.py``).

Each model is one module over the port's ``Embedding``, ``Bidirectional``
LSTMs (the JAX cells and parameter names, ``nn/layers/recurrent.py``),
``Dense`` heads and the linear-chain CRF (``nn/layers/crf.py``). The char
feature extractor reshapes (B, T, W) → (B·T, W), so the per-word char
BiLSTM runs as one batch. Sequence lengths are fixed; padding rides the
labels (``PAD_TAG`` = -1). Parameters keep the JAX tree (``enc.word``,
``enc.char_rnn.forward.kernel``, ``rnn1``, ``head``, ``crf.transitions``,
...), so ``bridge.params_from_jax`` loads a JAX model's params and a
weight bundle loads in either package. The weights are drawn at
construction from ``torch.Generator().manual_seed(seed)``; ``device``:
CUDA unless given. In training mode with a key, dropout on the encoder's
output uses the model's key, as the JAX models do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...nn.layers.core import Dense
from ...nn.layers.core import dropout as _core_dropout
from ...nn.layers.crf import (CRF, crf_decode, crf_log_likelihood,
                              crf_nll_from_packed)
from ...nn.layers.embedding import Embedding
from ...nn.layers.recurrent import LSTM, Bidirectional
from ...nn.module import Layer, resolve_device
from ...nn.topology import KerasNet
from ..common.zoo_model import register_model

PAD_TAG = -1


def masked_tag_loss(y_true, y_pred):
    """Masked sparse cross entropy over (B, T) int tags and (B, T, E)
    probabilities; ``PAD_TAG`` positions do not count."""
    logp = torch.log(y_pred.float().clamp(1e-12, 1.0))
    y_true = torch.as_tensor(y_true, device=logp.device)
    mask = (y_true != PAD_TAG).float()
    labels = y_true.clamp(min=0).long()
    ll = logp.gather(-1, labels[..., None])[..., 0]
    return -(ll * mask).sum() / (mask.sum() + 1e-12)


def crf_tag_loss(y_true, y_pred):
    """CRF NLL of an ``(emissions, packed energies)`` model output;
    ``PAD_TAG`` positions are masked (the 'pad' crf_mode)."""
    emissions, packed = y_pred
    return crf_nll_from_packed(torch.as_tensor(y_true,
                                               device=emissions.device),
                               emissions, packed, pad_tag=PAD_TAG)


def crf_tag_loss_reg(y_true, y_pred):
    """CRF NLL scoring the full length of every sequence (the 'reg'
    crf_mode: equal lengths, no masking)."""
    emissions, packed = y_pred
    y_true = torch.as_tensor(y_true, device=emissions.device)
    mask = torch.ones(y_true.shape, dtype=torch.bool, device=y_true.device)
    trans, start, end = CRF.unpack(packed[0])
    ll = crf_log_likelihood(emissions, y_true.clamp(min=0), mask, trans,
                            start, end)
    return -ll.mean()


def _dropout(x, rate, training, rng):
    """Inverted dropout with the JAX mask (``bernoulli(rng, 1 - rate)``) in
    training mode with a key, else the identity."""
    if not training or rate <= 0 or rng is None:
        return x
    return _core_dropout(x, rate, rng)


def _dense(units: int, in_dim: int, gen: torch.Generator) -> Dense:
    """A built ``Dense(units)`` over ``in_dim`` inputs (glorot kernel,
    zero bias): the JAX ``_dense_params``."""
    layer = Dense(units)
    layer.build((in_dim,), gen)
    layer.built = True
    return layer


def _bilstm(units: int, in_dim: int, gen: torch.Generator, name: str,
            return_sequences: bool = True) -> Bidirectional:
    layer = Bidirectional(LSTM(units, return_sequences=return_sequences,
                               name=name))
    layer.build((None, in_dim), gen)
    return layer


def _width(rnn: Bidirectional) -> int:
    return 2 * rnn._modules["forward"].output_dim


class _WordCharEncoder(Layer):
    """[word_ids (B, T), char_ids (B, T, W)] → (B, T, D_word +
    2·char_lstm_dim): word embeddings concatenated with a per-word char
    BiLSTM summary (the last states of both directions)."""

    def __init__(self, word_vocab_size, char_vocab_size, word_emb_dim,
                 char_emb_dim, char_lstm_dim=None, name=None, *,
                 gen: torch.Generator):
        super().__init__(name=name)
        char_lstm_dim = char_lstm_dim or char_emb_dim
        self.word = Embedding(word_vocab_size, word_emb_dim,
                              name=f"{self.name}_wemb")
        self.char = Embedding(char_vocab_size, char_emb_dim,
                              name=f"{self.name}_cemb")
        self.word.build(None, gen)
        self.char.build(None, gen)
        self.char_rnn = _bilstm(char_lstm_dim, char_emb_dim, gen,
                                f"{self.name}_clstm",
                                return_sequences=False)
        self.out_dim = word_emb_dim + 2 * char_lstm_dim
        self.built = True

    def apply(self, x):
        word_ids, char_ids = x
        w = self.word(word_ids)
        c = self.char(char_ids)
        b, t, wl, d = c.shape
        # one batch of B·T words through the char BiLSTM
        cf = self.char_rnn(c.reshape(b * t, wl, d))
        return torch.cat([w, cf.reshape(b, t, -1)], dim=-1)


class _TextModel(KerasNet, Layer):
    """The shared plumbing: device, generator, config and bundles."""

    def __init__(self, config: dict, name, device, seed):
        super().__init__(name=name)
        self.device = resolve_device(device)
        self.config = config
        self._gen = torch.Generator().manual_seed(int(seed))

    def _finish(self):
        del self._gen
        self.built = True
        self.to(self.device)
        self.eval()

    def save_model(self, path: str):
        from ..common.zoo_model import save_model_bundle

        save_model_bundle(path, self, config=self.config)

    @classmethod
    def load_model(cls, path: str, *, device=None):
        """A bundle rebuilt and compiled (Adam and the model's loss),
        ready to predict."""
        from ..common.zoo_model import load_model_bundle

        model, _ = load_model_bundle(path, device=device)
        model.compile(optimizer="adam", loss=model._bundle_loss())
        return model


@register_model("NER")
class NER(_TextModel):
    """Word + char BiLSTM-CRF named-entity tagger.

    Inputs: [word ids (B, T), char ids (B, T, word_length)]. Output:
    ``(emissions (B, T, E), packed CRF energies (B, E + 2, E))``; train
    with ``model.loss`` (the CRF NLL); ``predict_tags`` runs Viterbi.
    ``crf_mode='reg'`` scores full-length sequences (the default);
    ``'pad'`` masks ``PAD_TAG`` labels in training and decodes word id 0
    as padding (tag 0)."""

    loss = staticmethod(crf_tag_loss_reg)

    def __init__(self, num_entities: int, word_vocab_size: int,
                 char_vocab_size: int, word_length: int = 12,
                 word_emb_dim: int = 100, char_emb_dim: int = 30,
                 tagger_lstm_dim: int = 100, dropout: float = 0.5,
                 crf_mode: str = "reg", name=None, *, device=None,
                 seed: int = 0):
        if crf_mode not in ("reg", "pad"):
            raise ValueError("crf_mode should be either 'reg' or 'pad'")
        super().__init__(dict(num_entities=num_entities,
                              word_vocab_size=word_vocab_size,
                              char_vocab_size=char_vocab_size,
                              word_length=word_length,
                              word_emb_dim=word_emb_dim,
                              char_emb_dim=char_emb_dim,
                              tagger_lstm_dim=tagger_lstm_dim,
                              dropout=dropout, crf_mode=crf_mode),
                         name, device, seed)
        self.crf_mode = crf_mode
        self.loss = crf_tag_loss if crf_mode == "pad" else crf_tag_loss_reg
        self.num_entities = int(num_entities)
        self.dropout = float(dropout)
        g = self._gen
        self.enc = _WordCharEncoder(word_vocab_size, char_vocab_size,
                                    word_emb_dim, char_emb_dim,
                                    name=f"{self.name}_enc", gen=g)
        self.rnn1 = _bilstm(tagger_lstm_dim, self.enc.out_dim, g,
                            f"{self.name}_tag1")
        h = _width(self.rnn1)
        self.rnn2 = _bilstm(tagger_lstm_dim, h, g, f"{self.name}_tag2")
        self.head = _dense(self.num_entities, h, g)
        self.crf = CRF(self.num_entities, name=f"{self.name}_crf")
        self.crf.build(None, g)
        self._finish()

    def _bundle_loss(self):
        return self.loss

    def apply(self, x, rng=None):
        h = self.enc(x)
        h = _dropout(h, self.dropout, self.training, rng)
        h = self.rnn2(self.rnn1(h))
        return self.crf(self.head(h))

    def predict_tags(self, x, batch_size: int = 32) -> np.ndarray:
        """Viterbi-decoded entity ids (B, T). In 'pad' mode word id 0 marks
        padding and those positions decode to tag 0."""
        emissions, packed = self.predict(x, batch_size=batch_size)
        dev = self.device
        trans, start, end = CRF.unpack(torch.as_tensor(packed[0],
                                                       device=dev))
        if self.crf_mode == "pad":
            words = x[0] if isinstance(x, (list, tuple)) else x
            mask = torch.as_tensor(np.asarray(words), device=dev) != 0
        else:
            mask = torch.ones(emissions.shape[:2], dtype=torch.bool,
                              device=dev)
        return crf_decode(torch.as_tensor(emissions, device=dev), mask,
                          trans, start, end).cpu().numpy()

    def compute_output_shape(self, input_shape):
        t = input_shape[0][0] if input_shape else None
        return [(t, self.num_entities),
                (self.num_entities + 2, self.num_entities)]


@register_model("SequenceTagger")
class SequenceTagger(_TextModel):
    """Three-BiLSTM sentence tagger with POS and chunk heads.

    Inputs: word ids (B, T), plus char ids (B, T, word_length) when
    ``char_vocab_size`` is set. Outputs ``(pos_probs (B, T, P),
    chunk_probs (B, T, C))`` with ``classifier='softmax'`` (train with
    ``SequenceTagger.loss``), or ``(pos_probs, chunk_emissions, packed)``
    with ``classifier='crf'`` (``SequenceTagger.crf_loss``); labels are
    ``(pos, chunk)`` int pairs, ``PAD_TAG``-padded."""

    def __init__(self, num_pos_labels: int, num_chunk_labels: int,
                 word_vocab_size: int, char_vocab_size: Optional[int] = None,
                 word_length: int = 12, feature_size: int = 100,
                 dropout: float = 0.2, classifier: str = "softmax",
                 name=None, *, device=None, seed: int = 0):
        classifier = classifier.lower()
        if classifier not in ("softmax", "crf"):
            raise ValueError("classifier should be either softmax or crf")
        super().__init__(dict(num_pos_labels=num_pos_labels,
                              num_chunk_labels=num_chunk_labels,
                              word_vocab_size=word_vocab_size,
                              char_vocab_size=char_vocab_size,
                              word_length=word_length,
                              feature_size=feature_size, dropout=dropout,
                              classifier=classifier),
                         name, device, seed)
        self.num_pos = int(num_pos_labels)
        self.num_chunk = int(num_chunk_labels)
        self.classifier = classifier
        self.dropout = float(dropout)
        self.has_char = char_vocab_size is not None
        g = self._gen
        if self.has_char:
            self.enc = _WordCharEncoder(word_vocab_size, char_vocab_size,
                                        feature_size, feature_size // 2,
                                        name=f"{self.name}_enc", gen=g)
            d = self.enc.out_dim
        else:
            self.wemb = Embedding(word_vocab_size, feature_size,
                                  name=f"{self.name}_wemb")
            self.wemb.build(None, g)
            d = feature_size
        self.rnns = []
        for i in range(3):
            rnn = _bilstm(feature_size, d, g, f"{self.name}_l{i}")
            self.add_module(f"rnn{i}", rnn)
            self.rnns.append(rnn)
            d = _width(rnn)
        self.pos_head = _dense(self.num_pos, d, g)
        self.chunk_head = _dense(self.num_chunk, d, g)
        if classifier == "crf":
            self.crf = CRF(self.num_chunk, name=f"{self.name}_crf")
            self.crf.build(None, g)
        self._finish()

    @staticmethod
    def loss(y_true, y_pred):
        """softmax mode: the summed masked CE of the POS and chunk heads."""
        pos_y, chunk_y = y_true
        pos_p, chunk_p = y_pred
        return masked_tag_loss(pos_y, pos_p) + masked_tag_loss(chunk_y,
                                                               chunk_p)

    @staticmethod
    def crf_loss(y_true, y_pred):
        """crf mode: the POS softmax CE + the chunk CRF NLL."""
        pos_y, chunk_y = y_true
        pos_p, chunk_em, packed = y_pred
        return masked_tag_loss(pos_y, pos_p) \
            + crf_tag_loss(chunk_y, (chunk_em, packed))

    def _bundle_loss(self):
        return self.crf_loss if self.classifier == "crf" else self.loss

    def apply(self, x, rng=None):
        if self.has_char:
            h = self.enc(x)
        else:
            h = self.wemb(x[0] if isinstance(x, (list, tuple)) else x)
        h = _dropout(h, self.dropout, self.training, rng)
        for rnn in self.rnns:
            h = rnn(h)
        pos = torch.softmax(self.pos_head(h).float(), dim=-1)
        chunk_logits = self.chunk_head(h)
        if self.classifier == "crf":
            em, packed = self.crf(chunk_logits)
            return pos, em, packed
        return pos, torch.softmax(chunk_logits.float(), dim=-1)

    def compute_output_shape(self, input_shape):
        t = None
        if self.classifier == "crf":
            return [(t, self.num_pos), (t, self.num_chunk),
                    (self.num_chunk + 2, self.num_chunk)]
        return [(t, self.num_pos), (t, self.num_chunk)]


#: the same model under the POS-tagging name
POSTagger = SequenceTagger


@register_model("IntentEntity")
class IntentEntity(_TextModel):
    """Joint intent classification and slot filling.

    Inputs: [word ids (B, T), char ids (B, T, word_length)]. Outputs
    ``(intent_probs (B, num_intents), slot_probs (B, T, num_entities))``;
    train with ``IntentEntity.loss`` on ``(intent (B,), slots (B, T))``
    labels (slots ``PAD_TAG``-padded). The intent reads the tagger's
    states averaged over time."""

    def __init__(self, num_intents: int, num_entities: int,
                 word_vocab_size: int, char_vocab_size: int,
                 word_length: int = 12, word_emb_dim: int = 100,
                 char_emb_dim: int = 30, char_lstm_dim: int = 30,
                 tagger_lstm_dim: int = 100, dropout: float = 0.2,
                 name=None, *, device=None, seed: int = 0):
        super().__init__(dict(num_intents=num_intents,
                              num_entities=num_entities,
                              word_vocab_size=word_vocab_size,
                              char_vocab_size=char_vocab_size,
                              word_length=word_length,
                              word_emb_dim=word_emb_dim,
                              char_emb_dim=char_emb_dim,
                              char_lstm_dim=char_lstm_dim,
                              tagger_lstm_dim=tagger_lstm_dim,
                              dropout=dropout),
                         name, device, seed)
        self.num_intents = int(num_intents)
        self.num_entities = int(num_entities)
        self.dropout = float(dropout)
        g = self._gen
        self.enc = _WordCharEncoder(word_vocab_size, char_vocab_size,
                                    word_emb_dim, char_emb_dim,
                                    char_lstm_dim=char_lstm_dim,
                                    name=f"{self.name}_enc", gen=g)
        self.tagger = _bilstm(tagger_lstm_dim, self.enc.out_dim, g,
                              f"{self.name}_tag")
        h = _width(self.tagger)
        self.intent_head = _dense(self.num_intents, h, g)
        self.slot_head = _dense(self.num_entities, h, g)
        self._finish()

    @staticmethod
    def loss(y_true, y_pred):
        from ...nn.losses import sparse_categorical_crossentropy

        intent_y, slot_y = y_true
        intent_p, slot_p = y_pred
        return sparse_categorical_crossentropy(intent_y, intent_p) \
            + masked_tag_loss(slot_y, slot_p)

    def _bundle_loss(self):
        return self.loss

    def apply(self, x, rng=None):
        h = self.enc(x)
        h = _dropout(h, self.dropout, self.training, rng)
        h = self.tagger(h)
        intent = torch.softmax(self.intent_head(h.mean(dim=1)).float(),
                               dim=-1)
        slots = torch.softmax(self.slot_head(h).float(), dim=-1)
        return intent, slots

    def compute_output_shape(self, input_shape):
        return [(self.num_intents,), (None, self.num_entities)]


__all__ = ["IntentEntity", "NER", "PAD_TAG", "POSTagger", "SequenceTagger",
           "crf_tag_loss", "crf_tag_loss_reg", "masked_tag_loss"]
