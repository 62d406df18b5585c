"""TextClassifier: a word embedding, a CNN, LSTM or GRU encoder and a dense
head (port of ``analytics_zoo_tpu/models/textclassification/
text_classifier.py``; the reference's news20 app).

The layers are the JAX model's, in its order: the embedding (a trainable
``Embedding`` over ``vocab_size`` words, or a frozen ``WordEmbedding``
from a GloVe file and a word index), then ``Convolution1D(encoder_output_
dim, 5, relu)`` + ``GlobalMaxPooling1D`` (``cnn``), ``LSTM`` or ``GRU``,
then ``Dense(128)``, ``Dropout(0.2)``, ReLU and a softmax over
``class_num``. Parameters keep the JAX tree's slot names, so a JAX
``TextClassifier``'s params load through ``bridge.params_from_jax``, and
``save_model``/``load_model`` write and read the JAX bundle format (a
bundle loads in either package, and ``InferenceModel.load_zoo`` rebuilds
it from its config). ``device``: CUDA unless given; ``seed`` draws the
port's own initial weights.
"""

from __future__ import annotations

from typing import Dict, Optional

from ...nn import layers as L
from ...nn.topology import Sequential
from ..common.zoo_model import register_model


@register_model("TextClassifier")
class TextClassifier(Sequential):
    """``class_num``, ``embedding_file``, ``word_index``,
    ``sequence_length``, ``encoder`` (``cnn``, ``lstm``, ``gru``),
    ``encoder_output_dim``; ``vocab_size``/``embed_dim`` for the
    file-less embedding; ``frozen_embedding`` rebuilds a frozen table
    from a saved bundle."""

    def __init__(self, class_num: int, embedding_file: Optional[str] = None,
                 word_index: Optional[Dict[str, int]] = None,
                 sequence_length: int = 500, encoder: str = "cnn",
                 encoder_output_dim: int = 256,
                 vocab_size: Optional[int] = None, embed_dim: int = 200,
                 frozen_embedding: Optional[bool] = None, *, device=None,
                 seed: int = 0):
        super().__init__(name="text_classifier", device=device, seed=seed)
        self.class_num = int(class_num)
        self.sequence_length = int(sequence_length)
        self.encoder = encoder.lower()
        self.encoder_output_dim = int(encoder_output_dim)
        self.embed_dim = int(embed_dim)
        if self.encoder not in ("cnn", "lstm", "gru"):
            raise ValueError(f"Unsupported encoder for TextClassifier: "
                             f"{encoder}")

        if embedding_file is not None:
            if word_index is None:
                raise ValueError("word_index is required with "
                                 "embedding_file (use "
                                 "TextSet.get_word_index())")
            embedding = L.WordEmbedding.from_glove(
                embedding_file, word_index, output_dim=embed_dim)
            self.vocab_size = embedding.input_dim
            self.frozen_embedding = True
        else:
            if vocab_size is None:
                vocab_size = ((max(word_index.values()) + 1) if word_index
                              else 20000)
            self.vocab_size = int(vocab_size)
            self.frozen_embedding = bool(frozen_embedding)
            if self.frozen_embedding:
                embedding = L.WordEmbedding(self.vocab_size, embed_dim)
            else:
                embedding = L.Embedding(self.vocab_size, embed_dim,
                                        init="uniform")
        embedding.input_shape_hint = (self.sequence_length,)

        self.add(embedding)
        if self.encoder == "cnn":
            self.add(L.Convolution1D(self.encoder_output_dim, 5,
                                     activation="relu"))
            self.add(L.GlobalMaxPooling1D())
        elif self.encoder == "lstm":
            self.add(L.LSTM(self.encoder_output_dim))
        else:
            self.add(L.GRU(self.encoder_output_dim))
        self.add(L.Dense(128))
        self.add(L.Dropout(0.2))
        self.add(L.Activation("relu"))
        self.add(L.Dense(self.class_num, activation="softmax"))
        self.eval()

    def constructor_config(self) -> dict:
        return dict(class_num=self.class_num,
                    sequence_length=self.sequence_length,
                    encoder=self.encoder,
                    encoder_output_dim=self.encoder_output_dim,
                    vocab_size=self.vocab_size, embed_dim=self.embed_dim,
                    frozen_embedding=self.frozen_embedding)

    def save_model(self, path: str):
        from ..common.zoo_model import save_model_bundle

        save_model_bundle(path, self, config=self.constructor_config())

    @classmethod
    def load_model(cls, path: str, *, device=None) -> "TextClassifier":
        from ..common.zoo_model import load_model_bundle

        model, _ = load_model_bundle(path, device=device)
        return model


__all__ = ["TextClassifier"]
