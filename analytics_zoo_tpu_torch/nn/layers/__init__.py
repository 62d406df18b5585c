"""Keras-style layers of the port (``analytics_zoo_tpu.nn.layers``)."""

from .convolution import (Convolution2D, GlobalAveragePooling2D,
                          MaxPooling2D)
from .core import Activation, Dense, InputLayer, Narrow
from .embedding import (Embedding, FusedPairEmbedding, SparseEmbedding,
                        WordEmbedding, load_glove_table)
from .merge import Merge, merge
from .normalization import BatchNormalization, LayerNormalization

__all__ = ["Activation", "BatchNormalization", "Convolution2D", "Dense",
           "Embedding", "FusedPairEmbedding", "GlobalAveragePooling2D",
           "InputLayer", "LayerNormalization", "MaxPooling2D", "Merge",
           "Narrow", "SparseEmbedding", "WordEmbedding", "load_glove_table",
           "merge"]
