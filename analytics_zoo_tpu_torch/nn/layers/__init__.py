"""Keras-style layers of the port (``analytics_zoo_tpu.nn.layers``)."""

from .convolution import (Convolution2D, GlobalAveragePooling2D,
                          MaxPooling2D)
from .core import (Activation, Dense, InputLayer, Lambda, Narrow, Select,
                   SparseDense)
from .embedding import (Embedding, FusedPairEmbedding, SparseEmbedding,
                        WordEmbedding, load_glove_table)
from .merge import Merge, merge
from .normalization import BatchNormalization, LayerNormalization
from .recurrent import (GRU, LSTM, Bidirectional, ConvLSTM2D, ConvLSTM3D,
                        SimpleRNN, TimeDistributed)

__all__ = ["Activation", "BatchNormalization", "Bidirectional",
           "Convolution2D", "ConvLSTM2D", "ConvLSTM3D", "Dense", "Embedding",
           "FusedPairEmbedding", "GRU", "GlobalAveragePooling2D",
           "InputLayer", "LSTM", "Lambda", "LayerNormalization",
           "MaxPooling2D", "Merge", "Narrow", "Select", "SimpleRNN",
           "SparseDense", "SparseEmbedding", "TimeDistributed",
           "WordEmbedding", "load_glove_table", "merge"]
