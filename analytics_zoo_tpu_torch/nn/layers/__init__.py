"""Keras-style layers of the port (``analytics_zoo_tpu.nn.layers``)."""

from .convolution import (Convolution1D, Convolution2D,
                          GlobalAveragePooling2D, GlobalMaxPooling1D,
                          MaxPooling2D)
from .core import (Activation, Dense, Dropout, InputLayer, Lambda, Narrow,
                   Select, SparseDense)
from .embedding import (Embedding, FusedPairEmbedding, SparseEmbedding,
                        WordEmbedding, load_glove_table)
from .merge import Merge, merge
from .normalization import BatchNormalization, LayerNormalization
from .recurrent import (GRU, LSTM, Bidirectional, ConvLSTM2D, ConvLSTM3D,
                        SimpleRNN, TimeDistributed)

__all__ = ["Activation", "BatchNormalization", "Bidirectional",
           "Convolution1D", "Convolution2D", "ConvLSTM2D", "ConvLSTM3D",
           "Dense", "Dropout", "Embedding", "FusedPairEmbedding", "GRU",
           "GlobalAveragePooling2D", "GlobalMaxPooling1D",
           "InputLayer", "LSTM", "Lambda", "LayerNormalization",
           "MaxPooling2D", "Merge", "Narrow", "Select", "SimpleRNN",
           "SparseDense", "SparseEmbedding", "TimeDistributed",
           "WordEmbedding", "load_glove_table", "merge"]
