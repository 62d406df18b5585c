"""Keras-style layers of the port (``analytics_zoo_tpu.nn.layers``): every
name of the JAX package's ``__all__``."""

from .advanced_activations import (ELU, LeakyReLU, PReLU, RReLU, SReLU,
                                   Softmax, SpatialDropout1D,
                                   SpatialDropout2D, SpatialDropout3D,
                                   ThresholdedReLU)
from .attention import (BERT, MultiHeadAttention, PositionalEmbedding,
                        TransformerLayer)
from .conv_extended import (AtrousConvolution1D, AtrousConvolution2D,
                            AveragePooling3D, Convolution3D, Cropping1D,
                            Cropping2D, Cropping3D, Deconvolution2D,
                            GlobalAveragePooling3D, GlobalMaxPooling3D, LRN2D,
                            LocallyConnected1D, LocallyConnected2D,
                            MaxPooling3D, ResizeBilinear,
                            SeparableConvolution2D, ShareConvolution2D,
                            UpSampling1D, UpSampling3D, WithinChannelLRN2D,
                            ZeroPadding1D, ZeroPadding3D)
from .convolution import (AveragePooling1D, AveragePooling2D,
                          Convolution1D, Convolution2D, DepthwiseConv2D,
                          GlobalAveragePooling1D, GlobalAveragePooling2D,
                          GlobalMaxPooling1D, GlobalMaxPooling2D,
                          MaxPooling1D, MaxPooling2D, UpSampling2D,
                          ZeroPadding2D)
from .core import (Activation, Dense, Dropout, ExpandDim, Flatten,
                   GaussianDropout, GaussianNoise, Highway, InputLayer,
                   Lambda, Masking, MaxoutDense, Narrow, Permute,
                   RepeatVector, Reshape, Select, SparseDense, Squeeze)
from .crf import CRF, crf_decode, crf_log_likelihood, crf_nll_from_packed
from .elementwise import (MM, ERF, AddConstant, BinaryThreshold, CAdd, CMul,
                          Exp, Expand, GaussianSampler, GetShape, HardShrink,
                          HardTanh, Identity, KerasLayerWrapper, Log, Max,
                          Mul, MulConstant, Negative, Power, Scale,
                          SelectTable, SoftShrink, SplitTensor, Sqrt, Square,
                          Threshold)
from .embedding import (Embedding, FusedPairEmbedding, SparseEmbedding,
                        WordEmbedding, load_glove_table)
from .merge import Merge, merge
from .moe import MoE
from .normalization import BatchNormalization, LayerNormalization
from .recurrent import (GRU, LSTM, Bidirectional, ConvLSTM2D, ConvLSTM3D,
                        SimpleRNN, TimeDistributed)

Conv1D = Convolution1D
Conv2D = Convolution2D
Conv3D = Convolution3D
ShareConv2D = ShareConvolution2D
Input = InputLayer
LayerNorm = LayerNormalization

__all__ = [
    "Input", "LayerNorm",
    "Activation", "AddConstant", "AtrousConvolution1D", "AtrousConvolution2D",
    "AveragePooling1D", "AveragePooling2D", "AveragePooling3D", "BERT",
    "BatchNormalization", "Bidirectional", "BinaryThreshold", "CAdd", "CMul",
    "CRF", "Conv1D", "Conv2D", "Conv3D", "ConvLSTM2D", "ConvLSTM3D",
    "Convolution1D", "Convolution2D", "Convolution3D", "Cropping1D",
    "Cropping2D", "Cropping3D", "crf_decode", "crf_log_likelihood",
    "crf_nll_from_packed", "Deconvolution2D", "Dense", "DepthwiseConv2D",
    "Dropout", "ELU", "Embedding", "FusedPairEmbedding", "ERF", "Exp",
    "Expand", "ExpandDim", "Flatten", "GRU", "GaussianDropout",
    "GaussianNoise", "GaussianSampler", "GetShape", "GlobalAveragePooling1D",
    "GlobalAveragePooling2D", "GlobalAveragePooling3D", "GlobalMaxPooling1D",
    "GlobalMaxPooling2D", "GlobalMaxPooling3D", "HardShrink", "HardTanh",
    "Highway", "Identity", "InputLayer", "KerasLayerWrapper", "LRN2D", "LSTM",
    "Lambda", "LayerNormalization", "LeakyReLU", "LocallyConnected1D",
    "LocallyConnected2D", "Log", "Masking", "MM", "Max", "MaxPooling1D",
    "MaxPooling2D", "MaxPooling3D", "MaxoutDense", "Merge", "MoE", "Mul", "MultiHeadAttention",
    "MulConstant", "Narrow", "Negative", "PReLU", "Permute", "PositionalEmbedding", "Power", "RReLU",
    "RepeatVector", "Reshape", "ResizeBilinear", "SReLU", "Scale", "Select",
    "SelectTable", "SeparableConvolution2D", "ShareConv2D",
    "ShareConvolution2D", "SimpleRNN", "Softmax", "SoftShrink", "SparseDense",
    "SparseEmbedding", "SpatialDropout1D", "SpatialDropout2D",
    "SpatialDropout3D", "SplitTensor", "Sqrt", "Square", "Squeeze",
    "Threshold", "ThresholdedReLU", "TimeDistributed", "TransformerLayer", "UpSampling1D",
    "UpSampling2D", "UpSampling3D", "WithinChannelLRN2D", "WordEmbedding",
    "ZeroPadding1D", "ZeroPadding2D", "ZeroPadding3D", "load_glove_table",
    "merge",
]
