"""Keras-style layers of the port (``analytics_zoo_tpu.nn.layers``)."""

from .convolution import (Convolution2D, GlobalAveragePooling2D,
                          MaxPooling2D)
from .core import Activation, Dense, InputLayer
from .merge import Merge
from .normalization import BatchNormalization, LayerNormalization

__all__ = ["Activation", "BatchNormalization", "Convolution2D", "Dense",
           "GlobalAveragePooling2D", "InputLayer", "LayerNormalization",
           "MaxPooling2D", "Merge"]
