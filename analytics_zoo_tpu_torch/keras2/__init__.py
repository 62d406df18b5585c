"""Keras-2 API over the port's layer library (port of
``analytics_zoo_tpu.keras2``).

It carries keras-2 semantics, not just names, as the JAX package's does:

* ``units``/``filters``/``rate``/``kernel_size`` argument conventions;
* separate ``kernel_initializer`` / ``bias_initializer`` /
  ``recurrent_initializer`` (the layer library's ``init`` / ``bias_init``
  / ``inner_init``), ``unit_forget_bias`` on LSTM;
* ``data_format='channels_first'|'channels_last'`` on the conv and
  pooling layers: channels-first inputs are transposed to the library's
  channels-last layout on entry and back on exit by
  :class:`ChannelsFirstWrapper`;
* the keras-2 merge layers (Add/Average/Maximum/Minimum/Multiply/
  Concatenate).

Parameter names and the (in, out) layout are the JAX package's, so
``bridge.state_dict_from_jax`` carries a JAX keras2 model's weights into
the port's unchanged. ``Sequential`` and ``Model`` are the port's: they
run on the card unless given ``device=``.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..nn import layers as L
from ..nn.graph import Input
from ..nn.module import Layer
from ..nn.topology import Model, Sequential

__all__ = [
    "Activation", "Add", "Average", "AveragePooling1D", "AveragePooling2D",
    "BatchNormalization", "Bidirectional", "ChannelsFirstWrapper",
    "Concatenate", "Conv1D", "Conv2D", "Cropping1D", "Dense", "Dropout",
    "Embedding", "Flatten", "GRU", "GlobalAveragePooling1D",
    "GlobalAveragePooling2D", "GlobalAveragePooling3D", "GlobalMaxPooling1D",
    "GlobalMaxPooling2D", "GlobalMaxPooling3D", "Input", "InputLayer", "LSTM",
    "LayerNormalization", "LocallyConnected1D", "MaxPooling1D", "MaxPooling2D",
    "Maximum", "Minimum", "Model", "Multiply", "Reshape", "Sequential",
    "SimpleRNN", "Softmax", "TimeDistributed",
]

InputLayer = L.InputLayer
Activation = L.Activation
Flatten = L.Flatten
Reshape = L.Reshape
Bidirectional = L.Bidirectional
TimeDistributed = L.TimeDistributed
LayerNormalization = L.LayerNormalization
Softmax = L.Softmax
GlobalMaxPooling3D = L.GlobalMaxPooling3D
GlobalAveragePooling3D = L.GlobalAveragePooling3D


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class ChannelsFirstWrapper(Layer):
    """Run a channels-last inner layer on channels-first data: transpose
    NC* → N*C on entry and back on exit. The inner layer's parameters,
    buffers and children are this layer's own (the dicts are shared), so
    the state dict reads ``<slot>.kernel`` as the JAX tree does."""

    def __init__(self, inner: Layer, name=None, input_shape=None):
        # adopt the inner layer's input_shape hint (channels-FIRST at the
        # wrapper's boundary), so Conv2D(..., data_format='channels_first',
        # input_shape=...) works as the first layer of a Sequential
        if input_shape is None and inner.input_shape_hint is not None:
            input_shape = inner.input_shape_hint
            inner.input_shape_hint = None
        super().__init__(name=name or inner.name + "_ch_first",
                         input_shape=input_shape)
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "_parameters", inner._parameters)
        object.__setattr__(self, "_buffers", inner._buffers)
        object.__setattr__(self, "_modules", inner._modules)

    @staticmethod
    def _to_last(shape):
        return tuple(shape[1:]) + (shape[0],)

    def build(self, input_shape, gen) -> None:
        self.inner.build(self._to_last(input_shape), gen)
        self.inner.built = True
        self.built = True

    def train(self, mode: bool = True):
        super().train(mode)
        self.inner.train(mode)          # not a child: set its mode too
        return self

    def apply(self, x):
        nd = x.dim()
        y = self.inner.apply(x.permute((0,) + tuple(range(2, nd)) + (1,)))
        if y.dim() == nd:   # global pooling collapses to (B, C): no move
            y = y.permute((0, nd - 1) + tuple(range(1, nd - 1)))
        return y

    def compute_output_shape(self, input_shape):
        out = self.inner.compute_output_shape(self._to_last(input_shape))
        if len(out) == len(input_shape):
            return (out[-1],) + tuple(out[:-1])
        return tuple(out)


def _df(layer: Layer, data_format: Optional[str]) -> Layer:
    if data_format in (None, "channels_last"):
        return layer
    if data_format == "channels_first":
        return ChannelsFirstWrapper(layer)
    raise ValueError(f"data_format must be 'channels_first'|'channels_last', "
                     f"got {data_format!r}")


# ------------------------------------------------------------------------ core

def Dense(units: int, activation=None, use_bias: bool = True,
          kernel_initializer="glorot_uniform", bias_initializer="zeros",
          kernel_regularizer=None, bias_regularizer=None, input_shape=None,
          name=None):
    return L.Dense(units, activation=activation, use_bias=use_bias,
                   init=kernel_initializer, bias_init=bias_initializer,
                   w_regularizer=kernel_regularizer,
                   b_regularizer=bias_regularizer,
                   input_shape=input_shape, name=name)


def Dropout(rate: float, name=None, input_shape=None):
    return L.Dropout(rate, name=name, input_shape=input_shape)


# ------------------------------------------------------------------------ conv

def Conv1D(filters: int, kernel_size: int, strides: int = 1,
           padding: str = "valid", activation=None, use_bias: bool = True,
           kernel_initializer="glorot_uniform", bias_initializer="zeros",
           input_shape=None, name=None):
    return L.Convolution1D(filters, kernel_size, activation=activation,
                           border_mode=padding, subsample_length=strides,
                           init=kernel_initializer,
                           bias_init=bias_initializer, use_bias=use_bias,
                           input_shape=input_shape, name=name)


def Conv2D(filters: int, kernel_size, strides=(1, 1), padding: str = "valid",
           data_format: Optional[str] = None, activation=None,
           use_bias: bool = True, kernel_initializer="glorot_uniform",
           bias_initializer="zeros", input_shape=None, name=None):
    kh, kw = _pair(kernel_size)
    return _df(L.Convolution2D(filters, kh, kw, activation=activation,
                               border_mode=padding, subsample=_pair(strides),
                               init=kernel_initializer,
                               bias_init=bias_initializer, use_bias=use_bias,
                               input_shape=input_shape, name=name),
               data_format)


def LocallyConnected1D(filters: int, kernel_size: int, strides: int = 1,
                       activation=None, use_bias: bool = True,
                       kernel_initializer="glorot_uniform", input_shape=None,
                       name=None):
    return L.LocallyConnected1D(filters, kernel_size,
                                subsample_length=strides,
                                activation=activation,
                                init=kernel_initializer, use_bias=use_bias,
                                input_shape=input_shape, name=name)


def Cropping1D(cropping=(1, 1), name=None, input_shape=None):
    return L.Cropping1D(cropping=cropping, name=name, input_shape=input_shape)


# --------------------------------------------------------------------- pooling

def MaxPooling1D(pool_size: int = 2, strides: Optional[int] = None,
                 padding: str = "valid", name=None, input_shape=None):
    return L.MaxPooling1D(pool_length=pool_size, stride=strides,
                          border_mode=padding, name=name,
                          input_shape=input_shape)


def AveragePooling1D(pool_size: int = 2, strides: Optional[int] = None,
                     padding: str = "valid", name=None, input_shape=None):
    return L.AveragePooling1D(pool_length=pool_size, stride=strides,
                              border_mode=padding, name=name,
                              input_shape=input_shape)


def MaxPooling2D(pool_size=(2, 2), strides=None, padding: str = "valid",
                 data_format: Optional[str] = None, name=None,
                 input_shape=None):
    return _df(L.MaxPooling2D(
        pool_size=_pair(pool_size),
        strides=None if strides is None else _pair(strides),
        border_mode=padding, name=name, input_shape=input_shape), data_format)


def AveragePooling2D(pool_size=(2, 2), strides=None, padding: str = "valid",
                     data_format: Optional[str] = None, name=None,
                     input_shape=None):
    return _df(L.AveragePooling2D(
        pool_size=_pair(pool_size),
        strides=None if strides is None else _pair(strides),
        border_mode=padding, name=name, input_shape=input_shape), data_format)


def GlobalAveragePooling1D(name=None, input_shape=None):
    return L.GlobalAveragePooling1D(name=name, input_shape=input_shape)


def GlobalMaxPooling1D(name=None, input_shape=None):
    return L.GlobalMaxPooling1D(name=name, input_shape=input_shape)


def GlobalAveragePooling2D(data_format: Optional[str] = None, name=None,
                           input_shape=None):
    return _df(L.GlobalAveragePooling2D(name=name, input_shape=input_shape),
               data_format)


def GlobalMaxPooling2D(data_format: Optional[str] = None, name=None,
                       input_shape=None):
    return _df(L.GlobalMaxPooling2D(name=name, input_shape=input_shape),
               data_format)


# ------------------------------------------------------------------ norm / emb

def BatchNormalization(momentum: float = 0.99, epsilon: float = 1e-3,
                       name=None, input_shape=None):
    return L.BatchNormalization(momentum=momentum, epsilon=epsilon, name=name,
                                input_shape=input_shape)


def Embedding(input_dim: int, output_dim: int, input_length=None,
              embeddings_initializer="uniform", name=None):
    shape = (input_length,) if input_length is not None else None
    return L.Embedding(input_dim, output_dim, init=embeddings_initializer,
                       name=name, input_shape=shape)


# ------------------------------------------------------------------- recurrent

def LSTM(units: int, activation="tanh", recurrent_activation="hard_sigmoid",
         kernel_initializer="glorot_uniform",
         recurrent_initializer="glorot_uniform", bias_initializer="zeros",
         unit_forget_bias: bool = True, return_sequences: bool = False,
         go_backwards: bool = False, name=None, input_shape=None):
    return L.LSTM(units, activation=activation,
                  inner_activation=recurrent_activation,
                  init=kernel_initializer, inner_init=recurrent_initializer,
                  bias_init=bias_initializer,
                  unit_forget_bias=unit_forget_bias,
                  return_sequences=return_sequences, go_backwards=go_backwards,
                  name=name, input_shape=input_shape)


def GRU(units: int, activation="tanh", recurrent_activation="hard_sigmoid",
        kernel_initializer="glorot_uniform",
        recurrent_initializer="glorot_uniform", bias_initializer="zeros",
        return_sequences: bool = False, go_backwards: bool = False,
        name=None, input_shape=None):
    return L.GRU(units, activation=activation,
                 inner_activation=recurrent_activation,
                 init=kernel_initializer, inner_init=recurrent_initializer,
                 bias_init=bias_initializer,
                 return_sequences=return_sequences, go_backwards=go_backwards,
                 name=name, input_shape=input_shape)


def SimpleRNN(units: int, activation="tanh",
              kernel_initializer="glorot_uniform",
              recurrent_initializer="glorot_uniform",
              return_sequences: bool = False, name=None, input_shape=None):
    return L.SimpleRNN(units, activation=activation,
                       init=kernel_initializer,
                       inner_init=recurrent_initializer,
                       return_sequences=return_sequences, name=name,
                       input_shape=input_shape)


# ----------------------------------------------------------------------- merge

def Concatenate(axis: int = -1, name=None):
    return L.Merge(mode="concat", concat_axis=axis, name=name)


def Add(name=None):
    return L.Merge(mode="sum", name=name)


def Multiply(name=None):
    return L.Merge(mode="mul", name=name)


def Maximum(name=None):
    return L.Merge(mode="max", name=name)


def Minimum(name=None):
    return L.Merge(mode="min", name=name)


def Average(name=None):
    return L.Merge(mode="ave", name=name)
