"""Recurrent layers: SimpleRNN, LSTM, GRU, Bidirectional and
TimeDistributed (port of ``analytics_zoo_tpu/nn/layers/recurrent.py``).

Parameters keep the JAX names and layouts: ``kernel`` (in, g·H),
``recurrent_kernel`` (H, g·H) and ``bias`` (g·H), the gates in the JAX
order (LSTM [i, f, c, o], GRU [z, r, h]). These are not cuDNN's cells:
the gates are ``hard_sigmoid`` by default and the GRU applies its reset
gate after the recurrent product (``r * (h @ U_h)``), so ``nn.GRU`` and
``nn.LSTM`` do not compute them. The time loop is a Python loop over
tensors (the JAX ``lax.scan``): the input projection of all T steps is
one (B·T, D) product before the loop, so a step holds only ``h @
recurrent_kernel`` and the gate arithmetic. Hoisting it sums in another
order than JAX's per-step product; the two agree within 1e-5 in f32.

``Bidirectional`` keeps the JAX tree ``{"forward": ..., "backward":
...}``; ``TimeDistributed`` holds its inner layer's parameters under its
own slot, as the JAX tree does (no ``layer`` level).

``ConvLSTM2D`` and ``ConvLSTM3D`` keep the JAX structure: one input conv
(strided, ``border_mode``) giving 4·filters channels, hoisted over all T
steps as one (B·T) conv, then a SAME recurrent conv on the hidden state
each step, the gates [i, f, c, o] as in the JAX cell.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..activations import get_activation
from ..module import Layer, as_compute, get_initializer, zeros_init
from .conv_extended import conv_nd


class _RNNBase(Layer):
    """The shared time loop; subclasses give ``n_gates``, the initial
    carry and ``step(xw_t, carry, U) -> (carry, h)`` over the step's
    input projection ``xw_t`` (bias included)."""

    n_gates = 1

    def __init__(self, output_dim: int, activation="tanh",
                 return_sequences=False, go_backwards=False,
                 init="glorot_uniform", inner_init="glorot_uniform",
                 bias_init="zeros", name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.output_dim = int(output_dim)
        self.activation = get_activation(activation)
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        self.init = get_initializer(init)
        self.inner_init = get_initializer(inner_init)
        self.bias_init = get_initializer(bias_init)

    def build(self, input_shape, gen: torch.Generator) -> None:
        g, h = self.n_gates, self.output_dim
        self.kernel = nn.Parameter(self.init(gen, (input_shape[-1], g * h)))
        self.recurrent_kernel = nn.Parameter(self.inner_init(gen, (h, g * h)))
        self.bias = nn.Parameter(self.bias_init(gen, (g * h,)))
        self.built = True

    def initial_carry(self, h0: torch.Tensor):
        return h0

    def step(self, xw_t, carry, u):
        raise NotImplementedError

    def apply(self, x):
        x = as_compute(x)
        b, t, d = x.shape
        if self.go_backwards:
            x = x.flip(1)
        dt = x.dtype
        xw = torch.addmm(self.bias.to(dt), x.reshape(b * t, d),
                         self.kernel.to(dt)).reshape(b, t, -1)
        u = self.recurrent_kernel.to(dt)
        carry = self.initial_carry(x.new_zeros((b, self.output_dim)))
        outs = []
        # unbind and split, not slices: their backward writes the steps'
        # (and gates') gradients with one stack or cat, where a slice's
        # backward fills a zero tensor of the whole input per slice
        for xw_t in xw.unbind(1):
            carry, h = self.step(xw_t, carry, u)
            outs.append(h)
        if not self.return_sequences:
            return outs[-1]
        seq = torch.stack(outs, dim=1)
        return seq.flip(1) if self.go_backwards else seq

    def compute_output_shape(self, input_shape):
        steps = input_shape[0]
        if self.return_sequences:
            return (steps, self.output_dim)
        return (self.output_dim,)


class SimpleRNN(_RNNBase):
    n_gates = 1

    def step(self, xw_t, h, u):
        h = self.activation(xw_t + h @ u)
        return h, h


class LSTM(_RNNBase):
    """LSTM, gates [i, f, c, o]. ``unit_forget_bias`` sets the forget
    gate's bias to 1 at build (off by default, as in the reference)."""

    n_gates = 4

    def __init__(self, output_dim, activation="tanh",
                 inner_activation="hard_sigmoid", return_sequences=False,
                 go_backwards=False, init="glorot_uniform",
                 inner_init="glorot_uniform", bias_init="zeros",
                 unit_forget_bias: bool = False, name=None,
                 input_shape=None):
        super().__init__(output_dim, activation, return_sequences,
                         go_backwards, init, inner_init, bias_init,
                         name=name, input_shape=input_shape)
        self.inner_activation = get_activation(inner_activation)
        self.unit_forget_bias = bool(unit_forget_bias)

    def build(self, input_shape, gen: torch.Generator) -> None:
        super().build(input_shape, gen)
        if self.unit_forget_bias:
            h = self.output_dim
            with torch.no_grad():
                self.bias[h:2 * h] = 1.0

    def initial_carry(self, h0):
        return h0, h0

    def step(self, xw_t, carry, u):
        h_prev, c_prev = carry
        i, f, g, o = (xw_t + h_prev @ u).chunk(4, dim=-1)
        i = self.inner_activation(i)
        f = self.inner_activation(f)
        o = self.inner_activation(o)
        c = f * c_prev + i * self.activation(g)
        h = o * self.activation(c)
        return (h, c), h


class GRU(_RNNBase):
    """GRU, gates [z, r, h]; the reset gate scales the recurrent product
    of the candidate (``r * (h @ U_h)``), as the JAX package computes it."""

    n_gates = 3

    def __init__(self, output_dim, activation="tanh",
                 inner_activation="hard_sigmoid", return_sequences=False,
                 go_backwards=False, init="glorot_uniform",
                 inner_init="glorot_uniform", bias_init="zeros", name=None,
                 input_shape=None):
        super().__init__(output_dim, activation, return_sequences,
                         go_backwards, init, inner_init, bias_init,
                         name=name, input_shape=input_shape)
        self.inner_activation = get_activation(inner_activation)

    def step(self, xw_t, h_prev, u):
        hd = self.output_dim
        xzr, xh = xw_t.split((2 * hd, hd), dim=-1)
        uzr, uh = (h_prev @ u).split((2 * hd, hd), dim=-1)
        z, r = self.inner_activation(xzr + uzr).split(hd, dim=-1)
        hh = self.activation(xh + r * uh)
        h = (1 - z) * hh + z * h_prev
        return h, h


class _ConvLSTMBase(_RNNBase):
    """Convolutional LSTM over (B, T, *spatial, C), channels last:
    ``kernel`` (*k, C, 4F), ``recurrent_kernel`` (*k, F, 4F), ``bias``
    (4F,) zeros."""

    n_spatial = 2

    def __init__(self, output_dim: int, nb_kernel: int, activation="tanh",
                 inner_activation="hard_sigmoid", border_mode: str = "valid",
                 subsample: int = 1, return_sequences=False,
                 go_backwards=False, init="glorot_uniform",
                 inner_init="glorot_uniform", name=None, input_shape=None):
        super().__init__(output_dim, activation, return_sequences,
                         go_backwards, init, inner_init, name=name,
                         input_shape=input_shape)
        self.nb_kernel = int(nb_kernel)
        self.padding = border_mode.upper()
        self.stride = int(subsample)
        self.inner_activation = get_activation(inner_activation)

    def _spatial_out(self, spatial):
        k, s = self.nb_kernel, self.stride
        if self.padding == "SAME":
            return tuple(-(-d // s) for d in spatial)
        return tuple((d - k) // s + 1 for d in spatial)

    def build(self, input_shape, gen: torch.Generator) -> None:
        ksp = (self.nb_kernel,) * self.n_spatial
        f = self.output_dim
        self.kernel = nn.Parameter(self.init(gen, ksp + (input_shape[-1],
                                                         4 * f)))
        self.recurrent_kernel = nn.Parameter(self.inner_init(
            gen, ksp + (f, 4 * f)))
        self.bias = nn.Parameter(zeros_init((4 * f,)))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        nd = self.n_spatial
        b, t = x.shape[0], x.shape[1]
        if self.go_backwards:
            x = x.flip(1)
        dt = x.dtype
        zx = conv_nd(x.reshape((b * t,) + tuple(x.shape[2:])), self.kernel,
                     (self.stride,) * nd, self.padding)
        zx = zx.reshape((b, t) + tuple(zx.shape[1:]))
        u, bias = self.recurrent_kernel.to(dt), self.bias.to(dt)
        h = x.new_zeros((b,) + tuple(zx.shape[2:-1]) + (self.output_dim,))
        c = h
        outs = []
        for zx_t in zx.unbind(1):
            z = zx_t + conv_nd(h, u, (1,) * nd, "SAME") + bias
            i, f, g, o = z.chunk(4, dim=-1)
            c = (self.inner_activation(f) * c
                 + self.inner_activation(i) * self.activation(g))
            h = self.inner_activation(o) * self.activation(c)
            outs.append(h)
        if not self.return_sequences:
            return outs[-1]
        seq = torch.stack(outs, dim=1)
        return seq.flip(1) if self.go_backwards else seq

    def compute_output_shape(self, input_shape):
        out = self._spatial_out(input_shape[1:-1]) + (self.output_dim,)
        if self.return_sequences:
            return (input_shape[0],) + out
        return out


class ConvLSTM2D(_ConvLSTMBase):
    """(B, T, H, W, C) through a conv-LSTM."""

    n_spatial = 2


class ConvLSTM3D(_ConvLSTMBase):
    """(B, T, D, H, W, C) through a conv-LSTM."""

    n_spatial = 3


class Bidirectional(Layer):
    """Run a recurrent layer forward and a copy of it backward
    (``go_backwards``, named ``<name>_bwd``) and merge the two outputs:
    ``concat``, ``sum``, ``mul`` or ``ave``."""

    _MODES = ("concat", "sum", "mul", "ave")

    def __init__(self, layer: _RNNBase, merge_mode: str = "concat",
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        if merge_mode not in self._MODES:
            raise ValueError(f"merge_mode {merge_mode!r}; known: "
                             f"{self._MODES}")
        if layer.built:
            raise ValueError("Bidirectional wraps an unbuilt layer")
        backward = copy.deepcopy(layer)
        backward.name = layer.name + "_bwd"
        backward.go_backwards = True
        # the JAX tree's keys; "forward" is also nn.Module's method, which
        # add_module refuses to shadow: register and read them by key
        self._modules["forward"] = layer
        self._modules["backward"] = backward
        self.merge_mode = merge_mode

    def build(self, input_shape, gen: torch.Generator) -> None:
        for key in ("forward", "backward"):
            self._modules[key].build(input_shape, gen)
            self._modules[key].built = True
        self.built = True

    def apply(self, x):
        yf = self._modules["forward"].apply(x)
        yb = self._modules["backward"].apply(x)
        if self.merge_mode == "concat":
            return torch.cat([yf, yb], dim=-1)
        if self.merge_mode == "sum":
            return yf + yb
        if self.merge_mode == "mul":
            return yf * yb
        return (yf + yb) / 2

    def compute_output_shape(self, input_shape):
        out = self._modules["forward"].compute_output_shape(input_shape)
        if self.merge_mode == "concat":
            return tuple(out[:-1]) + (out[-1] * 2,)
        return out


class TimeDistributed(Layer):
    """Apply ``layer`` to every time step: (B, T, ...) runs as one (B·T,
    ...) call. The inner layer's parameters, buffers and children are this
    layer's own (the dicts are shared), so the state dict reads
    ``<slot>.kernel`` as the JAX tree does."""

    def __init__(self, layer: Layer, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        object.__setattr__(self, "layer", layer)
        object.__setattr__(self, "_parameters", layer._parameters)
        object.__setattr__(self, "_buffers", layer._buffers)
        object.__setattr__(self, "_modules", layer._modules)

    def build(self, input_shape, gen: torch.Generator) -> None:
        self.layer.build(tuple(input_shape[1:]), gen)
        self.layer.built = True
        self.built = True

    def train(self, mode: bool = True):
        super().train(mode)
        self.layer.train(mode)          # not a child: set its mode too
        return self

    def apply(self, x):
        b, t = x.shape[0], x.shape[1]
        y = self.layer.apply(x.reshape((b * t,) + tuple(x.shape[2:])))
        return y.reshape((b, t) + tuple(y.shape[1:]))

    def compute_output_shape(self, input_shape):
        inner = self.layer.compute_output_shape(tuple(input_shape[1:]))
        return (input_shape[0],) + tuple(inner)


__all__ = ["Bidirectional", "ConvLSTM2D", "ConvLSTM3D", "GRU", "LSTM",
           "SimpleRNN", "TimeDistributed"]
