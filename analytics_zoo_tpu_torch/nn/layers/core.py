"""Core layers (port of ``analytics_zoo_tpu/nn/layers/core.py``):
InputLayer, Dense (with ``w_regularizer``/``b_regularizer``), SparseDense,
Activation, Dropout, GaussianNoise, GaussianDropout, the shape layers
(Flatten, Reshape, Permute, RepeatVector, Select, Narrow, Squeeze,
ExpandDim), Masking, Highway, MaxoutDense and Lambda.

Parameters keep the JAX names and layout: ``kernel`` (in, out) and
``bias``. After ``InferenceModel.quantize_int8`` packs a Dense, its
``kernel`` parameter is replaced by the buffers ``kernel_q`` (int8) and
``kernel_scale`` (f32, per output channel) and the forward runs the int8
matmul (``ops/int8.py``: K5 on the card). A third, non-persistent buffer,
``kernel_qt``, holds ``kernel_q`` kernel-major for the kernels, so state
dicts and the bridge see only the first two.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ...common import prng
from ...ops.int8 import int8_matmul
from ...ops.int8_fused import kernel_major
from ..activations import get_activation
from ...analysis import trace as _trace
from ..module import Layer, as_compute, get_initializer, zeros_init
from ..regularizers import get_regularizer


class InputLayer(Layer):
    """Placeholder layer carrying an input shape (graph inputs)."""

    def __init__(self, input_shape, name: Optional[str] = None):
        super().__init__(name=name, input_shape=input_shape)

    def apply(self, x):
        return x


class Int8Kernel:
    """Mixin of the layers whose forward computes in int8 once packed."""

    @property
    def is_int8(self) -> bool:
        return "kernel_q" in self._buffers

    @property
    def packed_kernel(self):
        """``{"q", "scale", "qt"}``; ``qt`` is made again when ``kernel_q``
        was replaced or written since (``load_state_dict``, ``to``, a
        functional call with other weights)."""
        q = self.kernel_q
        if _trace.RECORDING and _trace.recording():
            # a recorded call reads the buffers it was handed: its fake
            # kernel_qt stands for the current one, and the stamp of the
            # real buffers stays as it is
            return {"q": q, "scale": self.kernel_scale, "qt": self.kernel_qt}
        stamp = (q.data_ptr(), q._version)
        if self.__dict__.get("_qt_stamp") != stamp:
            self._buffers["kernel_qt"] = kernel_major(q)
            self._qt_stamp = stamp
        return {"q": q, "scale": self.kernel_scale, "qt": self.kernel_qt}

    def pack_int8(self, packed) -> None:
        """Replace the float ``kernel`` (or the packing in place) by
        ``packed``: ``quantize_weight``'s numpy packing, moved to the
        kernel's device, or tensors already there (a hot swap's staged
        re-pack, its kernel-major copy as ``"qt"``). The kernel-major copy
        (``ops/int8_fused.kernel_major``) is a non-persistent buffer. Only
        references change, so a swap can flip a packing between two
        dispatches."""
        dev = (self._parameters["kernel"] if "kernel" in self._parameters
               else self.kernel_q).device
        if "kernel" in self._parameters:
            del self.kernel

        def on_dev(a):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(np.ascontiguousarray(a))
            return a.to(dev)

        q = on_dev(packed["q"])
        qt = packed.get("qt")
        self.register_buffer("kernel_q", q)
        self.register_buffer("kernel_scale", on_dev(packed["scale"]))
        self.register_buffer("kernel_qt", kernel_major(q) if qt is None
                             else qt, persistent=False)
        self._qt_stamp = (q.data_ptr(), q._version)


class Dense(Int8Kernel, Layer):
    """Fully-connected layer: ``y = act(x @ W + b)``, ``W`` stored (in,
    out)."""

    def __init__(self, output_dim: int, activation=None, use_bias: bool = True,
                 init="glorot_uniform", bias_init="zeros", w_regularizer=None,
                 b_regularizer=None, name: Optional[str] = None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.output_dim = int(output_dim)
        self.activation = get_activation(activation)
        self.use_bias = use_bias
        self.init = get_initializer(init)
        self.bias_init = get_initializer(bias_init)
        self.w_regularizer = get_regularizer(w_regularizer)
        self.b_regularizer = get_regularizer(b_regularizer)

    def build(self, input_shape, gen: torch.Generator) -> None:
        self.kernel = nn.Parameter(self.init(gen, (input_shape[-1],
                                                   self.output_dim)))
        if self.use_bias:
            self.bias = nn.Parameter(self.bias_init(gen, (self.output_dim,)))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        if self.is_int8:
            y = int8_matmul(x, self.packed_kernel)
        else:
            y = x @ self.kernel.to(x.dtype)
        if self.use_bias:
            y = y + self.bias.to(x.dtype)
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class SparseDense(Dense):
    """Dense over a dense multi-hot input (Wide & Deep's wide part): the
    JAX package keeps the wide vector dense, since one matmul beats a
    gather at these widths, and so does the port."""


class Select(Layer):
    """Index ``index`` along ``dim`` (0-indexed over the non-batch dims;
    negative counts from the end), the dim dropped. The input keeps its
    dtype: float ids stay float until ``Embedding`` casts them."""

    def __init__(self, dim: int, index: int, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.dim, self.index = int(dim), int(index)

    def apply(self, x):
        return x.select(self.dim + 1 if self.dim >= 0 else self.dim,
                        self.index)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        del shape[self.dim]
        return tuple(shape)


class Narrow(Layer):
    """Slice ``length`` elements starting at ``offset`` along ``dim``
    (0-indexed over the non-batch dims; negative counts from the end); a
    view of the input."""

    def __init__(self, dim: int, offset: int, length: int = 1, name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.dim, self.offset, self.length = int(dim), int(offset), int(length)

    def apply(self, x):
        axis = self.dim + 1 if self.dim >= 0 else self.dim
        return x.narrow(axis, self.offset, self.length)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        shape[self.dim] = self.length
        return tuple(shape)


class Activation(Layer):
    def __init__(self, activation, name: Optional[str] = None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.activation = get_activation(activation)

    def apply(self, x):
        return self.activation(as_compute(x))


def global_draw(draw: Callable, key, shape, device) -> torch.Tensor:
    """``draw(key, shape, device)``, the JAX draw of a training step's
    random tensor. On a rank's block of a global batch
    (``parallel.comm.batch_shard``) whose step key is the same on every
    rank, it is drawn for the global batch and the block's rows taken, as
    the JAX step draws it over the global array."""
    from ...parallel.comm import current_batch_shard

    shard = current_batch_shard()
    if shard is not None and shard.global_draws and shard.count > 1:
        b = shape[0]
        whole = draw(key, (b * shard.count,) + tuple(shape[1:]), device)
        return whole[shard.index * b:(shard.index + 1) * b]
    return draw(key, tuple(shape), device)


def normal_draw(key, shape, device) -> torch.Tensor:
    return global_draw(lambda k, s, d: prng.normal(k, s, device=d), key,
                       shape, device)


def dropout(x: torch.Tensor, rate: float, key, mask_shape=None
            ) -> torch.Tensor:
    """Inverted dropout with the JAX package's mask: keep where
    ``prng.bernoulli(key, 1 - rate, mask_shape)`` (x's shape by default;
    a mask of size 1 on a dim is shared along it), as ``x / keep`` in x's
    dtype (``keep`` rounded to it, as JAX's weak-typed scalar is), zero
    elsewhere. The mask is drawn on x's device (:func:`global_draw`): the
    same bits on the card, the CPU and JAX."""
    keep = 1.0 - rate
    mask = global_draw(lambda k, s, d: prng.bernoulli(k, keep, s, device=d),
                       key, x.shape if mask_shape is None else mask_shape,
                       x.device)
    kept = x / torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, kept, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


class Dropout(Layer):
    """Inverted dropout: the identity at inference; in training mode it
    needs a key (``apply(x, rng=key)``, which a container or the Estimator
    hands it) and raises without one. Starts in inference mode, as a JAX
    layer's ``apply`` defaults to ``training=False``."""

    takes_rng = True

    def __init__(self, p: float, name: Optional[str] = None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.rate = float(p)
        self.training = False

    def apply(self, x, rng=None):
        if not self.training or self.rate <= 0.0:
            return x
        if rng is None:
            raise ValueError(f"{self.name}: dropout in training mode needs "
                             f"an rng")
        return dropout(x, self.rate, rng)


def _needs_rng(layer, rng):
    if rng is None:
        raise ValueError(f"{layer.name}: needs rng in training mode")


class GaussianNoise(Layer):
    """``x + sigma · N(0, 1)`` in training (the JAX draw,
    ``prng.normal``, from the layer's key); the identity at inference."""

    takes_rng = True

    def __init__(self, sigma: float, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.sigma = float(sigma)
        self.training = False

    def apply(self, x, rng=None):
        if not self.training:
            return x
        _needs_rng(self, rng)
        return x + self.sigma * normal_draw(rng, x.shape, x.device).to(
            x.dtype)


class GaussianDropout(Layer):
    """``x · (1 + sqrt(p / (1 - p)) · N(0, 1))`` in training; the
    identity at inference."""

    takes_rng = True

    def __init__(self, p: float, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.rate = float(p)
        self.training = False

    def apply(self, x, rng=None):
        if not self.training or self.rate <= 0:
            return x
        _needs_rng(self, rng)
        std = float(np.sqrt(self.rate / (1.0 - self.rate)))
        return x * (1.0 + std * normal_draw(rng, x.shape, x.device).to(
            x.dtype))


class Flatten(Layer):
    def apply(self, x):
        return x.reshape(x.shape[0], -1)

    def compute_output_shape(self, input_shape):
        return (int(np.prod(input_shape)),)


class Reshape(Layer):
    """Reshape the non-batch dims; one target dim may be -1."""

    def __init__(self, target_shape, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.target_shape = tuple(target_shape)

    def apply(self, x):
        return x.reshape((x.shape[0],) + self.target_shape)

    def compute_output_shape(self, input_shape):
        if -1 in self.target_shape:
            total = int(np.prod(input_shape))
            known = -int(np.prod(self.target_shape))
            return tuple(total // known if d == -1 else d
                         for d in self.target_shape)
        return self.target_shape


class Permute(Layer):
    """Permute the non-batch dims; ``dims`` are 1-indexed, as in Keras."""

    def __init__(self, dims, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.dims = tuple(dims)

    def apply(self, x):
        return x.permute((0,) + self.dims)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[d - 1] for d in self.dims)


class RepeatVector(Layer):
    """(B, D) to (B, n, D)."""

    def __init__(self, n: int, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.n = int(n)

    def apply(self, x):
        return x.unsqueeze(1).repeat(1, self.n, 1)

    def compute_output_shape(self, input_shape):
        return (self.n,) + tuple(input_shape)


class Squeeze(Layer):
    """Drop the (0-indexed, non-batch) ``dim`` of size 1."""

    def __init__(self, dim: int, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.dim = int(dim)

    def apply(self, x):
        if x.shape[self.dim + 1] != 1:
            raise ValueError(f"{self.name}: dim {self.dim} has size "
                             f"{x.shape[self.dim + 1]}, not 1")
        return x.squeeze(self.dim + 1)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        del shape[self.dim]
        return tuple(shape)


class ExpandDim(Layer):
    """Insert a dim of size 1 at (0-indexed, non-batch) ``dim``."""

    def __init__(self, dim: int, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.dim = int(dim)

    def apply(self, x):
        return x.unsqueeze(self.dim + 1)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        shape.insert(self.dim, 1)
        return tuple(shape)


class Masking(Layer):
    """Zero the timesteps whose features all equal ``mask_value``."""

    def __init__(self, mask_value: float = 0.0, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.mask_value = mask_value

    def apply(self, x):
        keep = (x != self.mask_value).any(dim=-1, keepdim=True)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


class Highway(Layer):
    """``y = T · act(x W_h + b_h) + (1 - T) · x`` with the gate
    ``T = sigmoid(x W_t + b_t)``: one (D, 2D) kernel, the gate's columns
    first."""

    def __init__(self, activation=None, use_bias: bool = True,
                 init="glorot_uniform", name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.activation = get_activation(activation)
        self.use_bias = use_bias
        self.init = get_initializer(init)

    def build(self, input_shape, gen: torch.Generator) -> None:
        d = input_shape[-1]
        self.kernel = nn.Parameter(self.init(gen, (d, 2 * d)))
        if self.use_bias:
            self.bias = nn.Parameter(zeros_init((2 * d,)))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        z = x @ self.kernel.to(x.dtype)
        if self.use_bias:
            z = z + self.bias.to(x.dtype)
        d = x.shape[-1]
        gate = torch.sigmoid(z[..., :d])
        return gate * self.activation(z[..., d:]) + (1.0 - gate) * x


class MaxoutDense(Layer):
    """The max over ``nb_feature`` linear maps: one (D, nb_feature · out)
    kernel, reshaped and reduced."""

    def __init__(self, output_dim: int, nb_feature: int = 4,
                 use_bias: bool = True, init="glorot_uniform", name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.output_dim = int(output_dim)
        self.nb_feature = int(nb_feature)
        self.use_bias = use_bias
        self.init = get_initializer(init)

    def build(self, input_shape, gen: torch.Generator) -> None:
        n = self.nb_feature * self.output_dim
        self.kernel = nn.Parameter(self.init(gen, (input_shape[-1], n)))
        if self.use_bias:
            self.bias = nn.Parameter(zeros_init((n,)))
        self.built = True

    def apply(self, x):
        x = as_compute(x)
        z = x @ self.kernel.to(x.dtype)
        if self.use_bias:
            z = z + self.bias.to(x.dtype)
        z = z.reshape(tuple(z.shape[:-1]) + (self.nb_feature,
                                              self.output_dim))
        return z.amax(dim=-2)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class Lambda(Layer):
    """A torch function as a layer (autograd differentiates it):
    ``fn(x)``, or ``fn(*xs)`` over a list of inputs; ``output_shape_fn``
    maps the input shape (batch dim excluded) to the output's, identity
    when not given."""

    def __init__(self, fn: Callable,
                 output_shape_fn: Optional[Callable] = None, name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.fn = fn
        self.output_shape_fn = output_shape_fn

    def apply(self, x):
        if isinstance(x, (list, tuple)):
            return self.fn(*x)
        return self.fn(x)

    def compute_output_shape(self, input_shape):
        if self.output_shape_fn is not None:
            return self.output_shape_fn(input_shape)
        return input_shape


__all__ = ["Activation", "Dense", "Dropout", "ExpandDim", "Flatten",
           "GaussianDropout", "GaussianNoise", "Highway", "InputLayer",
           "Int8Kernel", "Lambda", "Masking", "MaxoutDense", "Narrow",
           "Permute", "RepeatVector", "Reshape", "Select", "SparseDense",
           "Squeeze", "dropout", "global_draw", "normal_draw"]
