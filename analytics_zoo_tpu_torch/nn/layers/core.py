"""Core layers: InputLayer, Dense, SparseDense, Select, Narrow, Activation,
Dropout and Lambda (port of ``analytics_zoo_tpu/nn/layers/core.py``).

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
from ..module import Layer, as_compute, get_initializer


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
        if w_regularizer is not None or b_regularizer is not None:
            raise NotImplementedError(
                "regularizers are not ported (ROADMAP Queue 1, item 11)")
        self.output_dim = int(output_dim)
        self.activation = get_activation(activation)
        self.use_bias = use_bias
        self.init = get_initializer(init)
        self.bias_init = get_initializer(bias_init)

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


def dropout(x: torch.Tensor, rate: float, key) -> torch.Tensor:
    """Inverted dropout with the JAX package's mask: keep where
    ``prng.bernoulli(key, 1 - rate, x.shape)``, as ``x / keep`` in x's
    dtype (``keep`` rounded to it, as JAX's weak-typed scalar is),
    zero elsewhere. The mask is drawn on x's device: the same bits on
    the card, the CPU and JAX. On a rank's block of a global batch
    (``parallel.comm.batch_shard``) whose step key is the same on every
    rank, the mask is drawn for the global batch and the block's rows
    taken, as the JAX step draws it over the global array."""
    from ...parallel.comm import current_batch_shard

    keep = 1.0 - rate
    shard = current_batch_shard()
    if shard is not None and shard.global_draws and shard.count > 1:
        b = x.shape[0]
        mask = prng.bernoulli(key, keep, (b * shard.count,) + tuple(
            x.shape[1:]), device=x.device)[shard.index * b:
                                           (shard.index + 1) * b]
    else:
        mask = prng.bernoulli(key, keep, x.shape, device=x.device)
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


__all__ = ["Activation", "Dense", "Dropout", "InputLayer", "Int8Kernel",
           "Lambda", "Narrow", "Select", "SparseDense", "dropout"]
