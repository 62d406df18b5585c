"""Precision policy, device resolution, initializers and the ``Layer`` base.

Port of ``analytics_zoo_tpu/nn/module.py``: the process-wide (param,
compute) dtype policy, its scoped form ``precision_policy``,
``as_compute``, ``cast_params``, every initializer of the JAX table
(glorot uniform and normal, he and lecun normal, normal·0.01, uniform,
zeros, ones; and the normal·0.02 of ``TransformerLM.build``), and
:class:`Layer`, the base of the Keras-style layers, with its
``regularization`` term. Draws come from an explicit ``torch.Generator``
on the CPU, so a seed gives the same weights whatever device they end up
on (they do not reproduce JAX's draws, only their fans and spread: parity
tests load the JAX weights through :mod:`analytics_zoo_tpu_torch.bridge`).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

_POLICY_LOCK = threading.Lock()
_POLICY = {"param_dtype": torch.float32, "compute_dtype": torch.float32}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; known: "
                         f"{sorted(_DTYPES)}") from None


def set_policy(param_dtype=None, compute_dtype=None) -> None:
    with _POLICY_LOCK:
        if param_dtype is not None:
            _POLICY["param_dtype"] = _as_dtype(param_dtype)
        if compute_dtype is not None:
            _POLICY["compute_dtype"] = _as_dtype(compute_dtype)


def param_dtype() -> torch.dtype:
    return _POLICY["param_dtype"]


def compute_dtype() -> torch.dtype:
    return _POLICY["compute_dtype"]


@contextlib.contextmanager
def precision_policy(param_dtype=None, compute_dtype=None):
    """Scoped :func:`set_policy`: the override holds for the dynamic
    extent of the block and the previous policy is restored on exit. The
    training engine wraps each step in it, so ``TrainConfig.compute_dtype``
    reaches exactly the forward passes it owns."""
    with _POLICY_LOCK:
        prev = dict(_POLICY)
    set_policy(param_dtype, compute_dtype)
    try:
        yield
    finally:
        with _POLICY_LOCK:
            _POLICY.clear()
            _POLICY.update(prev)


def cast_params(module: torch.nn.Module, dtype) -> torch.nn.Module:
    """Cast every floating parameter of ``module`` to ``dtype`` in place
    (the JAX ``cast_params`` over a param tree); integer buffers keep
    their dtype. Returns the module."""
    dt = _as_dtype(dtype)
    with torch.no_grad():
        for p in module.parameters():
            if p.is_floating_point() and p.dtype != dt:
                p.data = p.data.to(dt)
    return module


def as_compute(x: torch.Tensor) -> torch.Tensor:
    """Cast floating activations to the compute dtype (mixed-precision
    entry); integer tensors pass through."""
    dt = compute_dtype()
    if x.is_floating_point() and x.dtype != dt:
        return x.to(dt)
    return x


def split_rng(rng, n: int):
    """``n`` keys from ``rng`` (``jax.random.split``), or ``n`` Nones when
    there is no key: how a container hands each layer its key."""
    if rng is None:
        return [None] * n
    from ..common import prng

    return prng.split(rng, n)


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The port's entry points run on the card unless the caller names
    another device. With no device given and no CUDA, raise: never drop to
    the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run "
            "the port's plain PyTorch path on the CPU")
    return torch.device("cuda")


# ---------------------------------------------------------------- initializers

def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def glorot_uniform(gen: torch.Generator,
                   shape: Sequence[int]) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * limit).to(param_dtype())


def _normal(gen: torch.Generator, shape: Sequence[int],
            std: float) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32) * std
    return w.to(param_dtype())


def glorot_normal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """normal · sqrt(2 / (fan_in + fan_out))."""
    fan_in, fan_out = _fans(shape)
    return _normal(gen, shape, math.sqrt(2.0 / (fan_in + fan_out)))


def he_normal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """normal · sqrt(2 / fan_in)."""
    return _normal(gen, shape, math.sqrt(2.0 / _fans(shape)[0]))


def lecun_normal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """normal · sqrt(1 / fan_in)."""
    return _normal(gen, shape, math.sqrt(1.0 / _fans(shape)[0]))


def embedding_normal(gen: torch.Generator,
                     shape: Sequence[int]) -> torch.Tensor:
    """normal · 0.02 — the token and position tables."""
    return _normal(gen, shape, 0.02)


def normal_init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """normal · 0.01 — the JAX package's ``"normal"`` (NeuralCF's
    tables)."""
    return _normal(gen, shape, 0.01)


def uniform_init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """U(-0.05, 0.05) — the JAX package's ``"uniform"`` (``Embedding``'s
    default)."""
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return (u * 0.1 - 0.05).to(param_dtype())


def zeros_init(shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=param_dtype())


def ones_init(shape: Sequence[int]) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=param_dtype())


INITIALIZERS: Dict[str, Callable] = {
    "glorot_uniform": glorot_uniform, "xavier": glorot_uniform,
    "glorot_normal": glorot_normal, "he_normal": he_normal,
    "lecun_normal": lecun_normal,
    "normal": normal_init, "gaussian": normal_init,
    "uniform": uniform_init,
    "zero": lambda gen, shape: zeros_init(shape),
    "zeros": lambda gen, shape: zeros_init(shape),
    "one": lambda gen, shape: ones_init(shape),
    "ones": lambda gen, shape: ones_init(shape)}


def get_initializer(init: Union[str, Callable]) -> Callable:
    """``init(gen, shape) -> tensor``: the initializer a layer names, or
    a callable as it is."""
    if callable(init):
        return init
    try:
        return INITIALIZERS[init]
    except KeyError:
        raise ValueError(f"unknown initializer {init!r}; known: "
                         f"{sorted(INITIALIZERS)}") from None


# ---------------------------------------------------------------- layers

_NAME_COUNTS: Dict[str, "itertools.count"] = {}
_NAME_LOCK = threading.Lock()


def _auto_name(cls_name: str) -> str:
    with _NAME_LOCK:
        n = next(_NAME_COUNTS.setdefault(cls_name, itertools.count()))
    return f"{cls_name.lower()}_{n}"


class Layer(nn.Module):
    """Base of the Keras-style layers (port of the JAX ``Layer``).

    A layer is made from its Keras arguments alone; ``build(input_shape,
    gen)`` (shape without the batch dim) creates its parameters on the CPU
    from the generator, once, when a graph or a Sequential that holds it is
    built. ``apply(x)`` is the forward (the JAX method name; it shadows
    ``nn.Module.apply(fn)``), so ``layer(tensor)`` runs it, while
    ``layer(node)`` on a graph :class:`~..graph.Node` connects the layer
    into a functional graph, as in the JAX package.

    A layer that draws randomness in training (``Dropout``) sets
    ``takes_rng`` and takes ``apply(x, rng=key)``; the containers split
    their key among their layers as the JAX package's do, and hand each
    such layer its share. Training mode is the module's ``training`` flag
    (``train()``/``eval()``), the JAX ``apply(training=...)``."""

    #: ``apply`` takes ``rng=`` (a :mod:`~..common.prng` key)
    takes_rng = False

    def __init__(self, name: Optional[str] = None,
                 input_shape: Optional[Sequence[int]] = None):
        super().__init__()
        self.name = name or _auto_name(type(self).__name__)
        self.input_shape_hint = (tuple(input_shape) if input_shape is not None
                                 else None)
        self.built = False

    def build(self, input_shape, gen: torch.Generator) -> None:
        """Create the parameters for ``input_shape`` (batch dim excluded).
        Layers without parameters keep this default."""

    def apply(self, x):
        raise NotImplementedError

    def forward(self, x, **kw):
        return self.apply(x, **kw)

    def compute_output_shape(self, input_shape):
        return input_shape

    def regularization(self):
        """This layer's term of the training loss: ``w_regularizer`` of
        its ``kernel`` plus ``b_regularizer`` of its ``bias`` (0.0 without
        them), summed into the loss by the Estimator."""
        total = 0.0
        w_reg = getattr(self, "w_regularizer", None)
        b_reg = getattr(self, "b_regularizer", None)
        if w_reg is not None and "kernel" in self._parameters:
            total = total + w_reg(self.kernel)
        if b_reg is not None and "bias" in self._parameters:
            total = total + b_reg(self.bias)
        return total

    def __call__(self, x, *args, **kwargs):
        from .graph import Node, apply_layer

        if isinstance(x, Node) or (isinstance(x, (list, tuple)) and x and
                                   all(isinstance(n, Node) for n in x)):
            return apply_layer(self, x)
        return super().__call__(x, *args, **kwargs)


def draws_rng(layer) -> bool:
    """Whether ``layer`` uses a key: a ``takes_rng`` layer, or a
    container holding one (a container without one skips the split, whose
    keys nothing would read)."""
    if not getattr(layer, "takes_rng", False):
        return False
    inner = getattr(layer, "layers", None)
    return inner is None or any(draws_rng(l) for l in inner)


def call_layer(layer, x, rng):
    """``layer(x)``, with ``rng=`` for a layer that takes a key."""
    if getattr(layer, "takes_rng", False):
        return layer(x, rng=rng)
    return layer(x)


__all__ = ["INITIALIZERS", "Layer", "as_compute", "call_layer",
           "cast_params", "compute_dtype", "draws_rng", "embedding_normal",
           "get_initializer", "glorot_normal", "glorot_uniform", "he_normal",
           "lecun_normal", "normal_init", "ones_init", "param_dtype",
           "precision_policy", "resolve_device", "set_policy", "split_rng",
           "uniform_init", "zeros_init"]
