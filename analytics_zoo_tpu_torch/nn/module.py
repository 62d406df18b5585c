"""Precision policy, device resolution and the initializers the LM uses.

Port of the parts of ``analytics_zoo_tpu/nn/module.py`` that the serving
and training paths need: the process-wide (param, compute) dtype policy,
its scoped form ``precision_policy``, ``as_compute``, ``cast_params``, and
the ``glorot_uniform`` / normal·0.02 / zeros initializers that
``TransformerLM.build`` draws from. Draws come from an explicit
``torch.Generator`` on the CPU, so a seed gives the same weights whatever
device they end up on (they do not reproduce JAX's draws: parity tests load
the JAX weights through :mod:`analytics_zoo_tpu_torch.bridge`).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence, Tuple, Union

import torch

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


def embedding_normal(gen: torch.Generator,
                     shape: Sequence[int]) -> torch.Tensor:
    """normal · 0.02 — the token and position tables."""
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32) * 0.02
    return w.to(param_dtype())


def zeros_init(shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=param_dtype())


def ones_init(shape: Sequence[int]) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=param_dtype())


__all__ = ["as_compute", "cast_params", "compute_dtype", "embedding_normal",
           "glorot_uniform", "ones_init", "param_dtype", "precision_policy",
           "resolve_device", "set_policy", "zeros_init"]
