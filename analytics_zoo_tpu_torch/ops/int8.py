"""Int8 inference arithmetic (port of ``analytics_zoo_tpu/ops/int8.py``).

Scheme, as in the JAX package: weights are packed once, symmetric
per-output-channel int8 (``{"q": int8, "scale": f32}``); activations are
quantized dynamically, symmetric per row (matmul) or per pixel (conv); the
products accumulate in int32 and are rescaled in f32.

:func:`int8_matmul` and :func:`int8_conv2d` route each shape as the TPU
does (``ops/int8_fused.py`` has both routes' arithmetic): a matmul whose N
and K tile at the TPU's floors, and a conv at stride 1, take the fused
route; every other shape takes the lax route. Both routes run on the K5 and
K6 kernels on the card and on their plain versions on the CPU. The output
is in x's dtype (what the layers ask for with ``out_dtype=x.dtype``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .int8_fused import (conv_pads, int8_conv2d_fused, int8_matmul_fused,
                         quantize_groups, resolve_blocks)


def quantize_weight(w: np.ndarray, axis: int = -1) -> Dict[str, np.ndarray]:
    """Symmetric per-channel int8 packing along ``axis`` (the output-channel
    axis: last for (in, out) matmul kernels and HWIO conv kernels), in
    numpy, bit for bit the JAX package's. Returns ``{"q": int8, "scale":
    f32}`` with the scale's reduced axes kept."""
    w = np.asarray(w, np.float32)
    axis = axis % w.ndim
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = np.maximum(amax, 1e-12) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale.astype(np.float32)}


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "scale" in leaf


def dequantize(packed) -> torch.Tensor:
    return torch.as_tensor(packed["q"]).float() * torch.as_tensor(
        packed["scale"])


def _quant_activations(x: torch.Tensor, axes=(-1,), rule: str = "lax"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric quantization with one abs-max scale per slice over
    the last axis (the only reduction the routes use): ``(int8 codes,
    f32 scales)``. The lax route's rule by default."""
    if tuple(axes) not in ((-1,), (x.dim() - 1,)):
        raise NotImplementedError("only the last axis is reduced")
    q, scale = quantize_groups(x.float(), rule)
    return q.to(torch.int8), scale


def int8_matmul_unfused(x: torch.Tensor, packed) -> torch.Tensor:
    """The lax route: one scale per whole row, ``max(amax, 1e-12) / 127``
    (K5 with one group of K columns)."""
    return int8_matmul_fused(x, packed, block_k=packed["q"].shape[0],
                             rule="lax")


def int8_matmul(x: torch.Tensor, packed: Dict[str, Any]) -> torch.Tensor:
    """``x @ W`` over a ``quantize_weight``-packed (in, out) kernel;
    returns ``x.shape[:-1] + (out,)`` in x's dtype. The fused route (scales
    per ``block_k`` segment) where the TPU's blocks tile, else the lax
    route."""
    k, n = packed["q"].shape
    blocks = resolve_blocks(math.prod(x.shape[:-1]), n, k)
    if blocks is None:
        return int8_matmul_unfused(x, packed)
    return int8_matmul_fused(x, packed, block_k=blocks[2], rule="fused")


def int8_conv2d_unfused(x: torch.Tensor, packed, *, strides,
                        padding) -> torch.Tensor:
    """The lax route: per-pixel scales, ``max(amax, 1e-12) / 127``, taps
    folded in order at any stride."""
    kh, kw = packed["q"].shape[:2]
    pads = conv_pads(padding, x.shape[1:3], (kh, kw), strides)
    return int8_conv2d_fused(x, packed, stride=strides, pads=pads,
                             rule="lax")


def int8_conv2d(x: torch.Tensor, packed: Dict[str, Any], *, strides,
                padding) -> torch.Tensor:
    """NHWC x HWIO conv over a packed kernel, per-output-channel weight
    scales times per-pixel activation scales, in x's dtype. The fused route
    at stride (1, 1), else the lax route."""
    strides = tuple(int(s) for s in strides)
    if strides != (1, 1):
        return int8_conv2d_unfused(x, packed, strides=strides,
                                   padding=padding)
    kh, kw = packed["q"].shape[:2]
    pads = conv_pads(padding, x.shape[1:3], (kh, kw), strides)
    return int8_conv2d_fused(x, packed, stride=strides, pads=pads,
                             rule="fused")


__all__ = ["dequantize", "int8_conv2d", "int8_conv2d_unfused", "int8_matmul",
           "int8_matmul_unfused", "is_quantized", "quantize_weight"]
