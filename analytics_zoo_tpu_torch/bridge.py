"""Weight bridge between the JAX package's param trees and the port's
modules.

The port names every parameter after its path in the JAX tree
(``block0.attn.qkv_kernel`` is ``params["block0"]["attn"]["qkv_kernel"]``)
and keeps the JAX (in, out) layout, so the bridge is a lossless rename:

    tree = jax.tree_util.tree_map(np.asarray, params)   # in the JAX process
    model.load_state_dict(params_from_jax(tree, device=model.device))

A graph model's params and state trees (BatchNormalization's
``moving_mean``/``moving_var`` live in the state tree in JAX and are
buffers in the port) share their slot keys (``12_convolution2d``,
``13_batchnormalization``); :func:`state_dict_from_jax` merges the two:

    model.load_state_dict(state_dict_from_jax(params, state))

bf16 leaves (numpy arrays of ``ml_dtypes.bfloat16``) cross as their raw
16-bit patterns, so no value is rounded either way.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.astype(np.int16, copy=True)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(tree: Mapping[str, Any], *, device="cpu"
                    ) -> Dict[str, torch.Tensor]:
    """Flatten a nested dict of numpy arrays (a JAX param tree after
    ``tree_map(np.asarray, ...)``) into a state dict of tensors on
    ``device``, keyed by the dotted tree path, dtypes unchanged."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        else:
            out[prefix[:-1]] = _to_tensor(node).to(device)

    walk(tree, "")
    return out


def state_dict_from_jax(params: Mapping[str, Any],
                        state: Mapping[str, Any] = None, *, device="cpu"
                        ) -> Dict[str, torch.Tensor]:
    """One state dict from a JAX model's params tree and its state tree
    (numpy leaves, as in :func:`params_from_jax`); a key in both raises."""
    out = params_from_jax(params, device=device)
    for k, v in params_from_jax(state or {}, device=device).items():
        if k in out:
            raise ValueError(f"{k} is in both the params and the state tree")
        out[k] = v
    return out


def params_to_numpy(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse: the module's parameters as a nested dict of numpy
    arrays in the JAX tree's shape. bf16 parameters come back as
    ``ml_dtypes.bfloat16`` arrays (imported only then)."""
    tree: Dict[str, Any] = {}
    for name, t in model.state_dict().items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            arr = t.view(torch.int16).numpy().view(np.uint16).view(
                ml_dtypes.bfloat16)
        else:
            arr = t.numpy().copy()
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


__all__ = ["params_from_jax", "params_to_numpy", "state_dict_from_jax"]
