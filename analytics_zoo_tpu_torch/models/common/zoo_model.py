"""Model persistence (port of ``models/common/zoo_model.py``): weight
bundles in the JAX package's on-disk format, so a bundle written by either
package loads in the other.

    <path>/
      config.json     # {"class": model class name, "config": constructor kwargs}
      weights.npz     # every leaf keyed by its tree path
      manifest.json   # the sorted key list

A key is the leaf's path in the JAX ``{"params": ..., "state": ...}``
tree joined by ``/``: the port's parameter ``0_fusedpairembedding.
embeddings`` is ``params/0_fusedpairembedding/embeddings``, and a
persistent buffer (BatchNormalization's moving statistics, a frozen
table) is under ``state/``. Loading fails loudly on any missing or
unexpected key and on any shape that differs; values are cast to the
module's dtypes. bf16 leaves cross as their 16-bit patterns (stored as
2-byte voids, as numpy writes JAX's bfloat16 arrays).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        return cls
    return deco


def _leaves(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``{bundle key: tensor}`` of the module's parameters and persistent
    buffers."""
    params = {n for n, _ in module.named_parameters()}
    return {("params/" if n in params else "state/") + n.replace(".", "/"): t
            for n, t in module.state_dict().items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")).copy()
    return t.numpy().copy()


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def save_weights(path: str, module: torch.nn.Module) -> None:
    """Write ``module``'s parameters and persistent buffers as
    ``weights.npz`` + ``manifest.json`` under ``path``."""
    os.makedirs(path, exist_ok=True)
    flat = {k: _to_numpy(t) for k, t in _leaves(module).items()}
    if not flat:
        raise ValueError("refusing to save an empty weight tree")
    np.savez(os.path.join(path, "weights.npz"), **flat)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(sorted(flat), f)


def load_weights(path: str, module: torch.nn.Module) -> torch.nn.Module:
    """Load the bundle at ``path`` into ``module`` in place (each value
    cast to the module's dtype, on its device); any key missing or
    unexpected, or any shape that differs, raises ``ValueError``."""
    expected = _leaves(module)
    with np.load(os.path.join(path, "weights.npz")) as data:
        saved = {k: data[k] for k in data.files}
    if set(expected) != set(saved):
        missing = sorted(set(expected) - set(saved))
        extra = sorted(set(saved) - set(expected))
        raise ValueError(
            f"weight bundle mismatch at {path}: {len(missing)} missing "
            f"(e.g. {missing[:5]}), {len(extra)} unexpected (e.g. "
            f"{extra[:5]})")
    with torch.no_grad():
        for key, t in expected.items():
            arr = saved[key]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{key}: saved {tuple(arr.shape)} != "
                                 f"expected {tuple(t.shape)}")
            t.copy_(_to_tensor(arr))
    return module


def save_model_bundle(path: str, model, config: Optional[Dict] = None
                      ) -> None:
    """Save a model's weights and the config that rebuilds it (its
    ``constructor_config()`` when it has one)."""
    if config is None and hasattr(model, "constructor_config"):
        config = model.constructor_config()
    save_weights(path, model)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"class": type(model).__name__, "config": config or {}}, f)


def load_model_bundle(path: str, model=None, *, device=None):
    """Load a bundle. With ``model``, into it; otherwise rebuild the
    architecture from :data:`MODEL_REGISTRY` on ``device`` (CUDA unless
    given) and load into that. Returns ``(model, config)``."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    if model is None:
        cls = MODEL_REGISTRY.get(cfg["class"])
        if cls is None:
            raise ValueError(
                f"unknown model class {cfg['class']!r}; pass model= "
                f"explicitly (registered: {sorted(MODEL_REGISTRY)})")
        model = cls(**cfg["config"], device=device)
    model.load_weights(path)
    return model, cfg


__all__ = ["MODEL_REGISTRY", "load_model_bundle", "load_weights",
           "register_model", "save_model_bundle", "save_weights"]
