"""Torch checkpoint ingestion — weights in (port of
``analytics_zoo_tpu/importers/torch_loader.py``): read a torch checkpoint
(a state_dict, or a full module on opt-in) into numpy, then assign its
tensors onto a model's parameters by the JAX tree's names, in the JAX
layout: a Linear's (out, in) weight is transposed to (in, out), a conv's
OIHW to HWIO.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_torch_state_dict(path: str,
                          allow_pickle: bool = False) -> Dict[str, np.ndarray]:
    """Read a ``.pt``/``.pth`` file → {name: numpy array}. Accepts a raw
    state_dict or a checkpoint dict holding one under
    'state_dict'/'model'/'model_state_dict'.

    Loads with ``weights_only=True`` (tensors and containers only, no
    pickle code run from the file). A full pickled ``nn.Module`` needs
    ``allow_pickle=True``, which runs the checkpoint's pickle code: only
    for files you trust."""
    import os
    import pickle

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, AttributeError):
        # weights_only refused the payload (custom classes, a full module)
        if not allow_pickle:
            raise ValueError(
                f"{path!r} is not a plain weights checkpoint. If you trust "
                "the file (it may execute code on load), pass "
                "allow_pickle=True.")
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict):
        for k in ("state_dict", "model", "model_state_dict"):
            if k in obj and isinstance(obj[k], dict):
                obj = obj[k]
                break
    if not isinstance(obj, dict):
        raise ValueError(
            f"unrecognized torch checkpoint structure: {type(obj)}")
    out = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy()
    if not out:
        raise ValueError("checkpoint holds no tensors")
    return out


def assign_torch_weights(model, state_dict: Dict[str, np.ndarray],
                         mapping: Dict[str, str],
                         transpose_linear: bool = True):
    """Assign checkpoint tensors onto a compiled model's parameters.

    ``mapping``: {parameter path as in the weight bundle ("1_dense/kernel",
    the JAX tree's path) → checkpoint key ("fc1.weight")}. A 2-d tensor
    whose transpose fits is transposed (torch's Linear is (out, in), the
    JAX layout (in, out)) unless ``transpose_linear=False``; a 4-d one
    whose OIHW → HWIO transpose fits is transposed. Values are cast to the
    parameter's dtype and written in place; the optimizer restarts from
    the new weights (as after ``load_weights``). Several calls may each
    assign part of the model."""
    est = getattr(model, "estimator", None)
    if est is None:
        raise RuntimeError("model must be compiled before weight assignment")
    named = dict(model.named_parameters())
    flat = {n.replace(".", "/"): p for n, p in named.items()}
    new = {}
    for fw_key, torch_key in mapping.items():
        if fw_key not in flat:
            raise KeyError(f"framework param {fw_key!r} not found; "
                           f"have {sorted(flat)[:8]}...")
        if torch_key not in state_dict:
            raise KeyError(f"torch key {torch_key!r} not in checkpoint")
        src = np.asarray(state_dict[torch_key])
        dst_shape = tuple(flat[fw_key].shape)
        if src.shape != dst_shape:
            if transpose_linear and src.ndim == 2 and \
                    src.T.shape == dst_shape:
                src = src.T
            elif src.ndim == 4 and \
                    np.transpose(src, (2, 3, 1, 0)).shape == dst_shape:
                src = np.transpose(src, (2, 3, 1, 0))  # OIHW → HWIO
            else:
                raise ValueError(f"{torch_key}: shape {src.shape} does not "
                                 f"fit {fw_key} {dst_shape}")
        new[fw_key] = src
    with torch.no_grad():
        for fw_key, src in new.items():
            p = flat[fw_key]
            p.copy_(torch.from_numpy(np.ascontiguousarray(src)).to(p.dtype))
    # the optimizer's moments belong to the weights before
    est.reset_optimizer()
    return model


__all__ = ["assign_torch_weights", "load_torch_state_dict"]
