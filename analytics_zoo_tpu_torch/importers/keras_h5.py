"""Keras H5 weight ingestion (port of
``analytics_zoo_tpu/importers/keras_h5.py``): Keras-saved weights as a
donor dict, assigned onto a model the framework builds itself. ``h5py`` is
imported only when a file is read.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def load_keras_h5_weights(path: str) -> Dict[str, np.ndarray]:
    """Read every weight array from a Keras ``.h5``/``.keras`` weights file into
    a flat {"layer/weight_name": array} dict (works for both
    ``save_weights`` files and full-model H5 files with a model_weights group).
    """
    import zipfile

    import h5py

    if zipfile.is_zipfile(path):
        raise ValueError(
            f"{path!r} is a Keras 3 native .keras archive (zip), not HDF5. "
            "Re-save with model.save_weights('w.h5') / save_format='h5', or "
            "export to ONNX and use Net.load_onnx.")
    out: Dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            arr = np.asarray(obj)
            if arr.dtype.kind in "fiu" and arr.ndim > 0:
                out[name] = arr  # names are relative to root (group-aware)

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        root.visititems(visit)
    if not out:
        raise ValueError(f"no weight arrays found in {path!r}")
    return out


def assign_keras_weights(model, weights: Dict[str, np.ndarray],
                         mapping: Dict[str, str]):
    """Assign H5 arrays onto a compiled model's params — same contract as
    :func:`analytics_zoo_tpu_torch.importers.torch_loader.assign_torch_weights`
    (framework slot path → h5 key), including dense-kernel transpose when the
    shapes fit only that way."""
    from .torch_loader import assign_torch_weights

    return assign_torch_weights(model, weights, mapping)
