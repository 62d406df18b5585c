"""Unified ``Net.load*`` entry (port of ``analytics_zoo_tpu/importers/
net.py``): one front door dispatching on artifact kind. The executable
kinds (ONNX, TF graphs, Caffe, zoo bundles) land on ``device``: CUDA
unless the caller names another (raises with no CUDA and no device)."""

from __future__ import annotations

import os
from typing import Dict, Optional


class Net:
    @staticmethod
    def load(path: str, kind: Optional[str] = None, *, device=None):
        """Auto-detecting loader:
        * ``.onnx`` → :func:`load_onnx` (executable model)
        * ``.pb`` → frozen TF GraphDef → executable TFNet
        * directory with ``saved_model.pb`` → TF SavedModel → executable TFNet
        * ``.pt``/``.pth`` → torch state_dict (weight donor dict)
        * ``.h5``/``.keras`` → Keras weight-donor dict
        * directory with ``config.json`` → zoo model bundle
        * ``kind='tf'`` → TF checkpoint-bundle donor dict (no tensorflow
          needed — built-in bundle codec)
        """
        kind = kind or Net._detect(path)
        if kind == "onnx":
            from .onnx_loader import load_onnx

            return load_onnx(path, device=device)
        if kind == "tf_frozen":
            from .tf_net import from_frozen_graph

            return from_frozen_graph(path, device=device)
        if kind == "tf_saved_model":
            from .tf_net import from_saved_model

            return from_saved_model(path, device=device)
        if kind == "torch":
            from .torch_loader import load_torch_state_dict

            return load_torch_state_dict(path)
        if kind == "keras":
            from .keras_h5 import load_keras_h5_weights

            return load_keras_h5_weights(path)
        if kind == "tf":
            return Net.load_tf(path)
        if kind == "zoo":
            from ..models.common.zoo_model import load_model_bundle

            model, _ = load_model_bundle(path, device=device)
            return model
        raise ValueError(
            f"cannot determine artifact kind for {path!r}; pass kind='onnx'|"
            "'tf_frozen'|'tf_saved_model'|'torch'|'keras'|'tf'|'zoo'")

    @staticmethod
    def _detect(path: str) -> Optional[str]:
        low = path.lower()
        if low.endswith(".onnx"):
            return "onnx"
        if low.endswith((".pt", ".pth")):
            return "torch"
        if low.endswith((".h5", ".hdf5", ".keras")):
            return "keras"
        if low.endswith(".pb"):
            return "tf_frozen"
        if os.path.isdir(path) and os.path.exists(
                os.path.join(path, "saved_model.pb")):
            return "tf_saved_model"
        if os.path.isdir(path) and os.path.exists(
                os.path.join(path, "config.json")):
            return "zoo"
        return None

    # explicit entries (NetUtils.scala Net.loadBigDL/loadTF/loadTorch parity)
    @staticmethod
    def load_onnx(path: str, *, device=None):
        return Net.load(path, kind="onnx", device=device)

    @staticmethod
    def load_torch(path: str) -> Dict:
        return Net.load(path, kind="torch")

    @staticmethod
    def load_zoo(path: str, *, device=None):
        return Net.load(path, kind="zoo", device=device)

    @staticmethod
    def load_keras(path: str) -> Dict:
        """Keras H5 weights file → flat weight-donor dict (Net.loadKeras
        capability; pair with assign_keras_weights)."""
        from .keras_h5 import load_keras_h5_weights

        return load_keras_h5_weights(path)

    @staticmethod
    def load_tf(path: str) -> Dict:
        """TF checkpoint prefix → {var_name: array} donor dict, read by the
        built-in bundle codec (``tf_proto.read_checkpoint_bundle``) — no
        tensorflow dependency. ``path`` is the checkpoint prefix (the part
        before ``.index``); falls back to the tensorflow reader only for
        pre-bundle (V1) checkpoints if tensorflow happens to be installed."""
        import numpy as np

        if os.path.exists(path + ".index"):
            from .tf_proto import read_checkpoint_bundle

            return read_checkpoint_bundle(path)
        try:
            import tensorflow as tf  # pragma: no cover - legacy V1 path
        except ImportError as e:
            raise FileNotFoundError(
                f"{path}.index not found — expected a TF2 checkpoint bundle "
                "prefix (V1 checkpoints need the tensorflow package)") from e
        reader = tf.train.load_checkpoint(path)  # pragma: no cover
        out = {}
        for name in reader.get_variable_to_shape_map():  # pragma: no cover
            arr = np.asarray(reader.get_tensor(name))
            if arr.dtype.kind in "fiu":
                out[name] = arr
        return out  # pragma: no cover

    @staticmethod
    def load_tf_graph(path: str, inputs=None, outputs=None, *, device=None):
        """Frozen GraphDef ``.pb`` → executable TFNet."""
        from .tf_net import from_frozen_graph

        return from_frozen_graph(path, inputs, outputs, device=device)

    @staticmethod
    def load_tf_saved_model(path: str, signature: str = "serving_default",
                            inputs=None, outputs=None, *, device=None):
        """SavedModel dir → executable TFNet."""
        from .tf_net import from_saved_model

        return from_saved_model(path, signature, inputs, outputs,
                                device=device)

    @staticmethod
    def load_caffe(def_path: str, model_path: Optional[str] = None, *,
                   device=None):
        """prototxt + caffemodel → executable/trainable CaffeModel
        (built-in text-proto and NetParameter codecs — no caffe/protobuf
        dependency)."""
        from .caffe import load_caffe

        return load_caffe(def_path, model_path, device=device)
