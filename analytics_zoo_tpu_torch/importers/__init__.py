"""Model importers (port of ``analytics_zoo_tpu/importers``): ONNX, TF
frozen graphs and SavedModels, Caffe nets executed on the port, torch and
Keras checkpoints and TF checkpoint bundles as weight donors, and the
unified ``Net.load``. No ``onnx``, ``tensorflow``, ``caffe`` or
``protobuf`` package is needed: the formats are decoded by the built-in
wire codecs (``onnx_proto``, ``tf_proto``, ``caffe``)."""

from .caffe import CaffeModel, load_caffe
from .net import Net
from .onnx_loader import OnnxModel, load_onnx
from .tf_net import TFNet, from_frozen_graph, from_saved_model
from .torch_loader import assign_torch_weights, load_torch_state_dict

__all__ = ["CaffeModel", "Net", "OnnxModel", "TFNet", "from_frozen_graph",
           "from_saved_model", "load_caffe", "load_onnx",
           "load_torch_state_dict", "assign_torch_weights"]
