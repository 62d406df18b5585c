"""Image models (port of ``analytics_zoo_tpu/models/image``):
classification backbones and SSD object detection."""

from .backbones import BACKBONES, build_backbone
from .classification import ImageClassifier, ImagenetConfig
from .objectdetection import (MeanAveragePrecision, ObjectDetector, SSDModel,
                              decode_predictions, generate_anchors,
                              multibox_loss, nms)

__all__ = ["BACKBONES", "build_backbone", "ImageClassifier", "ImagenetConfig",
           "MeanAveragePrecision", "ObjectDetector", "SSDModel",
           "decode_predictions", "generate_anchors", "multibox_loss", "nms"]
