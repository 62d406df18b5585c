"""Model persistence and the ranking mixin (port of
``analytics_zoo_tpu.models.common``)."""

from .ranker import Ranker
from .zoo_model import (MODEL_REGISTRY, load_model_bundle, load_weights,
                        register_model, save_model_bundle, save_weights)

__all__ = ["MODEL_REGISTRY", "Ranker", "load_model_bundle", "load_weights",
           "register_model", "save_model_bundle", "save_weights"]
