"""Recommendation models (port of ``analytics_zoo_tpu.models.recommendation``):
``NeuralCF``, ``ImplicitNCF``, ``WideAndDeep``, ``SessionRecommender``,
the ``Recommender`` base and the feature helpers of ``features.py``."""

from .features import (ColumnFeatureInfo, categorical_from_vocab_list,
                       get_boundaries, get_deep_tensors, get_negative_samples,
                       get_wide_tensor, hash_bucket, row_to_sample,
                       rows_to_batch)
from .neuralcf import ImplicitNCF, NeuralCF, implicit_bce_loss
from .recommender import Recommender, UserItemPrediction
from .session_recommender import SessionRecommender
from .wide_and_deep import WideAndDeep

__all__ = ["ColumnFeatureInfo", "ImplicitNCF", "NeuralCF", "Recommender",
           "SessionRecommender", "UserItemPrediction", "WideAndDeep",
           "categorical_from_vocab_list", "get_boundaries",
           "get_deep_tensors", "get_negative_samples", "get_wide_tensor",
           "hash_bucket", "implicit_bce_loss", "row_to_sample",
           "rows_to_batch"]
