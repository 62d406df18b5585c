"""Recommendation models (port of ``analytics_zoo_tpu.models.recommendation``):
``NeuralCF``, ``ImplicitNCF`` and the ``Recommender`` base. Not ported
yet: ``WideAndDeep``, ``SessionRecommender`` and the feature helpers of
``features.py`` (ROADMAP Queue 1)."""

from .neuralcf import ImplicitNCF, NeuralCF, implicit_bce_loss
from .recommender import Recommender, UserItemPrediction

__all__ = ["ImplicitNCF", "NeuralCF", "Recommender", "UserItemPrediction",
           "implicit_bce_loss"]
