"""AutoML — hyperparameter search over time-series (and generic) models
(port of ``analytics_zoo_tpu/automl/``).

``TimeSequencePredictor.fit`` drives a :class:`SearchEngine` over trial
configs drawn from a ``Recipe``'s space, each trial training a
``TimeSequenceModel`` on features from ``TimeSequenceFeatureTransformer``,
and returns a ``TimeSequencePipeline``. Trials are plain Python objects on
an in-process, deterministic engine (no Ray); median stopping replaces
Ray Tune's schedulers.
"""

from .space import Choice, Uniform, LogUniform, RandInt, QUniform, GridSearch, sample_config
from .metrics import Evaluator
from .feature import TimeSequenceFeatureTransformer
from .models import VanillaLSTM, TSSeq2Seq, MTNet, TimeSequenceModel
from .search import SearchEngine, Trial, TrialResult
from .tpe import tpe_suggest
from .recipe import (Recipe, SmokeRecipe, LSTMRandomGridRecipe, MTNetSmokeRecipe,
                     MTNetRandomGridRecipe, Seq2SeqRandomRecipe, RandomRecipe)
from .pipeline import TimeSequencePipeline, load_ts_pipeline
from .predictor import TimeSequencePredictor

__all__ = [
    "Choice", "Uniform", "LogUniform", "RandInt", "QUniform", "GridSearch",
    "sample_config", "Evaluator", "TimeSequenceFeatureTransformer",
    "VanillaLSTM", "TSSeq2Seq", "MTNet", "TimeSequenceModel",
    "SearchEngine", "Trial", "TrialResult", "tpe_suggest",
    "Recipe", "SmokeRecipe", "LSTMRandomGridRecipe", "MTNetSmokeRecipe",
    "MTNetRandomGridRecipe", "Seq2SeqRandomRecipe", "RandomRecipe",
    "TimeSequencePipeline", "load_ts_pipeline", "TimeSequencePredictor",
]
