"""Zouwu — the time-series toolkit (port of ``analytics_zoo_tpu/zouwu/``):
AutoML-driven ``AutoTSTrainer`` → ``TSPipeline``; standalone forecasters
(``LSTMForecaster``, ``MTNetForecaster``, ``Seq2SeqForecaster``,
``TCMFForecaster``) and anomaly detectors."""

from .autots.forecast import AutoTSTrainer, TSPipeline
from .model.forecast import (Forecaster, LSTMForecaster, MTNetForecaster,
                             Seq2SeqForecaster, TCMFForecaster)
from .model.anomaly import ThresholdEstimator, ThresholdDetector, AEDetector

__all__ = ["AutoTSTrainer", "TSPipeline", "Forecaster", "LSTMForecaster",
           "MTNetForecaster", "Seq2SeqForecaster", "TCMFForecaster",
           "ThresholdEstimator", "ThresholdDetector", "AEDetector"]
