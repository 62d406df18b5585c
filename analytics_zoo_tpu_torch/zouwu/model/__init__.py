from .forecast import (Forecaster, LSTMForecaster, MTNetForecaster,
                       Seq2SeqForecaster, TCMFForecaster)
from .anomaly import ThresholdEstimator, ThresholdDetector, AEDetector

__all__ = ["Forecaster", "LSTMForecaster", "MTNetForecaster",
           "Seq2SeqForecaster", "TCMFForecaster", "ThresholdEstimator",
           "ThresholdDetector", "AEDetector"]
