"""AnomalyDetector: a stacked-LSTM forecaster whose largest forecast
errors are the anomalies (port of
``models/anomalydetection/anomaly_detector.py``), with the ``unroll``,
``standard_scale``, ``detect_anomalies`` and ``train_test_split`` helpers
(host numpy: unrolling a series is a stride trick).

The layers are the JAX model's, in its order (``InputLayer``, LSTMs with
``Dropout`` after each but the first, ``Dense(1)``), so the slot keys are
the JAX tree's, a JAX model's params load through
``bridge.params_from_jax`` and a bundle loads in either package.
``device``: CUDA unless given; ``seed`` draws the port's own initial
weights.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ...nn import layers as L
from ...nn.topology import Sequential
from ..common.zoo_model import register_model


@register_model("AnomalyDetector")
class AnomalyDetector(Sequential):
    """``feature_shape`` (unroll_length, feature_size), ``hidden_layers``
    (the LSTM widths) and ``dropouts`` (one rate after each LSTM)."""

    def __init__(self, feature_shape: Sequence[int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2), *,
                 device=None, seed: int = 0):
        if len(hidden_layers) != len(dropouts):
            raise ValueError("sizes of dropouts and hidden_layers should be "
                             "equal")
        super().__init__(name="anomaly_detector", device=device, seed=seed)
        self.feature_shape = tuple(int(s) for s in feature_shape)
        self.hidden_layers = [int(u) for u in hidden_layers]
        self.dropouts = [float(d) for d in dropouts]

        self.add(L.InputLayer(self.feature_shape))
        self.add(L.LSTM(self.hidden_layers[0], return_sequences=True,
                        input_shape=self.feature_shape))
        for h, d in zip(self.hidden_layers[1:-1], self.dropouts[1:-1]):
            self.add(L.LSTM(h, return_sequences=True))
            self.add(L.Dropout(d))
        self.add(L.LSTM(self.hidden_layers[-1], return_sequences=False))
        self.add(L.Dropout(self.dropouts[-1]))
        self.add(L.Dense(1))
        self.eval()

    def constructor_config(self) -> dict:
        return dict(feature_shape=list(self.feature_shape),
                    hidden_layers=self.hidden_layers, dropouts=self.dropouts)

    def save_model(self, path: str):
        from ..common.zoo_model import save_model_bundle

        save_model_bundle(path, self, config=self.constructor_config())

    @classmethod
    def load_model(cls, path: str, *, device=None) -> "AnomalyDetector":
        from ..common.zoo_model import load_model_bundle

        model, _ = load_model_bundle(path, device=device)
        return model

    @staticmethod
    def unroll(data, unroll_length: int, predict_step: int = 1):
        return unroll(data, unroll_length, predict_step)

    @staticmethod
    def detect_anomalies(y_truth, y_predict, anomaly_size: int):
        return detect_anomalies(y_truth, y_predict, anomaly_size)

    @staticmethod
    def standard_scale(data: np.ndarray) -> np.ndarray:
        return standard_scale(data)

    @staticmethod
    def train_test_split(x: np.ndarray, y: np.ndarray, test_size: int):
        """Chronological split: the last ``test_size`` rows are the test
        set."""
        cut = len(x) - int(test_size)
        return (x[:cut], y[:cut]), (x[cut:], y[cut:])


def unroll(data: np.ndarray, unroll_length: int,
           predict_step: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding-window unroll of a series into ``x: (N, unroll_length, F)``
    and ``y: (N,)``, the first feature column ``predict_step`` past each
    window (data 1..6, length 2, step 1: x [[1,2],[2,3],...], y
    [3,4,...])."""
    data = np.asarray(data, dtype="float32")
    if data.ndim == 1:
        data = data[:, None]
    n = len(data) - unroll_length - predict_step + 1
    if n <= 0:
        raise ValueError("series too short for the requested unroll_length")
    idx = np.arange(unroll_length)[None, :] + np.arange(n)[:, None]
    x = data[idx]
    y = data[np.arange(n) + unroll_length + predict_step - 1, 0]
    return x, y


def standard_scale(data: np.ndarray) -> np.ndarray:
    """Column-wise standardization (a constant column keeps std 1)."""
    data = np.asarray(data, dtype="float32")
    mean = data.mean(axis=0, keepdims=True)
    std = data.std(axis=0, keepdims=True)
    return (data - mean) / np.where(std == 0, 1.0, std)


def detect_anomalies(y_truth: np.ndarray, y_predict: np.ndarray,
                     anomaly_size: int) -> np.ndarray:
    """The ``anomaly_size`` points with the largest |truth - prediction|:
    rows of ``(y_truth, y_predict, anomaly)``, ``anomaly`` NaN for normal
    points and ``y_truth`` at anomalies."""
    y_truth = np.asarray(y_truth, dtype="float32").reshape(-1)
    y_predict = np.asarray(y_predict, dtype="float32").reshape(-1)
    err = np.abs(y_truth - y_predict)
    threshold_idx = np.argsort(-err)[:int(anomaly_size)]
    anomaly = np.full_like(y_truth, np.nan)
    anomaly[threshold_idx] = y_truth[threshold_idx]
    return np.stack([y_truth, y_predict, anomaly], axis=1)


__all__ = ["AnomalyDetector", "detect_anomalies", "standard_scale", "unroll"]
