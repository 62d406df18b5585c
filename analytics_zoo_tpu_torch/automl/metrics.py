"""Regression/forecast metrics (port of ``automl/metrics.py``, numpy,
copied): ``Evaluator.evaluate(metric, y_true, y_pred)`` with the
reference's metric names (mse / mean_squared_error, rmse, mae, r2 /
r_square, smape, mape, accuracy).
"""

from __future__ import annotations

import numpy as np

EPS = 1e-10


def mse(y_true, y_pred):
    return float(np.mean((np.asarray(y_true) - np.asarray(y_pred)) ** 2))


def rmse(y_true, y_pred):
    return float(np.sqrt(mse(y_true, y_pred)))


def mae(y_true, y_pred):
    return float(np.mean(np.abs(np.asarray(y_true) - np.asarray(y_pred))))


def r2(y_true, y_pred):
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - np.mean(y_true)) ** 2)
    return float(1.0 - ss_res / (ss_tot + EPS))


def smape(y_true, y_pred):
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    return float(100.0 * np.mean(2 * np.abs(y_pred - y_true) /
                                 (np.abs(y_true) + np.abs(y_pred) + EPS)))


def mape(y_true, y_pred):
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    return float(100.0 * np.mean(np.abs((y_true - y_pred) / (y_true + EPS))))


def accuracy(y_true, y_pred):
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_pred.ndim > y_true.ndim:
        y_pred = np.argmax(y_pred, axis=-1)
    return float(np.mean(y_true == y_pred))


_METRICS = {
    "mse": mse, "mean_squared_error": mse,
    "rmse": rmse,
    "mae": mae, "mean_absolute_error": mae,
    "r2": r2, "r_square": r2,
    "smape": smape, "sMAPE": smape,
    "mape": mape,
    "accuracy": accuracy,
}

# metrics where larger is better (reward metrics need no negation)
LARGER_BETTER = {"r2", "r_square", "accuracy"}


class Evaluator:
    @staticmethod
    def check_metric(metric: str):
        if metric not in _METRICS:
            raise ValueError(f"metric {metric!r} not supported; choose from {sorted(_METRICS)}")

    @staticmethod
    def evaluate(metric: str, y_true, y_pred) -> float:
        Evaluator.check_metric(metric)
        return _METRICS[metric](y_true, y_pred)

    @staticmethod
    def reward(metric: str, value: float) -> float:
        """Map a metric value to 'larger is better' reward space."""
        return value if metric in LARGER_BETTER else -value


__all__ = ["EPS", "Evaluator", "LARGER_BETTER", "accuracy", "mae", "mape",
           "mse", "r2", "rmse", "smape"]
