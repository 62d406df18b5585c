"""Anomaly detection (port of ``zouwu/model/anomaly.py``): the distances,
``ThresholdEstimator`` and ``ThresholdDetector`` (numpy, copied), and the
autoencoder reconstruction-error detector ``AEDetector`` on the port's
``Sequential``, trained on ``device`` (CUDA unless given).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np


class Distance:
    def distance(self, x, y):  # pragma: no cover - interface
        raise NotImplementedError

    def pairwise(self, y: np.ndarray, yhat: np.ndarray) -> np.ndarray:
        """Vector of per-sample distances (rows of y vs rows of yhat)."""
        return np.array([self.distance(a, b) for a, b in zip(y, yhat)])


class EuclideanDistance(Distance):
    def distance(self, x, y):
        return float(np.linalg.norm(np.asarray(x) - np.asarray(y)))

    def pairwise(self, y, yhat):
        d = np.asarray(y, dtype=np.float64) - np.asarray(yhat, dtype=np.float64)
        if d.ndim == 1:
            return np.abs(d)
        return np.linalg.norm(d.reshape(d.shape[0], -1), axis=1)


class ThresholdEstimator:
    """Find a distance threshold so that ``ratio`` of samples are anomalous
    (anomaly.py:51-83 parity: 'default' percentile mode, 'gaussian' fit mode)."""

    def fit(self, y, yhat, mode: str = "default", ratio: float = 0.01,
            dist_measure: Distance = EuclideanDistance()) -> float:
        y, yhat = np.asarray(y), np.asarray(yhat)
        if y.shape != yhat.shape:
            raise ValueError(f"shape mismatch {y.shape} vs {yhat.shape}")
        diff = dist_measure.pairwise(y, yhat)
        if mode == "default":
            return float(np.percentile(diff, (1 - ratio) * 100))
        if mode == "gaussian":
            mu, sigma = float(np.mean(diff)), float(np.std(diff))
            # z-score for the (1-ratio) quantile of a normal fit
            from statistics import NormalDist
            t = NormalDist().inv_cdf(1 - ratio)
            return t * sigma + mu
        raise ValueError(f"unsupported mode {mode!r}")


class DetectorBase:
    def detect(self, y, **kwargs):  # pragma: no cover - interface
        raise NotImplementedError


class ThresholdDetector(DetectorBase):
    """Threshold-based detector (anomaly.py:100-146 parity). ``threshold`` may be
    a scalar (global distance), a (num_samples,) vector (per-sample distance),
    a y-shaped array (per-dimension distance), or a (min, max) tuple of y-shaped
    arrays (out-of-range detection; ``yhat`` ignored)."""

    def detect(self, y, yhat=None, threshold=math.inf,
               dist_measure: Distance = EuclideanDistance()) -> List[int]:
        y = np.asarray(y)
        if isinstance(threshold, tuple):
            lo, hi = np.asarray(threshold[0]), np.asarray(threshold[1])
            if lo.shape != y.shape or hi.shape != y.shape:
                raise ValueError("range thresholds must match y's shape")
            flat = y.reshape(y.shape[0], -1)
            bad = ((flat < lo.reshape(lo.shape[0], -1))
                   | (flat > hi.reshape(hi.shape[0], -1))).any(axis=1)
            return list(np.nonzero(bad)[0])
        if yhat is None:
            raise ValueError("yhat is required unless threshold is a (min,max) tuple")
        yhat = np.asarray(yhat)
        if np.ndim(threshold) == 0:  # python or numpy scalar
            diff = dist_measure.pairwise(y, yhat)
            return list(np.nonzero(diff >= float(threshold))[0])
        threshold = np.asarray(threshold)
        if threshold.ndim == 1:
            diff = dist_measure.pairwise(y, yhat)
            if threshold.shape[0] != diff.shape[0]:
                raise ValueError("per-sample threshold length mismatch")
            return list(np.nonzero(diff >= threshold)[0])
        if threshold.shape == y.shape:
            bad = (np.abs(y - yhat) >= threshold).reshape(y.shape[0], -1).any(axis=1)
            return list(np.nonzero(bad)[0])
        raise ValueError(f"threshold shape {threshold.shape} is not valid")


class AEDetector(DetectorBase):
    """Autoencoder reconstruction-error detector: fit a small dense AE on
    (presumed mostly-normal) windows; anomalies are the samples whose
    reconstruction error exceeds the fitted threshold."""

    def __init__(self, latent_dim: int = 8, hidden: int = 32,
                 ratio: float = 0.01, epochs: int = 10, batch_size: int = 64,
                 lr: float = 1e-3, *, device=None):
        self.latent_dim = latent_dim
        self.hidden = hidden
        self.ratio = ratio
        self.epochs = epochs
        self.batch_size = batch_size
        self.lr = lr
        self.device = device
        self.model = None
        self.threshold_: Optional[float] = None

    def _build(self, dim: int):
        """The autoencoder over ``dim`` features (not compiled)."""
        from ...nn import layers as L
        from ...nn.topology import Sequential

        m = Sequential(name="ae_detector", device=self.device)
        m.add(L.InputLayer((dim,)))
        m.add(L.Dense(self.hidden, activation="relu"))
        m.add(L.Dense(self.latent_dim, activation="relu"))
        m.add(L.Dense(self.hidden, activation="relu"))
        m.add(L.Dense(dim))
        return m

    def fit(self, y: np.ndarray):
        from ...nn.optimizers import Adam

        y = np.asarray(y, dtype=np.float32)
        flat = y.reshape(y.shape[0], -1)
        m = self._build(flat.shape[1])
        m.compile(optimizer=Adam(lr=self.lr), loss="mse")
        m.fit(flat, flat, batch_size=min(self.batch_size, len(flat)),
              nb_epoch=self.epochs)
        self.model = m
        err = self.score(y)
        self.threshold_ = float(np.percentile(err, (1 - self.ratio) * 100))
        return self

    def score(self, y: np.ndarray) -> np.ndarray:
        if self.model is None:
            raise RuntimeError("AEDetector not fitted")
        flat = np.asarray(y, dtype=np.float32).reshape(len(y), -1)
        recon = np.asarray(self.model.predict(flat))
        return np.linalg.norm(flat - recon, axis=1)

    def detect(self, y, threshold: Optional[float] = None) -> List[int]:
        t = self.threshold_ if threshold is None else threshold
        return list(np.nonzero(self.score(y) >= t)[0])


__all__ = ["AEDetector", "DetectorBase", "Distance", "EuclideanDistance",
           "ThresholdDetector", "ThresholdEstimator"]
