"""Anomaly detection (port of ``models/anomalydetection``)."""

from .anomaly_detector import (AnomalyDetector, detect_anomalies,
                               standard_scale, unroll)

__all__ = ["AnomalyDetector", "detect_anomalies", "standard_scale", "unroll"]
