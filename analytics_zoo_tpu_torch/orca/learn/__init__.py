from .estimator import Estimator

__all__ = ["Estimator"]
