"""XGBoost passthrough for NNFrames (port of ``nnframes/xgb.py``, host code
copied): gradient-boosted models behind the same DataFrame
estimator/transformer API as NNEstimator/NNModel.

The engine is the ``xgboost`` package when it imports, else
scikit-learn's histogram gradient boosting (the JAX package's choice, so
both packages fit the same engine on the same data). Boosting runs on the
host; no device code. Both engines are imported inside the functions that
use them.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from .nn_estimator import _col_to_array


def _make_engine(task: str, params: Dict):
    """xgboost if installed, else sklearn HistGradientBoosting."""
    common = dict(params)
    n_round = common.pop("n_estimators", common.pop("num_round", 100))
    max_depth = common.pop("max_depth", 6)
    lr = common.pop("learning_rate", common.pop("eta", 0.3))
    try:
        import xgboost as xgb

        cls = xgb.XGBClassifier if task == "classification" else xgb.XGBRegressor
        return cls(n_estimators=n_round, max_depth=max_depth,
                   learning_rate=lr, **common), "xgboost"
    except ImportError:
        try:
            from sklearn.ensemble import (HistGradientBoostingClassifier,
                                          HistGradientBoostingRegressor)
        except ImportError as e:
            raise ImportError(
                "the XGBoost passthrough needs a boosting engine: "
                "pip install xgboost (preferred) or scikit-learn "
                "(the 'boost' extra)") from e

        cls = (HistGradientBoostingClassifier if task == "classification"
               else HistGradientBoostingRegressor)
        common.pop("nthread", None)
        common.pop("num_workers", None)
        return cls(max_iter=n_round, max_depth=max_depth, learning_rate=lr,
                   **common), "sklearn"


class _XGBEstimatorBase:
    """Shared estimator shell: camelCase setters (Spark-ML convention, like
    NNEstimator) + ``fit(df, feature_cols, label_col) -> model``."""

    task = "classification"

    def __init__(self, params: Optional[Dict] = None):
        self.params = dict(params or {})

    # -- reference XGBClassifier setter surface -------------------------------
    def setNumRound(self, n: int):
        self.params["n_estimators"] = int(n)
        return self

    def setMaxDepth(self, d: int):
        self.params["max_depth"] = int(d)
        return self

    def setEta(self, lr: float):
        self.params["learning_rate"] = float(lr)
        return self

    setLearningRate = setEta

    def setNthread(self, n: int):
        self.params["nthread"] = int(n)
        return self

    def setNumWorkers(self, n: int):
        self.params["num_workers"] = int(n)
        return self

    def fit(self, df, feature_cols: Sequence[str], label_col: str = "label"):
        x = _col_to_array(df, list(feature_cols))
        y = df[label_col].to_numpy()
        engine, backend = _make_engine(self.task, self.params)
        engine.fit(x, y)
        return self._model_cls(engine, backend=backend,
                               feature_cols=list(feature_cols))


class _XGBModelBase:
    """Fitted transformer: ``transform(df)`` appends the prediction column."""

    def __init__(self, engine, backend: str = "unknown",
                 feature_cols: Optional[Sequence[str]] = None,
                 prediction_col: str = "prediction"):
        assert engine is not None
        self.engine = engine
        self.backend = backend
        self.feature_cols = list(feature_cols or [])
        self.prediction_col = prediction_col

    def setFeaturesCol(self, features):
        self.feature_cols = (list(features) if isinstance(features, (list, tuple))
                             else [features])
        return self

    def setPredictionCol(self, prediction: str):
        self.prediction_col = prediction
        return self

    def transform(self, df):
        if not self.feature_cols:
            raise ValueError("call setFeaturesCol(...) before transform")
        x = _col_to_array(df, self.feature_cols)
        out = df.copy()
        out[self.prediction_col] = self.engine.predict(x)
        return out

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"engine": self.engine, "backend": self.backend,
                         "feature_cols": self.feature_cols,
                         "prediction_col": self.prediction_col,
                         "class": type(self).__name__}, f)

    @classmethod
    def _load(cls, path: str):
        with open(path, "rb") as f:
            blob = pickle.load(f)
        saved = blob.get("class")
        if saved is not None and saved != cls.__name__:
            raise ValueError(
                f"{path} holds a {saved}, not a {cls.__name__}")
        return cls(blob["engine"], backend=blob["backend"],
                   feature_cols=blob["feature_cols"],
                   prediction_col=blob["prediction_col"])


class XGBClassifierModel(_XGBModelBase):
    """Trained boosted classifier; the prediction column holds class labels
    (nn_classifier.py:584-612 parity)."""

    def predict_proba(self, df) -> np.ndarray:
        x = _col_to_array(df, self.feature_cols)
        return self.engine.predict_proba(x)

    @staticmethod
    def loadModel(path: str, numClasses: Optional[int] = None):
        """Reference signature (nn_classifier.py:606: path + numClasses);
        the class count is recovered from the pickled engine, so
        ``numClasses`` is accepted for compatibility and cross-checked."""
        model = XGBClassifierModel._load(path)
        n = getattr(model.engine, "n_classes_", None)
        if n is None:
            classes = getattr(model.engine, "classes_", None)
            n = len(classes) if classes is not None else None
        if numClasses is not None and n is not None and int(numClasses) != int(n):
            raise ValueError(f"model has {n} classes, expected {numClasses}")
        return model


class XGBRegressorModel(_XGBModelBase):
    """Trained boosted regressor (Scala XGBRegressorModel parity)."""

    @staticmethod
    def loadModel(path: str):
        return XGBRegressorModel._load(path)


class XGBClassifier(_XGBEstimatorBase):
    task = "classification"
    _model_cls = XGBClassifierModel


class XGBRegressor(_XGBEstimatorBase):
    task = "regression"
    _model_cls = XGBRegressorModel


__all__ = ["XGBClassifier", "XGBClassifierModel", "XGBRegressor",
           "XGBRegressorModel"]
