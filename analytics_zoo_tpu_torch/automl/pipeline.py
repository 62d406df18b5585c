"""TimeSequencePipeline (port of ``automl/pipeline.py``): the fitted
feature transformer and model as one deployable unit
(evaluate/predict/incremental fit/save, and ``load_ts_pipeline``, which
rebuilds the model on ``device``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from .feature import TimeSequenceFeatureTransformer
from .metrics import Evaluator
from .models import TimeSequenceModel


class TimeSequencePipeline:
    def __init__(self, feature_transformer: TimeSequenceFeatureTransformer,
                 model: TimeSequenceModel, config: Optional[Dict] = None,
                 name: str = "ts_pipeline"):
        self.ft = feature_transformer
        self.model = model
        self.config = dict(config or {})
        self.name = name

    # ------------------------------------------------------------------ use
    def fit(self, input_df, validation_df=None, epoch_num: int = 1):
        """Incremental fit on new data with the SAME config (pipeline
        time_sequence.py fit parity — search is NOT re-run)."""
        x, y = self.ft.transform(input_df, is_train=True)
        val = None
        if validation_df is not None:
            val = self.ft.transform(validation_df, is_train=True)
        cfg = {k: v for k, v in self.config.items()
               if k not in ("epochs", "input_shape")}
        self.model.fit_eval(x, y, validation_data=val, epochs=epoch_num, **cfg)
        return self

    def evaluate(self, input_df, metrics: List[str] = ("mse",),
                 multioutput: str = "uniform_average") -> List[float]:
        for m in metrics:
            Evaluator.check_metric(m)
        x, y = self.ft.transform(input_df, is_train=True)
        y_pred = self.model.predict(x)
        y_unscale = self.ft.unscale(y)
        y_pred_unscale = self.ft.unscale(y_pred)
        if multioutput == "raw_values" and y_unscale.ndim > 1 and y_unscale.shape[1] > 1:
            return [[Evaluator.evaluate(m, y_unscale[:, i], y_pred_unscale[:, i])
                     for i in range(y_unscale.shape[1])] for m in metrics]
        return [Evaluator.evaluate(m, y_unscale, y_pred_unscale) for m in metrics]

    def predict(self, input_df):
        """Forecast: returns a DataFrame of datetime + predicted target columns."""
        x, _ = self.ft.transform(input_df, is_train=False)
        y_pred = self.model.predict(x)
        return self.ft.post_processing(input_df, y_pred, is_train=False)

    def predict_with_uncertainty(self, input_df, n_iter: int = 20):
        x, _ = self.ft.transform(input_df, is_train=False)
        mean, std = self.model.predict_with_uncertainty(x, n_iter=n_iter)
        return (self.ft.post_processing(input_df, mean, is_train=False),
                self.ft.unscale_uncertainty(std))

    # ------------------------------------------------------------------ persist
    def save(self, pipeline_file: str):
        """Save to a directory (the reference zips)."""
        os.makedirs(pipeline_file, exist_ok=True)
        self.ft.save(os.path.join(pipeline_file, "feature_transformer.json"))
        self.model.save(os.path.join(pipeline_file, "model"),
                        os.path.join(pipeline_file, "model.config.json"))
        with open(os.path.join(pipeline_file, "pipeline.json"), "w") as f:
            json.dump({"name": self.name, "config": _jsonable(self.config)}, f)
        return pipeline_file


def _jsonable(d: Dict) -> Dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, (np.floating,)):
            v = float(v)
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        out[k] = v
    return out


def load_ts_pipeline(pipeline_file: str, *, device=None
                     ) -> TimeSequencePipeline:
    with open(os.path.join(pipeline_file, "pipeline.json")) as f:
        meta = json.load(f)
    ft = TimeSequenceFeatureTransformer()
    ft.restore(os.path.join(pipeline_file, "feature_transformer.json"))
    model = TimeSequenceModel(future_seq_len=ft.future_seq_len,
                              device=device)
    model.restore(os.path.join(pipeline_file, "model"),
                  os.path.join(pipeline_file, "model.config.json"))
    return TimeSequencePipeline(ft, model, config=meta.get("config"),
                                name=meta.get("name", "ts_pipeline"))


__all__ = ["TimeSequencePipeline", "load_ts_pipeline"]
