"""AutoTS API (port of ``zouwu/autots/forecast.py``):
``AutoTSTrainer(horizon, dt_col, target_col, extra_features_col).fit(
train_df, validation_df, metric, recipe) -> TSPipeline``; ``TSPipeline``
wraps the fitted automl pipeline with fit/evaluate/predict/save/load.
Models are built on ``device`` (CUDA unless given)."""

from __future__ import annotations

from typing import List, Optional

from ...automl.pipeline import TimeSequencePipeline, load_ts_pipeline
from ...automl.predictor import TimeSequencePredictor
from ...automl.recipe import Recipe, SmokeRecipe


class AutoTSTrainer:
    """Automated time-series forecast trainer (zouwu/autots/forecast.py:22)."""

    def __init__(self, horizon: int = 1, dt_col: str = "datetime",
                 target_col: str = "value",
                 extra_features_col: Optional[List[str]] = None, *,
                 device=None):
        self.internal = TimeSequencePredictor(
            dt_col=dt_col, target_col=target_col, future_seq_len=horizon,
            extra_features_col=extra_features_col, device=device)

    def fit(self, train_df, validation_df=None, metric: str = "mse",
            recipe: Optional[Recipe] = None, uncertainty: bool = False,
            max_workers: int = 1, seed: int = 0) -> "TSPipeline":
        del uncertainty  # MC-dropout uncertainty is always available at predict
        pipeline = self.internal.fit(train_df, validation_df, metric,
                                     recipe or SmokeRecipe(),
                                     max_workers=max_workers, seed=seed)
        ppl = TSPipeline()
        ppl.internal = pipeline
        return ppl


class TSPipeline:
    """Deployable forecast pipeline (zouwu/autots/forecast.py:81)."""

    def __init__(self):
        self.internal: Optional[TimeSequencePipeline] = None

    def fit(self, input_df, validation_df=None, epochs: int = 1, **user_config):
        if user_config:
            self.internal.config.update(user_config)
        self.internal.fit(input_df, validation_df, epoch_num=epochs)
        return self

    def evaluate(self, input_df, metrics: List[str] = ("mse",),
                 multioutput: str = "raw_values"):
        return self.internal.evaluate(input_df, metrics, multioutput)

    def predict(self, input_df):
        return self.internal.predict(input_df)

    def predict_with_uncertainty(self, input_df, n_iter: int = 20):
        return self.internal.predict_with_uncertainty(input_df, n_iter)

    def save(self, pipeline_file: str):
        return self.internal.save(pipeline_file)

    @staticmethod
    def load(pipeline_file: str, *, device=None) -> "TSPipeline":
        ppl = TSPipeline()
        ppl.internal = load_ts_pipeline(pipeline_file, device=device)
        return ppl


__all__ = ["AutoTSTrainer", "TSPipeline"]
