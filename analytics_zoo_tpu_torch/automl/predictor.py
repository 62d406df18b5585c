"""TimeSequencePredictor (port of ``automl/predictor.py``): the AutoML
entry point.

``fit(input_df, validation_df, metric, recipe)`` searches through
:class:`SearchEngine` (each trial a fresh ``TimeSequenceModel`` on the
features of its own ``TimeSequenceFeatureTransformer``), refits the best
config and returns a fitted TimeSequencePipeline. Models are built on
``device`` (CUDA unless given).
"""

from __future__ import annotations

import logging
from typing import Optional

from .feature import TimeSequenceFeatureTransformer
from .metrics import Evaluator
from .models import TimeSequenceModel
from .pipeline import TimeSequencePipeline
from .recipe import Recipe, SmokeRecipe
from .search import SearchEngine

log = logging.getLogger("analytics_zoo_tpu_torch.automl")


def _effective_config(config: dict) -> dict:
    """Derive dependent keys: MTNet consumes (long_num+1)*time_step past steps,
    so its window length is implied rather than searched (MTNet_keras.py
    behavior)."""
    cfg = dict(config)
    if cfg.get("model") == "MTNet" and "past_seq_len" not in cfg:
        cfg["past_seq_len"] = ((int(cfg.get("long_num", 3)) + 1)
                               * int(cfg.get("time_step", 4)))
    return cfg


class TimeSequencePredictor:
    def __init__(self, name: str = "automl", logs_dir: str = "~/zoo_automl_logs",
                 future_seq_len: int = 1, dt_col: str = "datetime",
                 target_col: str = "value", extra_features_col=None,
                 drop_missing: bool = True, *, device=None):
        self.name = name
        self.device = device
        self.logs_dir = logs_dir
        self.future_seq_len = int(future_seq_len)
        self.dt_col = dt_col
        self.target_col = target_col
        self.extra_features_col = extra_features_col
        self.drop_missing = drop_missing
        self.pipeline: Optional[TimeSequencePipeline] = None

    def _make_ft(self) -> TimeSequenceFeatureTransformer:
        return TimeSequenceFeatureTransformer(
            future_seq_len=self.future_seq_len, dt_col=self.dt_col,
            target_col=self.target_col, extra_features_col=self.extra_features_col,
            drop_missing=self.drop_missing)

    def fit(self, input_df, validation_df=None, metric: str = "mse",
            recipe: Optional[Recipe] = None,
            max_workers: int = 1, seed: int = 0,
            search_alg: str = "random") -> TimeSequencePipeline:
        """Search + refit. (The reference's ``mc`` flag is not a fit-time mode
        here — MC-dropout uncertainty is always available via
        ``pipeline.predict_with_uncertainty``.)"""
        Evaluator.check_metric(metric)
        recipe = recipe or SmokeRecipe()
        probe_ft = self._make_ft()
        features = probe_ft.get_feature_list(input_df)
        space = recipe.search_space(features)
        runtime = recipe.runtime_params()

        predictor = self

        def trainable(config, trial_seed: int = 0):
            del trial_seed  # trials are deterministic per config by design
            config = _effective_config(config)
            ft = predictor._make_ft()
            x, y = ft.fit_transform(input_df, **config)
            val = (ft.transform(validation_df, is_train=True)
                   if validation_df is not None else None)
            model = TimeSequenceModel(future_seq_len=predictor.future_seq_len,
                                      device=predictor.device)

            def round_fn():
                return model.fit_eval(x, y, validation_data=val, metric=metric,
                                      **{k: v for k, v in config.items()
                                         if k not in ("selected_features",
                                                      "past_seq_len")})

            return round_fn

        engine = SearchEngine(trainable, metric=metric,
                              num_samples=runtime.get("num_samples", 1),
                              training_iteration=runtime.get("training_iteration", 1),
                              max_workers=max_workers, seed=seed,
                              search_alg=search_alg)
        best = engine.run(space)

        # refit the best config on the full data to produce the pipeline
        best.config = _effective_config(best.config)
        ft = self._make_ft()
        x, y = ft.fit_transform(input_df, **best.config)
        val = (ft.transform(validation_df, is_train=True)
               if validation_df is not None else None)
        model = TimeSequenceModel(future_seq_len=self.future_seq_len,
                                  device=self.device)
        value = model.fit_eval(x, y, validation_data=val, metric=metric,
                               **{k: v for k, v in best.config.items()
                                  if k not in ("selected_features", "past_seq_len")})
        log.info("best config refit %s=%.6g", metric, value)
        self.pipeline = TimeSequencePipeline(ft, model, config=best.config,
                                             name=self.name)
        return self.pipeline

    def evaluate(self, input_df, metrics=("mse",), multioutput="uniform_average"):
        self._require_fitted()
        return self.pipeline.evaluate(input_df, metrics, multioutput)

    def predict(self, input_df):
        self._require_fitted()
        return self.pipeline.predict(input_df)

    def _require_fitted(self):
        if self.pipeline is None:
            raise RuntimeError("predictor not fitted; call fit() first")


__all__ = ["TimeSequencePredictor"]
