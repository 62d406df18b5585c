"""NNEstimator / NNModel / NNClassifier (port of
``nnframes/nn_estimator.py``): DataFrame in, fitted transformer out.

Setter names keep the reference's Spark-ML camelCase (``setBatchSize``)
with snake_case aliases. Columns are marshalled into contiguous numpy
arrays once on the host, then the model's own ``compile``/``fit`` train it
on the device the model lives on. The DataFrame is the caller's: this
module never imports pandas.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from ..common.triggers import MaxEpoch, Trigger


def _col_to_array(df, col: Union[str, Sequence[str]],
                  preprocessing: Optional[Callable] = None) -> np.ndarray:
    """Marshal DataFrame column(s) into one contiguous float array.

    * list of columns → stacked along the last axis (one scalar per column)
    * single column of scalars → (N, 1)
    * single column of arrays/lists → stacked (N, ...) — rows must agree in shape
    """
    if isinstance(col, (list, tuple)):
        mat = np.stack([df[c].to_numpy(dtype=np.float32) for c in col], axis=1)
    else:
        first = df[col].iloc[0]
        if np.isscalar(first) or isinstance(first, (int, float, np.number)):
            mat = df[col].to_numpy(dtype=np.float32)[:, None]
        else:
            rows = [np.asarray(v, dtype=np.float32) for v in df[col]]
            shapes = {r.shape for r in rows}
            if len(shapes) > 1:
                raise ValueError(
                    f"column {col!r} rows disagree in shape: {sorted(shapes)[:3]}")
            mat = np.stack(rows)
    if preprocessing is not None:
        mat = np.stack([np.asarray(preprocessing(r), dtype=np.float32)
                        for r in mat])
    return mat


class NNEstimator:
    """``NNEstimator(model, criterion).fit(df) -> NNModel``.

    ``model`` is any KerasNet (Sequential/Model/zoo model); ``criterion`` a loss
    name or callable (the BigDL Criterion slot).
    """

    def __init__(self, model, criterion="mse",
                 feature_preprocessing: Optional[Callable] = None,
                 label_preprocessing: Optional[Callable] = None):
        self.model = model
        self.criterion = criterion
        self.feature_preprocessing = feature_preprocessing
        self.label_preprocessing = label_preprocessing
        self.features_col: Union[str, List[str]] = "features"
        self.label_col: Union[str, List[str]] = "label"
        self.prediction_col = "prediction"
        self.batch_size = 32
        self.max_epoch = 1
        self.learning_rate = 1e-3
        self.optim_method = None
        self.end_when: Optional[Trigger] = None
        self.validation = None          # (trigger, df, metrics, batch_size)
        self.checkpoint_path = None
        self.tensorboard = None         # (log_dir, app_name)
        self.clip_norm = None
        self.clip_range = None
        self.cache_level = "DRAM"

    # ------------------------------------------------------- Spark-ML setters
    def setFeaturesCol(self, col):
        self.features_col = col
        return self

    def setLabelCol(self, col):
        self.label_col = col
        return self

    def setPredictionCol(self, col):
        self.prediction_col = col
        return self

    def setBatchSize(self, v):
        self.batch_size = int(v)
        return self

    def setMaxEpoch(self, v):
        self.max_epoch = int(v)
        return self

    def setLearningRate(self, v):
        self.learning_rate = float(v)
        return self

    def setOptimMethod(self, opt):
        self.optim_method = opt
        return self

    def setEndWhen(self, trigger: Trigger):
        self.end_when = trigger
        return self

    def setValidation(self, trigger, val_df, val_methods, batch_size=32):
        self.validation = (trigger, val_df, val_methods, batch_size)
        return self

    def setCheckpoint(self, path, trigger=None, isOverWrite=True):
        del trigger, isOverWrite  # estimator checkpoints per epoch
        self.checkpoint_path = path
        return self

    def setTrainSummary(self, log_dir, app_name="nnestimator"):
        self.tensorboard = (log_dir, app_name)
        return self

    def setGradientClippingByL2Norm(self, clip_norm):
        self.clip_norm = float(clip_norm)
        return self

    def setConstantGradientClipping(self, min_value, max_value):
        self.clip_range = (float(min_value), float(max_value))
        return self

    def clearGradientClipping(self):
        self.clip_norm = None
        self.clip_range = None
        return self

    def setDataCacheLevel(self, level, num_slice=None):
        self.cache_level = level if num_slice is None else (level, num_slice)
        return self

    # snake_case aliases
    set_features_col = setFeaturesCol
    set_label_col = setLabelCol
    set_prediction_col = setPredictionCol
    set_batch_size = setBatchSize
    set_max_epoch = setMaxEpoch
    set_learning_rate = setLearningRate
    set_optim_method = setOptimMethod
    set_end_when = setEndWhen
    set_validation = setValidation
    set_checkpoint = setCheckpoint
    set_train_summary = setTrainSummary

    # ----------------------------------------------------------------- fit
    def _marshal(self, df, with_label=True):
        x = _col_to_array(df, self.features_col, self.feature_preprocessing)
        y = None
        if with_label:
            y = _col_to_array(df, self.label_col, self.label_preprocessing)
        return x, y

    def _optimizer(self):
        if self.optim_method is not None:
            return self.optim_method
        from ..nn.optimizers import Adam

        return Adam(lr=self.learning_rate)

    def fit(self, df) -> "NNModel":
        x, y = self._marshal(df)
        self.model.compile(optimizer=self._optimizer(), loss=self.criterion)
        if self.clip_norm is not None:
            self.model.set_gradient_clipping_by_l2_norm(self.clip_norm)
        if self.clip_range is not None:
            self.model.set_constant_gradient_clipping(*self.clip_range)
        if self.tensorboard is not None:
            self.model.set_tensorboard(*self.tensorboard)
        if self.checkpoint_path is not None:
            self.model.set_checkpoint(self.checkpoint_path)
        val = None
        metrics = ()
        if self.validation is not None:
            _, val_df, metrics, _ = self.validation
            vx, vy = self._marshal(val_df)
            val = (vx, vy)
            self.model._metrics = list(metrics)
        self.model.fit(x, y, batch_size=self.batch_size,
                       nb_epoch=self.max_epoch, validation_data=val,
                       end_trigger=self.end_when or MaxEpoch(self.max_epoch))
        return self._create_model()

    def _create_model(self) -> "NNModel":
        return NNModel(self.model,
                       feature_preprocessing=self.feature_preprocessing,
                       features_col=self.features_col,
                       prediction_col=self.prediction_col,
                       batch_size=self.batch_size)


class NNModel:
    """Fitted transformer: ``transform(df)`` appends ``prediction_col``
    (NNEstimator.scala:665-718 NNModel parity)."""

    def __init__(self, model, feature_preprocessing=None,
                 features_col="features", prediction_col="prediction",
                 batch_size=256):
        self.model = model
        self.feature_preprocessing = feature_preprocessing
        self.features_col = features_col
        self.prediction_col = prediction_col
        self.batch_size = batch_size

    def setFeaturesCol(self, col):
        self.features_col = col
        return self

    def setPredictionCol(self, col):
        self.prediction_col = col
        return self

    def setBatchSize(self, v):
        self.batch_size = int(v)
        return self

    def _predict_array(self, df) -> np.ndarray:
        x = _col_to_array(df, self.features_col, self.feature_preprocessing)
        return np.asarray(self.model.predict(x, batch_size=self.batch_size))

    def transform(self, df):
        pred = self._predict_array(df)
        out = df.copy()
        if pred.ndim > 1 and pred.shape[1] == 1:
            out[self.prediction_col] = pred[:, 0]
        elif pred.ndim > 1:
            out[self.prediction_col] = list(pred)
        else:
            out[self.prediction_col] = pred
        return out

    def save(self, path: str):
        self.model.save_model(path)

    @staticmethod
    def load(path: str, model=None, *, device=None) -> "NNModel":
        """Load a saved NNModel. If ``model`` is None the bundle must have
        been saved by a registered zoo model (save_model records the
        class), which is rebuilt on ``device`` (CUDA unless given)."""
        if model is None:
            from ..models.common.zoo_model import load_model_bundle

            model, _ = load_model_bundle(path, device=device)
        else:
            model.load_weights(path)
        return NNModel(model)


class NNClassifier(NNEstimator):
    """NNEstimator specialization for int class labels
    (nn_classifier.py:513-560 parity: default criterion is classification NLL;
    here sparse categorical cross-entropy)."""

    def __init__(self, model, criterion="sparse_categorical_crossentropy",
                 feature_preprocessing=None):
        super().__init__(model, criterion, feature_preprocessing)

    def _marshal(self, df, with_label=True):
        x = _col_to_array(df, self.features_col, self.feature_preprocessing)
        y = None
        if with_label:
            y = df[self.label_col].to_numpy(dtype=np.int32)
        return x, y

    def _create_model(self) -> "NNClassifierModel":
        return NNClassifierModel(self.model,
                                 feature_preprocessing=self.feature_preprocessing,
                                 features_col=self.features_col,
                                 prediction_col=self.prediction_col,
                                 batch_size=self.batch_size)


class NNClassifierModel(NNModel):
    """Transform emits the argmax class index (float, Spark-ML convention)."""

    def transform(self, df):
        probs = self._predict_array(df)
        out = df.copy()
        if probs.ndim == 1 or probs.shape[-1] == 1:
            cls = (probs.reshape(len(out)) > 0.5).astype(np.float64)
        else:
            cls = probs.argmax(axis=-1).astype(np.float64)
        out[self.prediction_col] = cls
        return out


__all__ = ["NNClassifier", "NNClassifierModel", "NNEstimator", "NNModel"]
