"""NNFrames — DataFrame-native ML pipeline integration (port of
``analytics_zoo_tpu/nnframes/``): ``NNEstimator(model, criterion)
.setBatchSize(..).setMaxEpoch(..).fit(df)`` → ``NNModel.transform(df)``
appends a prediction column; ``NNClassifier``/``NNClassifierModel`` for
class labels; ``NNImageReader.readImages`` loads a directory of images
into a DataFrame; the XGBoost passthrough on the host."""

from .nn_estimator import NNEstimator, NNModel, NNClassifier, NNClassifierModel
from .nn_image_reader import NNImageReader
from .xgb import (XGBClassifier, XGBClassifierModel, XGBRegressor,
                  XGBRegressorModel)

__all__ = ["NNEstimator", "NNModel", "NNClassifier", "NNClassifierModel",
           "NNImageReader", "XGBClassifier", "XGBClassifierModel",
           "XGBRegressor", "XGBRegressorModel"]
