"""Keras-style training API (port of ``nn/topology.py``): ``KerasNet``,
``Sequential`` and ``Model``.

:class:`KerasNet` is the mixin that gives a module ``compile`` / ``fit`` /
``evaluate`` / ``predict`` over the port's
:class:`~..engine.estimator.Estimator`, donated weights
(``set_initial_weights``), and weight bundles in the JAX
package's format (``save_model`` / ``load_weights``,
``models/common/zoo_model.py``), with the JAX package's sugar for
checkpoints (``set_checkpoint``), TensorBoard summaries
(``set_tensorboard``, ``get_train_summary``, ``get_validation_summary``)
and validation after each epoch of ``fit`` (``validation_data``, scored
by the compiled metrics). ``fit``, ``evaluate`` and ``predict`` take a
``TextSet`` or an ``ImageSet`` wherever they take arrays (its
``to_arrays()``, as the JAX ``_unwrap_dataset``). Put it before ``nn.Module`` in the bases: its
``compile`` (the Keras one) shadows ``nn.Module.compile``.
:class:`Sequential` and :class:`Model` are the graph containers of
``nn/graph.py`` with that API.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..common.config import TrainConfig
from ..common.triggers import Trigger
from .graph import GraphModule, SequentialModule


class KerasNet:
    """Mixin adding compile/fit/predict to a module whose ``apply(x)`` is
    its forward."""

    def compile(self, optimizer="sgd", loss="mse", metrics: Sequence = (),
                config: Optional[TrainConfig] = None, mesh=None,
                param_sharding=None, *, device=None) -> "KerasNet":
        """Configure the learning process: builds the Estimator."""
        from ..engine.estimator import Estimator
        from .metrics import get_metric

        for m in metrics:
            get_metric(m)                      # an unknown name raises here
        self._metrics = list(metrics)
        self.estimator = Estimator(self, optimizer=optimizer, loss=loss,
                                   mesh=mesh, config=config,
                                   param_sharding=param_sharding,
                                   device=device)
        return self

    def _require_compiled(self):
        if getattr(self, "estimator", None) is None:
            raise RuntimeError("call compile(...) first")

    def set_initial_weights(self, params, state=None,
                            partial: bool = False) -> "KerasNet":
        """Donate weights (the transfer-learning surface): ``params`` and
        ``state`` are the JAX package's trees (nested dicts of arrays keyed
        as this model's parameters and buffers are named, e.g. from
        ``bridge.params_to_numpy``). The port's weights live in the module,
        so they are loaded at once, and the optimizer restarts from them.
        ``partial=True`` overlays them: parameters absent from the trees
        keep their current values (the freeze-then-new-head path); without
        it every parameter and buffer must be given. A key the model does
        not have raises ``ValueError`` either way."""
        from .. import bridge

        self._require_compiled()
        given = bridge.state_dict_from_jax(params, state or {})
        own = self.state_dict()
        extra = sorted(set(given) - set(own))
        missing = sorted(set(own) - set(given))
        if extra or (missing and not partial):
            raise ValueError(f"initial weights: {len(missing)} missing (e.g. "
                             f"{missing[:5]}), {len(extra)} unexpected (e.g. "
                             f"{extra[:5]})")
        with torch.no_grad():
            for name, value in given.items():
                own[name].copy_(value)
        self.estimator.reset_optimizer()
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        self._require_compiled()
        self.estimator.set_gradient_clipping(clip_norm=clip_norm)
        return self

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        self._require_compiled()
        self.estimator.set_gradient_clipping(clip_value=(min_value,
                                                         max_value))
        return self

    def set_tensorboard(self, log_dir: str, app_name: str):
        """Train and validation summaries under ``log_dir/app_name``."""
        self._require_compiled()
        self.estimator.set_tensorboard(log_dir, app_name)
        return self

    def set_checkpoint(self, path: str, over_write: bool = True):
        """Checkpoint into ``path`` at every epoch end (and resume from it
        at the first ``fit``)."""
        self._require_compiled()
        self.estimator.config.checkpoint_dir = path
        return self

    def get_train_summary(self, tag: str):
        """``[(iteration, value), ...]`` of a train-summary scalar."""
        self._require_compiled()
        if self.estimator.train_summary is None:
            return []
        return self.estimator.train_summary.read_scalar(tag)

    def get_validation_summary(self, tag: str):
        self._require_compiled()
        if self.estimator.val_summary is None:
            return []
        return self.estimator.val_summary.read_scalar(tag)

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 1,
            validation_data=None, end_trigger: Optional[Trigger] = None,
            seed: int = 0):
        """Train on a FeatureSet, or on ``x`` (an array or a list of
        arrays) and ``y``; ``validation_data`` (a FeatureSet or an
        ``(x, y)`` pair) is scored by the compiled metrics after each
        epoch."""
        self._require_compiled()
        data = _featureset(*_unwrap_dataset(x, y))
        val = None
        if validation_data is not None:
            val = _featureset(*_unwrap_dataset(*(
                (validation_data, None) if not isinstance(
                    validation_data, (tuple, list)) else validation_data)))
        self.estimator.fit(data, batch_size=batch_size, epochs=nb_epoch,
                           end_trigger=end_trigger, validation_data=val,
                           validation_metrics=getattr(self, "_metrics", ()),
                           seed=seed)
        return self

    def evaluate(self, x, y=None, batch_size: int = 32,
                 metrics: Optional[Sequence] = None) -> Dict[str, float]:
        """Metrics over ``x`` (a FeatureSet, or arrays with ``y``): those
        given, else the compiled ones, else ``("accuracy",)``; keyed by
        metric name (``"sparse_categorical_accuracy"``, ...)."""
        self._require_compiled()
        data = _featureset(*_unwrap_dataset(x, y))
        if metrics is None:
            metrics = getattr(self, "_metrics", None) or ("accuracy",)
        return self.estimator.evaluate(data, batch_size=batch_size,
                                       metrics=metrics)

    def predict(self, x, batch_size: int = 256,
                distributed: bool = True) -> np.ndarray:
        self._require_compiled()
        x, _ = _unwrap_dataset(x, None)
        return self.estimator.predict(x, batch_size=batch_size)

    def predict_classes(self, x, batch_size: int = 256,
                        zero_based_label=True):
        cls = np.argmax(self.predict(x, batch_size), axis=-1)
        return cls if zero_based_label else cls + 1


    # -- weight bundles (the JAX package's on-disk format) -----------------
    def save_model(self, path: str):
        """Write this model's weights as a bundle (``weights.npz``,
        ``manifest.json``, ``config.json``)."""
        from ..models.common.zoo_model import save_model_bundle

        save_model_bundle(path, self)

    def load_weights(self, path: str):
        """Load a weight bundle (written by either package) into this
        model in place; a compiled model's optimizer restarts from the
        loaded weights."""
        from ..models.common.zoo_model import load_weights

        load_weights(path, self)
        est = getattr(self, "estimator", None)
        if est is not None:
            est.reset_optimizer()
        return self


def _unwrap_dataset(x, y):
    """A TextSet or ImageSet as its ``(arrays, labels)`` (the labels
    given win); anything else as it is."""
    from ..data.image import ImageSet
    from ..data.text import TextSet

    if isinstance(x, (TextSet, ImageSet)):
        xs, ys = x.to_arrays()
        return xs, (ys if y is None else y)
    return x, y


def _featureset(x, y):
    """A FeatureSet as given, or one over ``x`` (an array or a list of
    arrays) and ``y``."""
    from ..data.featureset import FeatureSet

    if isinstance(x, FeatureSet):
        return x
    return FeatureSet.from_numpy(tuple(x) if isinstance(x, (list, tuple))
                                 else x, y)


class Sequential(KerasNet, SequentialModule):
    """``Sequential([...], device=None, seed=0)`` with the training API."""


class Model(KerasNet, GraphModule):
    """``Model(inputs, outputs, name=None, device=None, seed=0)``: a
    functional graph with the training API."""


__all__ = ["KerasNet", "Model", "Sequential"]
