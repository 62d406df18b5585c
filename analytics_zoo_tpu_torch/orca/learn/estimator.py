"""Orca unified Estimator (port of ``orca/learn/estimator.py``): one
fit/evaluate/predict facade over every data form.

The Estimator's job is data marshalling (XShards, pandas, numpy, dicts,
FeatureSet) into the port's training engine underneath the model
(``model.compile``/``fit``): the model's ``estimator`` runs the steps on
the device the model lives on. pandas is never imported here: a
DataFrame is recognised only when pandas is already loaded.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ...common import telemetry as _tm
from ...data.xshards import XShards

_ORCA_FITS = _tm.counter("zoo_orca_fit_total",
                         "Orca Estimator.fit invocations", labels=("input",))


def _is_dataframe(data) -> bool:
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(data, pd.DataFrame)


def _columns(frame, cols) -> np.ndarray:
    return np.stack([frame[c].to_numpy(dtype=np.float32) for c in cols],
                    axis=1)


def _marshal_shards(data: XShards, feature_cols, label_cols):
    """Collect XShards partitions into (x, y) arrays. Partitions may be
    pandas DataFrames (use feature/label cols), dicts with 'x'/'y', or
    (x, y) tuples."""
    parts = data.collect()
    xs, ys = [], []
    for p in parts:
        if isinstance(p, np.ndarray):
            xs.append(p)
        elif isinstance(p, dict):
            xs.append(np.asarray(p["x"]))
            if "y" in p and p["y"] is not None:
                ys.append(np.asarray(p["y"]))
        elif isinstance(p, tuple) and len(p) == 2:
            xs.append(np.asarray(p[0]))
            ys.append(np.asarray(p[1]))
        else:  # pandas DataFrame
            if feature_cols is None:
                raise ValueError("feature_cols required for DataFrame shards")
            xs.append(_columns(p, feature_cols))
            if label_cols:
                ys.append(_columns(p, label_cols))
    x = np.concatenate(xs, axis=0)
    y = np.concatenate(ys, axis=0) if ys else None
    return x, y


def host_sharded_featureset(data: XShards, feature_cols=None, label_cols=None,
                            *, process_index: int, process_count: int):
    """This host's partitions of an XShards as
    ``FeatureSet.from_host_shard``: partition ``i`` belongs to host
    ``i % process_count``, and each host marshals only its slice. Every
    host computes all hosts' row counts from the shared partition layout
    and truncates its slice to the least, so no host runs a step the others
    skip (which would hang the collectives); a host left with no rows
    raises."""
    from ...data.featureset import FeatureSet

    def rows(p) -> int:
        if isinstance(p, dict):
            return len(p["x"])
        if isinstance(p, tuple):
            return len(p[0])
        return len(p)

    # counting needs no materialisation unless a lazy chain could change
    # partition lengths
    parts = data.collect() if data._pending else list(data._parts)
    counts = [sum(rows(p) for p in parts[r::process_count])
              for r in range(process_count)]
    empty = [r for r, c in enumerate(counts) if c == 0]
    if empty:
        raise ValueError(
            f"hosts {empty} would receive no data: {len(parts)} partitions "
            f"over {process_count} hosts (counts={counts}); repartition the "
            f"XShards to at least one non-empty partition per host")
    n_min = min(counts)

    local = data.host_split(process_index, process_count)
    x, y = _marshal_shards(local, feature_cols, label_cols)
    x = x[:n_min]
    tree = (x,) if y is None else (x, y[:n_min])
    return FeatureSet.from_host_shard(tree, process_index=process_index,
                                      process_count=process_count)


def _marshal(data, feature_cols=None, label_cols=None):
    if isinstance(data, XShards):
        return _marshal_shards(data, feature_cols, label_cols)
    if _is_dataframe(data):
        if feature_cols is None:
            raise ValueError("feature_cols required for DataFrame input")
        y = _columns(data, label_cols) if label_cols else None
        return _columns(data, feature_cols), y
    if isinstance(data, tuple) and len(data) == 2:
        return data
    if isinstance(data, dict):
        return data["x"], data.get("y")
    return data, None  # bare x (predict) or FeatureSet (passed through)


def _processes():
    """``(process_index, process_count)`` of the runtime context, (0, 1)
    without one."""
    from ...common.context import get_zoo_context

    try:
        ctx = get_zoo_context(auto_init=False)
    except RuntimeError:
        return 0, 1
    return ctx.process_index, ctx.process_count


class Estimator:
    """Unified estimator over any KerasNet (:meth:`from_keras`)."""

    def __init__(self, model, loss="mse", optimizer="adam",
                 metrics: Sequence = ()):
        self.model = model
        self._loss = loss
        self._optimizer = optimizer
        self._metrics = list(metrics)
        self._compiled = False

    # ------------------------------------------------------------ constructors
    @staticmethod
    def from_keras(model, loss="mse", optimizer="adam", metrics=()
                   ) -> "Estimator":
        """Any KerasNet (Sequential/Model/zoo model) as an Estimator."""
        return Estimator(model, loss=loss, optimizer=optimizer,
                         metrics=metrics)

    # the reference's separate pytorch entry; the model API is the same
    from_model = from_keras

    def _ensure_compiled(self):
        if not self._compiled:
            self.model.compile(optimizer=self._optimizer, loss=self._loss,
                               metrics=self._metrics)
            self._compiled = True

    # ------------------------------------------------------------------ verbs
    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            feature_cols: Optional[List[str]] = None,
            label_cols: Optional[List[str]] = None,
            validation_data=None,
            host_sharding: Optional[bool] = None,
            prefetch_depth: Optional[int] = None,
            async_checkpoint: Optional[bool] = None,
            grad_accum_steps: Optional[int] = None,
            compute_dtype: Optional[str] = None,
            update_sharding=None) -> "Estimator":
        """``host_sharding`` (default: on in a multi-process job): XShards
        input is split by partition across processes and each marshals
        only its own slice (:func:`host_sharded_featureset`).

        ``prefetch_depth`` / ``async_checkpoint`` override the engine's
        knobs for this fit only (the prior values are restored on return).
        ``grad_accum_steps`` / ``compute_dtype`` / ``update_sharding`` are
        sticky: they shape the step and the optimizer state's layout, so
        they are set at the model's first fit, and changing one after
        training started raises, with the config left as it was."""
        self._ensure_compiled()
        eng = self.model.estimator
        cfg = eng.config
        # validate before mutating: a rejected call leaves the config as
        # it was
        if eng.train_state is not None:
            for name, want, have in (
                    ("grad_accum_steps",
                     None if grad_accum_steps is None
                     else int(grad_accum_steps), cfg.grad_accum_steps),
                    ("update_sharding", update_sharding, cfg.update_sharding),
                    ("compute_dtype", compute_dtype, cfg.compute_dtype)):
                if want is not None and want != have:
                    raise RuntimeError(
                        f"{name} cannot change after training started: the "
                        f"step and state layout are already built")
        saved = (cfg.prefetch_depth, cfg.async_checkpoint)
        if prefetch_depth is not None:
            cfg.prefetch_depth = int(prefetch_depth)
        if async_checkpoint is not None:
            cfg.async_checkpoint = bool(async_checkpoint)
        if grad_accum_steps is not None:
            cfg.grad_accum_steps = int(grad_accum_steps)
        if update_sharding is not None:
            cfg.update_sharding = update_sharding
        if compute_dtype is not None and compute_dtype != cfg.compute_dtype:
            cfg.compute_dtype = compute_dtype
            eng._rebuild_tx()
        _ORCA_FITS.labels(input=type(data).__name__).inc()
        # the per-step DataWait/Compute split comes from the engine
        # underneath and is read back by train_stats()
        try:
            with _tm.span("orca.fit"):
                return self._fit(data, epochs, batch_size, feature_cols,
                                 label_cols, validation_data, host_sharding)
        finally:
            cfg.prefetch_depth, cfg.async_checkpoint = saved

    def _fit(self, data, epochs, batch_size, feature_cols, label_cols,
             validation_data, host_sharding) -> "Estimator":
        if isinstance(data, XShards):
            index, count = _processes()
            if host_sharding is None:
                host_sharding = count > 1
            if host_sharding:
                fs = host_sharded_featureset(
                    data, feature_cols, label_cols,
                    process_index=index, process_count=count)
                val = None
                if validation_data is not None:
                    if isinstance(validation_data, XShards):
                        val = host_sharded_featureset(
                            validation_data, feature_cols, label_cols,
                            process_index=index, process_count=count)
                    else:  # arrays: every host evaluates the full set
                        val = _marshal(validation_data, feature_cols,
                                       label_cols)
                self.model.fit(fs, batch_size=batch_size, nb_epoch=epochs,
                               validation_data=val)
                return self
        x, y = _marshal(data, feature_cols, label_cols)
        val = None
        if validation_data is not None:
            val = _marshal(validation_data, feature_cols, label_cols)
        self.model.fit(x, y, batch_size=batch_size, nb_epoch=epochs,
                       validation_data=val)
        return self

    def train_stats(self) -> Dict[str, Any]:
        """The training-side telemetry snapshot: the ``zoo_train_*`` and
        ``zoo_data_*`` families and the summary scalars."""
        snap = _tm.snapshot()
        return {k: v for k, v in snap.items() if k.startswith("zoo_train_")
                or k.startswith("zoo_data_") or k == "zoo_summary_scalar"}

    def evaluate(self, data, batch_size: int = 32,
                 feature_cols=None, label_cols=None, metrics=None):
        self._ensure_compiled()
        x, y = _marshal(data, feature_cols, label_cols)
        return self.model.evaluate(
            x, y, batch_size=batch_size,
            metrics=metrics if metrics is not None
            else (self._metrics or ("mse",)))

    def predict(self, data, batch_size: int = 256, feature_cols=None):
        self._ensure_compiled()
        if isinstance(data, XShards):
            # one result partition per input partition
            return XShards([np.asarray(self.model.predict(
                _marshal(p, feature_cols, None)[0], batch_size=batch_size))
                for p in data.collect()])
        x, _ = _marshal(data, feature_cols, None)
        return np.asarray(self.model.predict(x, batch_size=batch_size))

    # ------------------------------------------------------------- persistence
    def save(self, path: str):
        self.model.save_model(path)

    def load(self, path: str) -> "Estimator":
        self.model.load_weights(path)
        return self

    def get_model(self):
        return self.model


__all__ = ["Estimator", "host_sharded_featureset"]
