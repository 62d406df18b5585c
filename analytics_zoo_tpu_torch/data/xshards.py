"""XShards — partitioned collections of numpy/pandas data (port of
``analytics_zoo_tpu/data/xshards.py``, which needs no JAX; the reference's
orca ``XShards``).

A shard is a host-side partition list; ``transform_shard`` maps a function
over partitions (eagerly, or lazily until the first materialisation), and
``collect_tree``/``to_featureset`` hand the data to the training engine
(``FeatureSet.from_xshards``); ``parallel_apply`` runs partitions in the
worker processes of orca's ``TaskPool``. pandas is imported only by the
readers (``read_csv``, ``read_json``, ``read_parquet``).
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np


def _split_df(df, num_partitions: int) -> List[Any]:
    """Row-split a DataFrame into partitions with clean local indices."""
    idx = np.array_split(np.arange(len(df)), num_partitions)
    return [df.iloc[i].reset_index(drop=True) for i in idx]


class XShards:
    """A list of partitions, each an arbitrary python object (dict of ndarrays,
    pandas DataFrame, ...).

    Transforms can be **lazy** (``transform_shard(fn, lazy=True)`` records the
    fn; the chain runs on first materialization — SparkXShards' deferred DAG
    semantics) and **parallel** (``parallel_apply`` fans partitions out over a
    pool of worker processes — the Spark-executor role)."""

    def __init__(self, partitions: Sequence[Any],
                 pending: Sequence[Callable] = ()):
        self._parts: List[Any] = list(partitions)
        self._pending: List[Callable] = list(pending)

    # ------------------------------------------------------------ constructors
    @classmethod
    def partition(cls, data, num_partitions: int = 4) -> "XShards":
        """Split ndarray/dict-of-ndarray into shards (orca ``XShards.partition``)."""
        if isinstance(data, dict):
            keys = list(data)
            n = len(data[keys[0]])
            splits = np.array_split(np.arange(n), num_partitions)
            return cls([{k: np.asarray(data[k])[idx] for k in keys} for idx in splits])
        if hasattr(data, "iloc"):  # pandas DataFrame/Series: keep columns
            return cls(_split_df(data, num_partitions))
        arr = np.asarray(data)
        return cls([np.ascontiguousarray(p) for p in np.array_split(arr, num_partitions)])

    @classmethod
    def read_csv(cls, path: str, num_partitions: int = 4, **kw) -> "XShards":
        """CSV reader → pandas shards (orca ``read_csv`` parity)."""
        import pandas as pd

        files = sorted(_glob.glob(path)) if any(c in path for c in "*?[") else [path]
        frames = [pd.read_csv(f, **kw) for f in files]
        df = pd.concat(frames, ignore_index=True) if len(frames) > 1 else frames[0]
        return cls(_split_df(df, num_partitions))

    @classmethod
    def read_json(cls, path: str, num_partitions: int = 4, **kw) -> "XShards":
        import pandas as pd

        files = sorted(_glob.glob(path)) if any(c in path for c in "*?[") else [path]
        frames = [pd.read_json(f, **kw) for f in files]
        df = pd.concat(frames, ignore_index=True) if len(frames) > 1 else frames[0]
        return cls(_split_df(df, num_partitions))

    @classmethod
    def read_parquet(cls, path: str, num_partitions: int = 4, **kw) -> "XShards":
        import pandas as pd

        df = pd.read_parquet(path, **kw)
        return cls(_split_df(df, num_partitions))

    # ------------------------------------------------------------------ ops
    def transform_shard(self, fn: Callable, *args,
                        lazy: bool = False) -> "XShards":
        """Apply ``fn`` to every partition (shard.py ``transform_shard``
        parity). ``lazy=True`` defers execution until materialization
        (collect/len/conversion) so chained transforms traverse each
        partition once."""
        if lazy:
            return XShards(self._parts,
                           pending=self._pending + [lambda p: fn(p, *args)])
        return XShards([fn(self._materialize_one(p), *args)
                        for p in self._parts])

    def parallel_apply(self, fn: Callable, *args, num_workers: int = 4,
                       pool=None) -> "XShards":
        """Apply ``fn`` to partitions in worker processes (the role Spark
        executors play for SparkXShards). Any pending lazy chain runs
        inside the workers too. Pass ``pool`` to reuse a live
        ``orca.TaskPool``; otherwise a temporary one is spawned. The
        workers have no card (``orca/task_pool.py``)."""
        from ..orca.task_pool import TaskPool

        chain = list(self._pending)

        def run(part):
            for g in chain:
                part = g(part)
            return fn(part, *args)

        if pool is not None:
            return XShards(pool.map(run, self._parts))
        with TaskPool(min(num_workers, max(1, len(self._parts)))) as p:
            return XShards(p.map(run, self._parts))

    def _materialize_one(self, part):
        for g in self._pending:
            part = g(part)
        return part

    def cache(self) -> "XShards":
        """Run any pending lazy chain now, in place (persist() analog)."""
        self._parts = [self._materialize_one(p) for p in self._parts]
        self._pending = []
        return self

    def collect(self) -> List[Any]:
        # materialize IN PLACE: a len()/collect() pair must not run the lazy
        # chain over every partition twice
        self.cache()
        return list(self._parts)

    def num_partitions(self) -> int:
        return len(self._parts)

    def repartition(self, num_partitions: int) -> "XShards":
        flat = self.collect_tree()
        return XShards.partition(flat, num_partitions)

    def __len__(self) -> int:
        parts = self.collect()
        first = parts[0]
        if isinstance(first, dict):
            k = next(iter(first))
            return sum(len(p[k]) for p in parts)
        return sum(len(p) for p in parts)

    # -------------------------------------------------------------- conversion
    def collect_tree(self):
        """Concatenate partitions into one array tree (feeds FeatureSet)."""
        parts = self.collect()
        first = parts[0]
        if isinstance(first, dict):
            return {k: np.concatenate([np.asarray(p[k]) for p in parts])
                    for k in first}
        if hasattr(first, "values") and hasattr(first, "columns"):  # DataFrame
            import pandas as pd

            return pd.concat(parts, ignore_index=True)
        return np.concatenate([np.asarray(p) for p in parts])

    def host_split(self, process_index: int, process_count: int) -> "XShards":
        """This host's partitions of a multi-host job (partition i belongs to
        host ``i % process_count`` — Spark partition placement analog). Feed
        the result to ``FeatureSet.from_host_shard`` so each host ingests only
        its own slice instead of materializing the global dataset."""
        return XShards(self._parts[process_index::process_count],
                       pending=self._pending)

    def to_featureset(self, feature_cols: Optional[Sequence[str]] = None,
                      label_cols: Optional[Sequence[str]] = None, **kw):
        """Build a FeatureSet; for DataFrame shards select feature/label columns
        (the NNEstimator fit(df, feature_cols, label_cols) capability)."""
        from .featureset import FeatureSet

        tree = self.collect_tree()
        if feature_cols is not None:
            x = np.stack([np.asarray(tree[c]) for c in feature_cols], axis=-1)
            if label_cols:
                y = np.stack([np.asarray(tree[c]) for c in label_cols], axis=-1)
                if y.shape[-1] == 1:
                    y = y[..., 0]
                return FeatureSet((x, y), **kw)
            return FeatureSet((x,), **kw)
        return FeatureSet(tree if isinstance(tree, tuple) else (tree,), **kw)
