"""Feature engineering for the recommenders (port of
``models/recommendation/features.py``): ``hash_bucket`` (FNV-1a, stable
across processes), ``categorical_from_vocab_list``, ``get_boundaries``,
``ColumnFeatureInfo``, ``get_wide_tensor``, ``get_deep_tensors``,
``row_to_sample``, ``rows_to_batch`` and ``get_negative_samples``.

A copy of the JAX package's numpy-only module, so the port owns it and
imports nothing of that package: the converters emit dense numpy batches
(the wide part a multi-hot ``(B, wide_dim)`` array, embed ids as
float32). ``pandas`` is imported only inside ``get_negative_samples``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def hash_bucket(content, bucket_size: int = 1000, start: int = 0) -> int:
    """Stable string hash into ``[start, start + bucket_size)`` (utils.py:26).

    Uses a deterministic FNV-1a instead of Python's salted ``hash`` so feature
    columns are reproducible across processes/hosts (required for multi-host
    input pipelines to agree on vocabulary buckets).
    """
    data = str(content).encode("utf-8")
    h = np.uint64(14695981039346656037)
    for b in data:
        h = np.uint64((int(h) ^ b) * 1099511628211 % (1 << 64))
    return int(h % np.uint64(bucket_size)) + start


def categorical_from_vocab_list(sth, vocab_list: Sequence, default: int = -1,
                                start: int = 0) -> int:
    """Index of ``sth`` in ``vocab_list`` (+start), or default (utils.py:30)."""
    if sth in vocab_list:
        return list(vocab_list).index(sth) + start
    return default + start


def get_boundaries(target, boundaries: Sequence[float], default: int = -1,
                   start: int = 0) -> int:
    """Bucketize a continuous value by ``boundaries`` (utils.py:37)."""
    if target == "?":
        return default + start
    for i, b in enumerate(boundaries):
        if target < b:
            return i + start
    return len(boundaries) + start


class ColumnFeatureInfo:
    """Column metadata shared by WideAndDeep and its feature generation
    (wide_and_deep.py:30-97 parity; field semantics identical)."""

    def __init__(self, wide_base_cols=None, wide_base_dims=None,
                 wide_cross_cols=None, wide_cross_dims=None,
                 indicator_cols=None, indicator_dims=None,
                 embed_cols=None, embed_in_dims=None, embed_out_dims=None,
                 continuous_cols=None, label: str = "label"):
        self.wide_base_cols = list(wide_base_cols or [])
        self.wide_base_dims = [int(d) for d in (wide_base_dims or [])]
        self.wide_cross_cols = list(wide_cross_cols or [])
        self.wide_cross_dims = [int(d) for d in (wide_cross_dims or [])]
        self.indicator_cols = list(indicator_cols or [])
        self.indicator_dims = [int(d) for d in (indicator_dims or [])]
        self.embed_cols = list(embed_cols or [])
        self.embed_in_dims = [int(d) for d in (embed_in_dims or [])]
        self.embed_out_dims = [int(d) for d in (embed_out_dims or [])]
        self.continuous_cols = list(continuous_cols or [])
        self.label = label

    def to_dict(self) -> Dict:
        return dict(wide_base_cols=self.wide_base_cols,
                    wide_base_dims=self.wide_base_dims,
                    wide_cross_cols=self.wide_cross_cols,
                    wide_cross_dims=self.wide_cross_dims,
                    indicator_cols=self.indicator_cols,
                    indicator_dims=self.indicator_dims,
                    embed_cols=self.embed_cols,
                    embed_in_dims=self.embed_in_dims,
                    embed_out_dims=self.embed_out_dims,
                    continuous_cols=self.continuous_cols,
                    label=self.label)

    @classmethod
    def from_dict(cls, d: Dict) -> "ColumnFeatureInfo":
        return cls(**d)

    @property
    def wide_dim(self) -> int:
        return sum(self.wide_base_dims) + sum(self.wide_cross_dims)

    def __repr__(self):
        return f"ColumnFeatureInfo({self.to_dict()})"


def get_wide_tensor(row, column_info: ColumnFeatureInfo) -> np.ndarray:
    """Multi-hot wide vector for one row (utils.py:52 parity; dense here)."""
    wide_cols = column_info.wide_base_cols + column_info.wide_cross_cols
    wide_dims = column_info.wide_base_dims + column_info.wide_cross_dims
    out = np.zeros((sum(wide_dims),), dtype="float32")
    acc = 0
    for i, col in enumerate(wide_cols):
        if i > 0:
            acc += wide_dims[i - 1]
        out[acc + int(row[col])] = 1.0
    return out


def get_deep_tensors(row, column_info: ColumnFeatureInfo) -> List[np.ndarray]:
    """Deep-side tensors [indicator?, embed?, continuous?] (utils.py:78 parity)."""
    ci = column_info
    tensors: List[np.ndarray] = []
    if ci.indicator_cols:
        ind = np.zeros((sum(ci.indicator_dims),), dtype="float32")
        acc = 0
        for i, col in enumerate(ci.indicator_cols):
            if i > 0:
                acc += ci.indicator_dims[i - 1]
            ind[acc + int(row[col])] = 1.0
        tensors.append(ind)
    if ci.embed_cols:
        tensors.append(np.asarray([float(row[c]) for c in ci.embed_cols], dtype="float32"))
    if ci.continuous_cols:
        tensors.append(np.asarray([float(row[c]) for c in ci.continuous_cols],
                                  dtype="float32"))
    if not tensors:
        raise TypeError("Empty deep tensors")
    return tensors


def row_to_sample(row, column_info: ColumnFeatureInfo,
                  model_type: str = "wide_n_deep") -> Tuple[List[np.ndarray], float]:
    """Convert one row to (features, label) (utils.py:135 parity)."""
    model_type = model_type.lower()
    label = float(row[column_info.label])
    if model_type == "wide":
        return [get_wide_tensor(row, column_info)], label
    if model_type == "deep":
        return get_deep_tensors(row, column_info), label
    if model_type == "wide_n_deep":
        return [get_wide_tensor(row, column_info)] + get_deep_tensors(row, column_info), label
    raise TypeError(f"Unsupported model_type: {model_type}")


def rows_to_batch(rows, column_info: ColumnFeatureInfo,
                  model_type: str = "wide_n_deep"
                  ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Batch many rows into stacked input arrays + labels (the batched
    form of ``row_to_sample``; feeds ``fit`` directly)."""
    feats, labels = [], []
    if hasattr(rows, "iterrows"):
        rows = (r for _, r in rows.iterrows())
    for row in rows:
        f, l = row_to_sample(row, column_info, model_type)
        feats.append(f)
        labels.append(l)
    n_inputs = len(feats[0])
    xs = [np.stack([f[i] for f in feats]) for i in range(n_inputs)]
    return xs, np.asarray(labels, dtype="float32")


def get_negative_samples(indexed, item_col: str = "itemId",
                         user_col: str = "userId", label_col: str = "label",
                         neg_per_pos: int = 1, seed: int = 0):
    """Sample random unseen items per user as negatives (label=1) — parity with
    the JVM ``getNegativeSamples`` used by the NCF notebook (utils.py:47;
    Scala .../models/recommendation/Utils.scala). Input/output: pandas DataFrame."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    items = indexed[item_col].unique()
    seen = indexed.groupby(user_col)[item_col].agg(set).to_dict()
    users, negs = [], []
    for u, pos_items in seen.items():
        need = neg_per_pos * len(pos_items)
        cand = rng.choice(items, size=min(need * 3 + 8, len(items)), replace=False)
        take = [i for i in cand if i not in pos_items][:need]
        users.extend([u] * len(take))
        negs.extend(take)
    return pd.DataFrame({user_col: users, item_col: negs,
                         label_col: np.ones(len(negs), dtype="int64")})
