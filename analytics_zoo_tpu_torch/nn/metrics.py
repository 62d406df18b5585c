"""Evaluation metrics (port of ``analytics_zoo_tpu/nn/metrics.py``).

Metrics stream: ``init(device) -> acc``, ``update(acc, y_true, y_pred) ->
acc`` and ``result(acc) -> float``, the JAX package's accumulator shape,
with the accumulators as f32 tensors on the device of the predictions.
``update`` never waits for the card; ``result`` reads it once.

Classification: ``SparseCategoricalAccuracy`` (``"accuracy"``),
``CategoricalAccuracy``, ``BinaryAccuracy``, ``TopK``; regression:
``MAE``, ``MSE``; any loss as ``Loss``; ``AUC`` (a 200-bucket threshold
histogram); ranking over grouped candidates (the positive at index 0 of
each group, the NCF leave-one-out layout): ``HitRate`` and ``NDCG``; and
the listwise ``ndcg_at_k`` / ``map_at_k`` of the Ranker. Ties break as
in JAX: ``argmax`` and ``top_k`` take the lower index, the ranking metrics
count only strictly higher scores ahead of the positive.
"""

from __future__ import annotations

from typing import Callable, Dict, Union

import torch


def _t(x, like: torch.Tensor = None, dtype=None) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else None
    t = torch.as_tensor(x, device=device)
    return t if dtype is None else t.to(dtype)


class Metric:
    name = "metric"

    def init(self, device=None):
        return {"total": torch.zeros((), dtype=torch.float32, device=device),
                "count": torch.zeros((), dtype=torch.float32, device=device)}

    def update(self, acc, y_true, y_pred):
        raise NotImplementedError

    def result(self, acc) -> float:
        return float(acc["total"] / torch.clamp(acc["count"], min=1.0))


def _count_update(acc, hits: torch.Tensor, n: int):
    return {"total": acc["total"] + hits.sum().to(torch.float32),
            "count": acc["count"] + float(n)}


class SparseCategoricalAccuracy(Metric):
    """Labels are int ids; predictions are (B, C) scores."""

    name = "sparse_categorical_accuracy"

    def update(self, acc, y_true, y_pred):
        labels = _t(y_true, y_pred, torch.int64).reshape(-1)
        pred = torch.argmax(y_pred, dim=-1).reshape(-1)
        return _count_update(acc, pred == labels, labels.shape[0])


class CategoricalAccuracy(Metric):
    """One-hot labels."""

    name = "categorical_accuracy"

    def update(self, acc, y_true, y_pred):
        labels = torch.argmax(_t(y_true, y_pred), dim=-1).reshape(-1)
        pred = torch.argmax(y_pred, dim=-1).reshape(-1)
        return _count_update(acc, pred == labels, labels.shape[0])


class BinaryAccuracy(Metric):
    """Threshold-0.5 accuracy."""

    name = "binary_accuracy"

    def update(self, acc, y_true, y_pred):
        labels = _t(y_true, y_pred, torch.float32).reshape(-1)
        pred = (_t(y_pred, dtype=torch.float32).reshape(-1) > 0.5).to(
            torch.float32)
        return _count_update(acc, pred == labels, labels.shape[0])


class TopK(Metric):
    """Top-k categorical accuracy: the label is a hit when fewer than
    ``k`` scores rank ahead of it (higher, or equal at a lower index: the
    order of ``lax.top_k``)."""

    def __init__(self, k: int = 5):
        self.k = k
        self.name = f"top{k}_accuracy"

    def update(self, acc, y_true, y_pred):
        labels = _t(y_true, y_pred, torch.int64).reshape(-1)
        own = torch.gather(y_pred, -1, labels[:, None])
        idx = torch.arange(y_pred.shape[-1], device=y_pred.device)[None, :]
        ahead = (y_pred > own) | ((y_pred == own) & (idx < labels[:, None]))
        hit = ahead.sum(dim=-1) < self.k
        return _count_update(acc, hit, labels.shape[0])


class MAE(Metric):
    name = "mae"

    def update(self, acc, y_true, y_pred):
        err = torch.abs(_t(y_true, y_pred, torch.float32)
                        - _t(y_pred, dtype=torch.float32))
        return {"total": acc["total"] + err.sum(),
                "count": acc["count"] + float(err.numel())}


class MSE(Metric):
    name = "mse"

    def update(self, acc, y_true, y_pred):
        err = torch.square(_t(y_true, y_pred, torch.float32)
                           - _t(y_pred, dtype=torch.float32))
        return {"total": acc["total"] + err.sum(),
                "count": acc["count"] + float(err.numel())}


class Loss(Metric):
    """A loss function as a streaming metric (batch-size-weighted mean)."""

    def __init__(self, loss_fn):
        from .losses import get_loss

        self.loss_fn = get_loss(loss_fn)
        self.name = "loss"

    def update(self, acc, y_true, y_pred):
        b = _t(y_pred).shape[0]
        return {"total": acc["total"] + self.loss_fn(y_true, y_pred) * b,
                "count": acc["count"] + float(b)}


class AUC(Metric):
    """Streaming ROC-AUC over a fixed threshold histogram (``n_thresholds``
    buckets over [0, 1]), integrated by the trapezoid rule."""

    name = "auc"

    def __init__(self, n_thresholds: int = 200):
        self.n = n_thresholds

    def init(self, device=None):
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        return {"tp": z(self.n), "fp": z(self.n), "pos": z(), "neg": z()}

    def update(self, acc, y_true, y_pred):
        y = _t(y_true, y_pred, torch.float32).reshape(-1)
        p = _t(y_pred, dtype=torch.float32).reshape(-1)
        thresholds = torch.linspace(0.0, 1.0, self.n, dtype=torch.float32,
                                    device=p.device)
        above = (p[None, :] >= thresholds[:, None]).to(torch.float32)
        tp = torch.sum(above * y[None, :], dim=1)
        fp = torch.sum(above * (1 - y)[None, :], dim=1)
        return {"tp": acc["tp"] + tp, "fp": acc["fp"] + fp,
                "pos": acc["pos"] + y.sum(), "neg": acc["neg"] + (1 - y).sum()}

    def result(self, acc) -> float:
        tpr = acc["tp"] / torch.clamp(acc["pos"], min=1.0)
        fpr = acc["fp"] / torch.clamp(acc["neg"], min=1.0)
        # thresholds ascend, so fpr and tpr descend
        return float(-torch.trapezoid(tpr, fpr))


def _positive_rank(y_pred) -> torch.Tensor:
    """1-based rank of column 0 among each group's scores: one plus the
    count of strictly higher scores."""
    scores = _t(y_pred, dtype=torch.float32)
    return torch.sum(scores[:, 1:] > scores[:, 0:1], dim=1) + 1


class HitRate(Metric):
    """HR@k over grouped candidate lists: ``y_pred`` (G, C) scores for G
    groups of C candidates, the positive at index 0; ``y_true`` is
    ignored."""

    def __init__(self, k: int = 10):
        self.k = k
        self.name = f"hit_rate@{k}"

    def update(self, acc, y_true, y_pred):
        rank = _positive_rank(y_pred)
        return _count_update(acc, rank <= self.k, rank.shape[0])


class NDCG(Metric):
    """NDCG@k over the same grouped layout: ``1 / log2(rank + 1)`` for a
    positive ranked within ``k``."""

    def __init__(self, k: int = 10):
        self.k = k
        self.name = f"ndcg@{k}"

    def update(self, acc, y_true, y_pred):
        rank = _positive_rank(y_pred).to(torch.float32)
        gain = torch.where(rank <= self.k, 1.0 / torch.log2(rank + 1.0),
                           torch.zeros_like(rank))
        return {"total": acc["total"] + gain.sum(),
                "count": acc["count"] + float(rank.shape[0])}


def _ranked(y_true_relevance, y_score, k: int):
    rel = _t(y_true_relevance, dtype=torch.float32)
    score = _t(y_score, rel, torch.float32)
    order = torch.argsort(-score, dim=-1, stable=True)[..., :k]
    return rel, torch.gather(rel, -1, order)


def ndcg_at_k(y_true_relevance, y_score, k: int) -> float:
    """Listwise NDCG@k over relevance-labelled candidates, exponential
    gain ``2^rel`` for rel > 0 (else 0) and discount ``1 / log2(i + 2)``;
    rows with no relevant candidate score 0. Mean over the leading
    dims."""
    rel, top = _ranked(y_true_relevance, y_score, k)
    n = top.shape[-1]
    discounts = 1.0 / torch.log2(torch.arange(2, n + 2, dtype=torch.float32,
                                              device=rel.device))

    def gain(r):
        return torch.where(r > 0, torch.exp2(r), torch.zeros_like(r))

    dcg = torch.sum(gain(top) * discounts, dim=-1)
    ideal = torch.sort(rel, dim=-1, descending=True).values[..., :k]
    idcg = torch.sum(gain(ideal) * discounts, dim=-1)
    ratio = torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-9),
                        torch.zeros_like(dcg))
    return float(ratio.mean())


def map_at_k(y_true_relevance, y_score, k: int) -> float:
    """Mean average precision@k over relevance-labelled candidates."""
    _, top = _ranked(y_true_relevance, y_score, k)
    rel = (top > 0).to(torch.float32)
    n = rel.shape[-1]
    prec = torch.cumsum(rel, dim=-1) / torch.arange(
        1, n + 1, dtype=torch.float32, device=rel.device)
    denom = torch.clamp(rel.sum(dim=-1), min=1.0)
    return float((torch.sum(prec * rel, dim=-1) / denom).mean())


METRICS: Dict[str, Callable[[], Metric]] = {
    "accuracy": SparseCategoricalAccuracy,
    "acc": SparseCategoricalAccuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
    "categorical_accuracy": CategoricalAccuracy,
    "binary_accuracy": BinaryAccuracy,
    "top5": lambda: TopK(5),
    "top5_accuracy": lambda: TopK(5),
    "mae": MAE,
    "mse": MSE,
    "auc": AUC,
    "hit_rate": HitRate,
    "hitrate10": lambda: HitRate(10),
    "ndcg": NDCG,
    "ndcg10": lambda: NDCG(10),
}


def get_metric(metric: Union[str, Metric]) -> Metric:
    if isinstance(metric, Metric):
        return metric
    try:
        return METRICS[metric.lower()]()
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}; known: "
                         f"{sorted(METRICS)}") from None


__all__ = ["AUC", "BinaryAccuracy", "CategoricalAccuracy", "HitRate", "Loss",
           "MAE", "METRICS", "MSE", "Metric", "NDCG",
           "SparseCategoricalAccuracy", "TopK", "get_metric", "map_at_k",
           "ndcg_at_k"]
