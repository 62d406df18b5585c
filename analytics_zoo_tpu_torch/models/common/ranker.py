"""Ranker (port of ``models/common/ranker.py``): NDCG / MAP evaluation
mixin for models whose ``predict`` scores a query's candidates.

Each query group is one ``(features, labels)`` pair; its scores come from
one ``predict`` and go through ``nn/metrics.py``'s ``ndcg_at_k`` /
``map_at_k``.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from ...nn.metrics import map_at_k, ndcg_at_k


class Ranker:
    """Mixin for models whose ``predict`` scores query/candidate batches."""

    def _group_scores(self, groups: Iterable[Tuple[np.ndarray, np.ndarray]]):
        for x, labels in groups:
            scores = np.asarray(self.predict(x)).reshape(-1)
            yield np.asarray(labels, dtype="float32").reshape(-1), scores

    def evaluate_ndcg(self, groups, k: int, threshold: float = 0.0) -> float:
        """Mean NDCG@k over query groups (an iterable of ``(features,
        labels)``, one per query). Labels at or below ``threshold`` give
        no gain; graded labels keep their grade (gain ``2^label``)."""
        vals = [ndcg_at_k(np.where(labels > threshold, labels, 0.0), scores,
                          k)
                for labels, scores in self._group_scores(groups)]
        if not vals:
            raise ValueError("no query groups to evaluate")
        return float(np.mean(vals))

    def evaluate_map(self, groups, threshold: float = 0.0) -> float:
        """Mean average precision over query groups."""
        vals = []
        for labels, scores in self._group_scores(groups):
            rel = (labels > threshold).astype("float32")
            vals.append(map_at_k(rel, scores, len(scores)))
        if not vals:
            raise ValueError("no query groups to evaluate")
        return float(np.mean(vals))


__all__ = ["Ranker"]
