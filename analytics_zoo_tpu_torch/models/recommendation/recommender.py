"""Recommender base (port of ``models/recommendation/recommender.py``):
user/item pair prediction and top-K recommendation.

Scoring every candidate pair is one batched ``predict`` on the card; the
ranking runs on the host over its numpy output. Recommendations order each
user's (or item's) candidates by ``(-prediction, -probability)``: the
predicted rating class first, its probability breaking ties.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ...nn.topology import Model


@dataclass
class UserItemPrediction:
    user_id: int
    item_id: int
    prediction: int
    probability: float


class Recommender(Model):
    """Base class: subclasses build a graph scoring (user, item) int pairs
    into class probabilities (rating classes, 1-based)."""

    def predict_user_item_pair(self, user_item_pairs: np.ndarray,
                               batch_size: int = 4096
                               ) -> List[UserItemPrediction]:
        """Score explicit (user, item) pairs: each pair's argmax class
        (1-based) and its probability."""
        pairs = np.asarray(user_item_pairs, dtype="int32")
        probs = self.predict(pairs, batch_size=batch_size)
        cls = probs.argmax(-1)
        return [UserItemPrediction(int(u), int(i), int(c) + 1, float(p[c]))
                for (u, i), c, p in zip(pairs, cls, probs)]

    def _top(self, user_item_pairs, column: int, max_n: int
             ) -> List[UserItemPrediction]:
        pairs = np.asarray(user_item_pairs, dtype="int32")
        groups = {}
        for p in self.predict_user_item_pair(pairs):
            groups.setdefault((p.user_id, p.item_id)[column], []).append(p)
        out: List[UserItemPrediction] = []
        for key in sorted(groups):
            ranked = sorted(groups[key],
                            key=lambda p: (-p.prediction, -p.probability))
            out.extend(ranked[:max_n])
        return out

    def recommend_for_user(self, user_item_pairs: np.ndarray, max_items: int
                           ) -> List[UserItemPrediction]:
        """Top-``max_items`` per user among the candidate pairs given,
        users in ascending order."""
        return self._top(user_item_pairs, 0, max_items)

    def recommend_for_item(self, user_item_pairs: np.ndarray, max_users: int
                           ) -> List[UserItemPrediction]:
        """Top-``max_users`` per item among the candidate pairs given,
        items in ascending order."""
        return self._top(user_item_pairs, 1, max_users)


__all__ = ["Recommender", "UserItemPrediction"]
