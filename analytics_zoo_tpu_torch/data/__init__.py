"""Port of ``analytics_zoo_tpu.data``: the in-memory ``FeatureSet`` and the
MovieLens datasets."""

from .datasets import (ML1M_ITEMS, ML1M_RATINGS, ML1M_USERS,
                       leave_one_out_eval_sets, movielens_1m,
                       synthetic_movielens, train_test_split_by_user)
from .featureset import FeatureSet

__all__ = ["FeatureSet", "ML1M_ITEMS", "ML1M_RATINGS", "ML1M_USERS",
           "leave_one_out_eval_sets", "movielens_1m", "synthetic_movielens",
           "train_test_split_by_user"]
