"""Port of ``analytics_zoo_tpu.data``: ``FeatureSet`` and its tiers, the
prefetching input pipeline and the MovieLens datasets."""

from .datasets import (ML1M_ITEMS, ML1M_RATINGS, ML1M_USERS,
                       leave_one_out_eval_sets, movielens_1m,
                       synthetic_movielens, train_test_split_by_user)
from .featureset import BytesFeatureSet, FeatureSet, MemoryType
from .pipeline import (PinnedCopy, PrefetchLoader, decode_map,
                       device_prefetch)

__all__ = ["BytesFeatureSet", "FeatureSet", "ML1M_ITEMS", "ML1M_RATINGS",
           "ML1M_USERS", "MemoryType", "PinnedCopy", "PrefetchLoader",
           "decode_map", "device_prefetch", "leave_one_out_eval_sets",
           "movielens_1m", "synthetic_movielens", "train_test_split_by_user"]
