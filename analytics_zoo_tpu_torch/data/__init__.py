"""Port of ``analytics_zoo_tpu.data``: ``FeatureSet`` and its tiers, the
prefetching input pipeline, the MovieLens datasets, TFRecord files,
``XShards``, and the image and text pipelines."""

from .datasets import (ML1M_ITEMS, ML1M_RATINGS, ML1M_USERS,
                       leave_one_out_eval_sets, movielens_1m,
                       synthetic_movielens, train_test_split_by_user)
from .featureset import BytesFeatureSet, FeatureSet, MemoryType
from .image import ImageFeature, ImageSet
from .pipeline import (PinnedCopy, PrefetchLoader, decode_map,
                       device_prefetch)
from .text import Relation, TextFeature, TextSet
from .xshards import XShards

__all__ = ["BytesFeatureSet", "FeatureSet", "ImageFeature", "ImageSet",
           "ML1M_ITEMS", "ML1M_RATINGS", "ML1M_USERS", "MemoryType",
           "PinnedCopy", "PrefetchLoader", "Relation", "TextFeature",
           "TextSet", "XShards", "decode_map", "device_prefetch",
           "leave_one_out_eval_sets", "movielens_1m", "synthetic_movielens",
           "train_test_split_by_user"]
