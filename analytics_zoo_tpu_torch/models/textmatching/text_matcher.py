"""TextMatcher, the base of the text-matching and ranking models (port of
``models/textmatching/text_matcher.py``): a functional ``Model`` with
:class:`~..common.ranker.Ranker`'s NDCG/MAP evaluation, holding
``text1_length``, ``vocab_size``, ``embed_size``, ``embed_weights``,
``train_embed`` and ``target_mode``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...nn.topology import Model
from ..common.ranker import Ranker


class TextMatcher(Model, Ranker):
    """Base of the matching models; a subclass builds the scoring graph."""

    def _init_matcher(self, text1_length: int, vocab_size: int,
                      embed_size: int = 300,
                      embed_weights: Optional[np.ndarray] = None,
                      train_embed: bool = True,
                      target_mode: str = "ranking"):
        if target_mode not in ("ranking", "classification"):
            raise ValueError("target_mode should be either ranking or "
                             "classification")
        self.text1_length = int(text1_length)
        self.vocab_size = int(vocab_size)
        self.embed_size = int(embed_size)
        self.embed_weights = embed_weights
        self.train_embed = bool(train_embed)
        self.target_mode = target_mode


__all__ = ["TextMatcher"]
