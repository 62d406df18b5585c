"""SessionRecommender (port of
``models/recommendation/session_recommender.py``).

Stacked GRUs over a session's item ids (the last returns its final
state), a linear layer to item logits, and, with ``include_history``, a
second tower over the user's history: its item embeddings summed over
the positions (a ``Lambda``), an MLP of relu layers and a linear layer to
item logits; the two towers' logits summed into a softmax over the
catalog. Item ids are 1-based (id 0 pads), the labels 0-based. The graph
and its slot keys are the JAX package's.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ...nn import layers as L
from ...nn.graph import Input
from ...nn.layers.merge import merge
from ..common.zoo_model import register_model
from .recommender import Recommender


def _sum_positions(t: torch.Tensor) -> torch.Tensor:
    return torch.sum(t, 1)


def _pooled_shape(s):
    return (s[-1],)


@register_model("SessionRecommender")
class SessionRecommender(Recommender):
    """Args are the reference constructor's: ``item_count``,
    ``item_embed``, ``rnn_hidden_layers``, ``session_length``,
    ``include_history``, ``mlp_hidden_layers``, ``history_length``; then
    the port's ``device`` (CUDA unless given) and ``seed`` (the weights'
    draw). Input: the ``(B, session_length)`` session ids, and with
    ``include_history`` ``[session, history]``."""

    def __init__(self, item_count: int, item_embed: int,
                 rnn_hidden_layers: Sequence[int] = (40, 20),
                 session_length: int = 0, include_history: bool = False,
                 mlp_hidden_layers: Sequence[int] = (40, 20),
                 history_length: int = 0, *, device=None, seed: int = 0):
        if session_length <= 0:
            raise ValueError("session_length should align with input "
                             "features")
        if include_history and history_length <= 0:
            raise ValueError("history_length should align with input "
                             "features")
        self.item_count = int(item_count)
        self.item_embed = int(item_embed)
        self.rnn_hidden_layers = [int(u) for u in rnn_hidden_layers]
        self.mlp_hidden_layers = [int(u) for u in mlp_hidden_layers]
        self.session_length = int(session_length)
        self.include_history = include_history
        self.history_length = int(history_length)

        input_rnn = Input((self.session_length,), name="session_input")
        x = L.Embedding(self.item_count + 1, self.item_embed,
                        init="uniform")(input_rnn)
        for h in self.rnn_hidden_layers[:-1]:
            x = L.GRU(h, return_sequences=True)(x)
        x = L.GRU(self.rnn_hidden_layers[-1], return_sequences=False)(x)
        rnn_logits = L.Dense(self.item_count)(x)
        kw = dict(name="session_recommender", device=device, seed=seed)
        if include_history:
            input_mlp = Input((self.history_length,), name="history_input")
            his = L.Embedding(self.item_count + 1, self.item_embed,
                              init="uniform")(input_mlp)
            m = L.Lambda(_sum_positions, output_shape_fn=_pooled_shape)(his)
            for h in self.mlp_hidden_layers:
                m = L.Dense(h, activation="relu")(m)
            mlp_logits = L.Dense(self.item_count)(m)
            out = L.Activation("softmax")(
                merge([rnn_logits, mlp_logits], mode="sum"))
            super().__init__([input_rnn, input_mlp], out, **kw)
        else:
            out = L.Activation("softmax")(rnn_logits)
            super().__init__(input_rnn, out, **kw)

    # session models score no user/item pairs
    def recommend_for_user(self, *a, **k):
        raise Exception("recommend_for_user: Unsupported for "
                        "SessionRecommender")

    def recommend_for_item(self, *a, **k):
        raise Exception("recommend_for_item: Unsupported for "
                        "SessionRecommender")

    def predict_user_item_pair(self, *a, **k):
        raise Exception("predict_user_item_pair: Unsupported for "
                        "SessionRecommender")

    def recommend_for_session(self, sessions, max_items: int,
                              zero_based_label: bool = True
                              ) -> List[List[tuple]]:
        """Top-``max_items`` ``(item, probability)`` per session, by
        ``argsort(-probs)``. ``sessions``: a ``(B, session_length)``
        array, or ``[session, history]`` for ``include_history``
        models."""
        if isinstance(sessions, (list, tuple)):
            sessions = [np.asarray(s) for s in sessions]
        probs = np.asarray(self.predict(sessions, batch_size=256))
        top = np.argsort(-probs, axis=-1)[:, :max_items]
        offset = 0 if zero_based_label else 1
        return [[(int(i) + offset, float(p[i])) for i in row]
                for row, p in zip(top, probs)]

    def constructor_config(self) -> dict:
        return dict(item_count=self.item_count, item_embed=self.item_embed,
                    rnn_hidden_layers=self.rnn_hidden_layers,
                    session_length=self.session_length,
                    include_history=self.include_history,
                    mlp_hidden_layers=self.mlp_hidden_layers,
                    history_length=self.history_length)

    @classmethod
    def load_model(cls, path: str, *, device=None) -> "SessionRecommender":
        """Rebuild the architecture from a bundle's config.json and load
        its weights (a bundle of either package)."""
        from ..common.zoo_model import load_model_bundle

        model, _cfg = load_model_bundle(path, device=device)
        return model


__all__ = ["SessionRecommender"]
