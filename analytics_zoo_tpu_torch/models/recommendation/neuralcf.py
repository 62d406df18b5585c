"""NeuralCF — neural collaborative filtering (port of
``models/recommendation/neuralcf.py``).

GMF + MLP towers over (user, item) pairs: one ``FusedPairEmbedding``
gather for the four logical tables, an MLP of ``Dense`` layers on the
concatenated user/item embeddings, the GMF product beside it, merged into
a softmax rating head (``class_num >= 2``, explicit feedback) or a single
sigmoid interaction probability (``class_num == 1``). The graph and its
slot keys are the JAX package's (``0_fusedpairembedding``, ``2_dense``,
...), so ``bridge.state_dict_from_jax`` and the weight bundles move a
model between the packages losslessly.

``ImplicitNCF`` trains on the NCF-paper implicit protocol: given the
positive pairs, its training forward draws ``n_negatives`` items per
positive on the model's device from the step's key (``jax.random.randint``
bits through ``common/prng.py``, so both packages draw the same
negatives), and returns the ``(B, 1 + K)`` sigmoid block that
:func:`implicit_bce_loss` reads.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ...common import prng
from ...nn import layers as L
from ...nn.graph import Input
from ...nn.layers.merge import merge
from ..common.zoo_model import register_model
from .recommender import Recommender


@register_model("NeuralCF")
class NeuralCF(Recommender):
    """GMF + MLP recommender over ``(B, 2)`` int pairs ``[user, item]``
    of 1-based ids (``[1, user_count]``, ``[1, item_count]``: the tables
    hold ``count + 1`` rows, and an id outside them is the caller's
    error, see ``nn/layers/embedding.py``).

    Args are the reference constructor's: ``user_count``, ``item_count``,
    ``class_num``, ``user_embed``, ``item_embed``, ``hidden_layers``,
    ``include_mf``, ``mf_embed``; then the port's ``device`` (CUDA unless
    given) and ``seed`` (the weights' draw).
    """

    def __init__(self, user_count: int, item_count: int, class_num: int,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20, *,
                 device=None, seed: int = 0):
        self.user_count = user_count
        self.item_count = item_count
        self.class_num = class_num
        self.user_embed = user_embed
        self.item_embed = item_embed
        self.hidden_layers = list(hidden_layers)
        self.include_mf = include_mf
        self.mf_embed = mf_embed
        if include_mf and mf_embed <= 0:
            raise ValueError("provide a meaningful number of mf embedding "
                             "units")

        pair = Input((2,), name="user_item_pair")
        fused = L.FusedPairEmbedding(
            user_count + 1, item_count + 1, user_embed, item_embed,
            mf_embed if include_mf else 0, init="normal")(pair)
        mlp = L.Narrow(0, 0, user_embed + item_embed)(fused)
        for h in self.hidden_layers:
            mlp = L.Dense(h, activation="relu")(mlp)
        if include_mf:
            gmf = L.Narrow(0, user_embed + item_embed, mf_embed)(fused)
            head_in = merge([mlp, gmf], mode="concat")
        else:
            head_in = mlp
        if class_num == 1:
            out = L.Dense(1, activation="sigmoid")(head_in)
        else:
            out = L.Dense(class_num, activation="softmax")(head_in)
        super().__init__(pair, out, name="neuralcf", device=device, seed=seed)

    def constructor_config(self) -> dict:
        return dict(user_count=self.user_count, item_count=self.item_count,
                    class_num=self.class_num, user_embed=self.user_embed,
                    item_embed=self.item_embed,
                    hidden_layers=self.hidden_layers,
                    include_mf=self.include_mf, mf_embed=self.mf_embed)

    @property
    def table_rows(self) -> int:
        """Rows of the fused pair table, ``(user_count+1) + (item_count+1)``
        (the 1-based ids' +1s): row sharding needs them to divide the mesh
        axis (``parallel.embedding_sharding.pad_rows``)."""
        return self.user_count + 1 + self.item_count + 1

    def shard_tables(self, mesh, *, axis: str = "dp", min_rows: int = 0,
                     shard_batch: bool = True):
        """Row-shard the fused table over ``mesh[axis]`` and return the
        Estimator's ``param_sharding`` rule (replicated, and no marking,
        when :attr:`table_rows` does not divide the axis)."""
        from ...parallel.embedding_sharding import shard_embedding_tables

        return shard_embedding_tables(self, mesh, axis=axis,
                                      min_rows=min_rows,
                                      shard_batch=shard_batch)

    @classmethod
    def load_model(cls, path: str, *, device=None) -> "NeuralCF":
        """Rebuild the architecture from a bundle's config.json and load
        its weights (a bundle of either package)."""
        from ..common.zoo_model import load_model_bundle

        model, _cfg = load_model_bundle(path, device=device)
        return model


def implicit_bce_loss(y_true, y_pred):
    """BCE over a ``(B, 1+K)`` score block whose column 0 is the positive
    pair and columns 1..K the sampled negatives (the layout implies the
    labels; ``y_true`` is a dummy). The scores go to f32 before the clip:
    in bf16 ``1 - 1e-7`` rounds to 1 and a saturated sigmoid would reach
    ``log1p(-1) = -inf``."""
    p = torch.as_tensor(y_pred).float()
    labels = torch.zeros_like(p)
    labels[:, 0] = 1.0
    p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
    return -torch.mean(labels * torch.log(p) + (1.0 - labels)
                       * torch.log1p(-p))


@register_model("ImplicitNCF")
class ImplicitNCF(NeuralCF):
    """NeuralCF on the NCF-paper implicit-feedback protocol.

    Input is the ``(B, 2)`` positive pairs. In training mode the forward
    draws ``n_negatives`` items per positive, uniform in ``[1,
    item_count]``, as ``jax.random.randint(rng, (B, K), 1, item_count +
    1)`` on the model's device (fresh negatives every step from the
    step's key; ``PRNGKey(0)`` when none is given), and returns the ``(B,
    1+K)`` sigmoid scores of ``[positive | negatives]``. In inference mode
    it returns the plain ``(B, 1)`` interaction probability.
    """

    def __init__(self, user_count: int, item_count: int, n_negatives: int = 4,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20, *,
                 device=None, seed: int = 0):
        self.n_negatives = int(n_negatives)
        super().__init__(user_count, item_count, class_num=1,
                         user_embed=user_embed, item_embed=item_embed,
                         hidden_layers=hidden_layers, include_mf=include_mf,
                         mf_embed=mf_embed, device=device, seed=seed)

    def negatives(self, pos: torch.Tensor, rng) -> torch.Tensor:
        """The ``(B * K, 2)`` negative pairs the training forward scores:
        row ``b * K + j`` pairs positive ``b``'s user with draw ``(b,
        j)``."""
        b, k = pos.shape[0], self.n_negatives
        items = prng.randint(rng, (b, k), 1, self.item_count + 1,
                             device=pos.device).to(pos.dtype)
        users = pos[:, 0:1].expand(b, k)
        return torch.stack((users, items), dim=-1).reshape(b * k, 2)

    def apply(self, x, rng=None):
        if not self.training:
            return super().apply(x)
        pos = torch.as_tensor(x)
        b, k = pos.shape[0], self.n_negatives
        key = prng.PRNGKey(0) if rng is None else rng
        scores = super().apply(torch.cat((pos, self.negatives(pos, key)),
                                         dim=0))
        return torch.cat((scores[:b, 0:1], scores[b:, 0].reshape(b, k)),
                         dim=1)

    def constructor_config(self) -> dict:
        cfg = super().constructor_config()
        cfg.pop("class_num", None)
        cfg["n_negatives"] = self.n_negatives
        return cfg


__all__ = ["ImplicitNCF", "NeuralCF", "implicit_bce_loss"]
