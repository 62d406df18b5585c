"""WideAndDeep recommender (port of
``models/recommendation/wide_and_deep.py``).

Wide (one linear layer over the multi-hot crosses) plus deep (indicators,
one embedding table per embed column, continuous columns, through an MLP
of relu layers), the two logits summed into a softmax over the rating
classes. The wide input is a dense ``(B, wide_dim)`` multi-hot array
(``SparseDense``), as in the JAX package. Embed ids arrive as float32
(``features.get_deep_tensors``) and stay float through ``Select`` until
``Embedding`` casts them to integers, so bf16 compute never rounds them.
The graph and its slot keys are the JAX package's, so
``bridge.state_dict_from_jax`` and the weight bundles move a model
between the packages losslessly.
"""

from __future__ import annotations

from typing import List, Sequence

from ...nn import layers as L
from ...nn.graph import Input
from ...nn.layers.merge import merge
from ..common.zoo_model import register_model
from .features import ColumnFeatureInfo
from .recommender import Recommender


@register_model("WideAndDeep")
class WideAndDeep(Recommender):
    """Wide & Deep model.

    Args are the reference constructor's: ``class_num``, ``column_info``
    (a :class:`ColumnFeatureInfo` or its dict), ``model_type`` (``"wide"``,
    ``"deep"`` or ``"wide_n_deep"``) and ``hidden_layers``; then the
    port's ``device`` (CUDA unless given) and ``seed`` (the weights'
    draw). Inputs in ``row_to_sample``'s order: ``[wide?, indicator?,
    embed?, continuous?]``.
    """

    def __init__(self, class_num: int, column_info,
                 model_type: str = "wide_n_deep",
                 hidden_layers: Sequence[int] = (40, 20, 10), *,
                 device=None, seed: int = 0):
        if isinstance(column_info, dict):
            column_info = ColumnFeatureInfo.from_dict(column_info)
        ci = column_info
        for what, cols, *dims in (
                ("wide_base", ci.wide_base_cols, ci.wide_base_dims),
                ("wide_cross", ci.wide_cross_cols, ci.wide_cross_dims),
                ("indicator", ci.indicator_cols, ci.indicator_dims),
                ("embed", ci.embed_cols, ci.embed_in_dims,
                 ci.embed_out_dims)):
            if any(len(d) != len(cols) for d in dims):
                raise ValueError(f"size of {what}_columns should match")
        self.class_num = int(class_num)
        self.column_info = ci
        self.model_type = model_type
        self.hidden_layers = [int(u) for u in hidden_layers]

        wide_dim = ci.wide_dim
        input_wide = Input((wide_dim,), name="wide_input") if wide_dim \
            else None
        kw = dict(name="wide_and_deep", device=device, seed=seed)
        if model_type == "wide":
            out = L.Activation("softmax")(
                L.SparseDense(self.class_num)(input_wide))
            super().__init__(input_wide, out, **kw)
        elif model_type == "deep":
            deep_inputs, deep_out = self._build_deep()
            out = L.Activation("softmax")(deep_out)
            super().__init__(deep_inputs[0] if len(deep_inputs) == 1
                             else deep_inputs, out, **kw)
        elif model_type == "wide_n_deep":
            wide_linear = L.SparseDense(self.class_num)(input_wide)
            deep_inputs, deep_out = self._build_deep()
            out = L.Activation("softmax")(
                merge([wide_linear, deep_out], mode="sum"))
            super().__init__([input_wide] + deep_inputs, out, **kw)
        else:
            raise TypeError(f"Unsupported model_type: {model_type}")

    def _build_deep(self):
        """Deep tower: indicators ++ per-column embeddings ++ continuous
        -> MLP; the last layer relu over ``class_num`` logits, as the
        reference's."""
        ci = self.column_info
        inputs: List = []
        merged: List = []
        if ci.indicator_cols:
            ind = Input((sum(ci.indicator_dims),), name="indicator_input")
            inputs.append(ind)
            merged.append(ind)
        if ci.embed_cols:
            emb_in = Input((len(ci.embed_cols),), name="embed_input")
            inputs.append(emb_in)
            for i, (in_dim, out_dim) in enumerate(zip(ci.embed_in_dims,
                                                      ci.embed_out_dims)):
                col_id = L.Select(0, i)(emb_in)
                merged.append(L.Embedding(in_dim + 1, out_dim,
                                          init="normal")(col_id))
        if ci.continuous_cols:
            cont = Input((len(ci.continuous_cols),), name="continuous_input")
            inputs.append(cont)
            merged.append(cont)
        if not merged:
            raise TypeError(f"Empty deep model for: {self.model_type}")
        x = merged[0] if len(merged) == 1 else merge(merged, mode="concat")
        for h in self.hidden_layers:
            x = L.Dense(h, activation="relu")(x)
        return inputs, L.Dense(self.class_num, activation="relu")(x)

    def constructor_config(self) -> dict:
        return dict(class_num=self.class_num,
                    column_info=self.column_info.to_dict(),
                    model_type=self.model_type,
                    hidden_layers=self.hidden_layers)

    @classmethod
    def load_model(cls, path: str, *, device=None) -> "WideAndDeep":
        """Rebuild the architecture from a bundle's config.json and load
        its weights (a bundle of either package)."""
        from ..common.zoo_model import load_model_bundle

        model, _cfg = load_model_bundle(path, device=device)
        return model


__all__ = ["WideAndDeep"]
