"""KNRM, the kernel-pooling neural ranking model (arXiv:1706.06613; port of
``models/textmatching/knrm.py``).

One embedding over the concatenated (query ++ doc) ids, the translation
matrix Q·Dᵀ, RBF kernel pooling and a linear (``ranking``) or sigmoid
(``classification``) head. All ``kernel_num`` kernels evaluate as one
(B, Q, D, K) broadcast. The graph's slots are the JAX model's
(``0_embedding``, ``1_lambda``, ``2_dense``), so a JAX KNRM's params load
through ``bridge.state_dict_from_jax`` and a bundle loads in either
package. The kernel centres and widths are non-persistent buffers (not
in the bundle), in f32 as the JAX model's numpy constants are.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...nn import layers as L
from ...nn.graph import Input
from ..common.zoo_model import register_model
from .text_matcher import TextMatcher


def _kernels(kernel_num: int, sigma: float, exact_sigma: float):
    """Kernel centres ``mu_i = 1/(K-1) + 2i/(K-1) - 1`` and widths; a centre
    past 1 is the exact-match kernel at 1.0 with ``exact_sigma``."""
    mus, sigmas = [], []
    for i in range(kernel_num):
        mu = 1.0 / (kernel_num - 1) + (2.0 * i) / (kernel_num - 1) - 1.0
        if mu > 1.0:
            mus.append(1.0)
            sigmas.append(exact_sigma)
        else:
            mus.append(mu)
            sigmas.append(sigma)
    return (np.asarray(mus, dtype="float32"),
            np.asarray(sigmas, dtype="float32"))


@register_model("KNRM")
class KNRM(TextMatcher):
    """``text1_length``, ``text2_length``, ``embedding_file``/
    ``word_index`` (or ``vocab_size``/``embed_size`` without a file),
    ``train_embed``, ``kernel_num``, ``sigma``, ``exact_sigma``,
    ``target_mode``; ``device``: CUDA unless given; ``seed`` draws the
    port's own initial weights."""

    def __init__(self, text1_length: int, text2_length: int,
                 embedding_file: Optional[str] = None,
                 word_index: Optional[Dict[str, int]] = None,
                 train_embed: bool = True, kernel_num: int = 21,
                 sigma: float = 0.1, exact_sigma: float = 0.001,
                 target_mode: str = "ranking",
                 vocab_size: Optional[int] = None, embed_size: int = 300, *,
                 device=None, seed: int = 0):
        if kernel_num <= 1:
            raise ValueError("kernel_num must be an int larger than 1")
        if embedding_file is not None:
            if word_index is None:
                raise ValueError("word_index is required with "
                                 "embedding_file")
            from ...nn.layers.embedding import load_glove_table

            table = load_glove_table(embedding_file, word_index, embed_size,
                                     randomize_unknown=True, normalize=True)
            vocab_size, embed_size = table.shape
        else:
            vocab_size = int(vocab_size or ((max(word_index.values()) + 1)
                                            if word_index else 20000))
            table = None
        self._init_matcher(text1_length, vocab_size, embed_size, table,
                           train_embed, target_mode)
        self.text2_length = int(text2_length)
        self.kernel_num = int(kernel_num)
        self.sigma = float(sigma)
        self.exact_sigma = float(exact_sigma)

        inp = Input((self.text1_length + self.text2_length,), name="input")
        embedding = L.Embedding(self.vocab_size, self.embed_size,
                                weights=self.embed_weights,
                                trainable=self.train_embed,
                                init="uniform")(inp)
        phi = L.Lambda(self._kernel_pooling,
                       output_shape_fn=lambda s: (self.kernel_num,))(
                           embedding)
        out = L.Dense(1, init="uniform",
                      activation=None if target_mode == "ranking"
                      else "sigmoid")(phi)
        super().__init__(inp, out, name="knrm", device=device, seed=seed)
        mu, sig = _kernels(self.kernel_num, self.sigma, self.exact_sigma)
        self.register_buffer("kernel_mu", torch.from_numpy(mu).to(
            self.device), persistent=False)
        self.register_buffer("kernel_sigma", torch.from_numpy(sig).to(
            self.device), persistent=False)

    def _kernel_pooling(self, embed: torch.Tensor) -> torch.Tensor:
        """(B, Q+D, E) embeddings → Phi (B, K)."""
        t1 = self.text1_length
        q, d = embed[:, :t1], embed[:, t1:]
        mm = torch.einsum("bqe,bde->bqd", q, d)      # translation matrix
        diff = mm[..., None] - self.kernel_mu        # (B, Q, D, K)
        mm_exp = torch.exp(-0.5 * diff * diff
                           / (self.kernel_sigma * self.kernel_sigma))
        mm_doc_sum = mm_exp.sum(dim=2)               # soft-TF a query term
        return torch.log1p(mm_doc_sum).sum(dim=1)

    def constructor_config(self) -> dict:
        return dict(text1_length=self.text1_length,
                    text2_length=self.text2_length,
                    train_embed=self.train_embed, kernel_num=self.kernel_num,
                    sigma=self.sigma, exact_sigma=self.exact_sigma,
                    target_mode=self.target_mode, vocab_size=self.vocab_size,
                    embed_size=self.embed_size)

    def save_model(self, path: str):
        from ..common.zoo_model import save_model_bundle

        save_model_bundle(path, self, config=self.constructor_config())

    @classmethod
    def load_model(cls, path: str, *, device=None) -> "KNRM":
        from ..common.zoo_model import load_model_bundle

        model, _ = load_model_bundle(path, device=device)
        return model


__all__ = ["KNRM"]
