"""Attention / transformer layers (port of ``nn/layers/attention.py``).

Weights keep the JAX package's names and (in, out) layout: the fused QKV
projection is one ``qkv_kernel`` of shape (d, 3·hidden) computed as
``x @ W + b`` and reshaped to (B, T, 3, H, Dh), so a JAX param tree loads
without transposes (:mod:`analytics_zoo_tpu_torch.bridge`). The forward
keeps the JAX name ``apply``, which shadows ``nn.Module.apply(fn)``.

The forwards are differentiable: training runs them under autograd, with
the flash strategy going through ``FlashAttentionFunction`` (K1 forward,
K3 + K4 backward). ``TransformerLayer`` also exposes its two remat split
points, :meth:`~TransformerLayer.attn_qkv` (ln1 + fused QKV) and
:meth:`~TransformerLayer.attn_tail` (out-projection + residual + MLP), so a
caller can checkpoint each segment while the attention call between them
keeps its own saved tensors (``TransformerLM(remat="flash")``).

``TransformerLayer(dropout=rate)`` drops the attention block's output in
training mode (``train()``) when its ``apply`` is given a key, with the
JAX layer's mask: ``prng.bernoulli(fold_in(rng, 1), 1 - rate)``
(``layers.core.dropout``). ``TransformerLM`` builds its blocks without
dropout, as the JAX model does.

Not ported yet: ``PositionalEmbedding``, ``BERT`` and the mesh-sharded
strategies (``ring``, ``zigzag``, ``ulysses``; ROADMAP Queue 1, [9]).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...common import prng
from ...ops.attention import full_attention, prefer_flash_single_device
from ...ops.flash_attention import flash_attention
from ...ops.kv_cache import paged_write_multi
from ...ops.paged_attention import paged_attention
from ..activations import get_activation
from ..module import as_compute, glorot_uniform, zeros_init
from .core import dropout as _dropout
from .normalization import LayerNormalization

_STRATEGIES = ("auto", "full", "flash")


def _param(t: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(t.to(device))


class MultiHeadAttention(nn.Module):
    """Self-attention with fused QKV projection and strategy dispatch."""

    def __init__(self, hidden_size: int, n_head: int, causal: bool = False,
                 attn_strategy: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if hidden_size % n_head:
            raise ValueError(f"hidden_size {hidden_size} must divide into "
                             f"{n_head} heads")
        if attn_strategy not in _STRATEGIES:
            raise NotImplementedError(
                f"attn_strategy {attn_strategy!r}: only {_STRATEGIES} are "
                f"ported (the sequence-parallel strategies are ROADMAP "
                f"Queue 1, multi-GPU)")
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.head_dim = hidden_size // n_head
        self.causal = causal
        self.attn_strategy = attn_strategy
        g = generator if generator is not None else torch.Generator()
        self.qkv_kernel = _param(
            glorot_uniform(g, (hidden_size, 3 * hidden_size)), device)
        self.qkv_bias = _param(zeros_init((3 * hidden_size,)), device)
        self.out_kernel = _param(glorot_uniform(g, (hidden_size, hidden_size)),
                                 device)
        self.out_bias = _param(zeros_init((hidden_size,)), device)

    def qkv_fused(self, x: torch.Tensor) -> torch.Tensor:
        """Fused QKV projection → one (B, T, 3, n_head, head_dim) tensor."""
        b, t, _ = x.shape
        qkv = x @ self.qkv_kernel.to(x.dtype) + self.qkv_bias.to(x.dtype)
        return qkv.reshape(b, t, 3, self.n_head, self.head_dim)

    def qkv_proj(self, x: torch.Tensor):
        """Fused QKV projection → (q, k, v), each a (B, T, n_head, head_dim)
        view into one (B, T, 3, H, Dh) tensor."""
        qkv = self.qkv_fused(x)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def out_proj(self, o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, T, n_head, head_dim) attention output → (B, T, hidden)."""
        b, t = o.shape[:2]
        o = o.reshape(b, t, self.hidden_size)
        return o @ self.out_kernel.to(dtype) + self.out_bias.to(dtype)

    def _attend(self, q, k, v, t: int):
        """Strategy dispatch: (B, T, n_head, head_dim) q/k/v → output of
        the same shape."""
        if self._flash_single_device(t, q.device):
            return flash_attention(q, k, v, self.causal)
        return full_attention(q, k, v, causal=self.causal)

    def _flash_single_device(self, t: int, device) -> bool:
        if t <= 1:
            return False
        if self.attn_strategy == "flash":
            return True
        if self.attn_strategy == "auto":
            return prefer_flash_single_device(t, device)
        return False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        x = as_compute(x)
        q, k, v = self.qkv_proj(x)
        return self.out_proj(self._attend(q, k, v, x.shape[1]), x.dtype)

    def apply_with_kv(self, x: torch.Tensor):
        """Forward that also returns the projected K/V (the prefill path).
        Returns ``(out, k, v)``."""
        x = as_compute(x)
        q, k, v = self.qkv_proj(x)
        o = self._attend(q, k, v, x.shape[1])
        return self.out_proj(o, x.dtype), k, v


class TransformerLayer(nn.Module):
    """One pre-LN transformer block: MHA + MLP with residuals."""

    def __init__(self, hidden_size: int, n_head: int,
                 intermediate_size: Optional[int] = None,
                 causal: bool = False, activation="gelu",
                 dropout: float = 0.0, attn_strategy: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dropout = float(dropout)
        self.hidden_size = hidden_size
        self.intermediate = intermediate_size or 4 * hidden_size
        self.activation = get_activation(activation)
        g = generator if generator is not None else torch.Generator()
        self.attn = MultiHeadAttention(hidden_size, n_head, causal=causal,
                                       attn_strategy=attn_strategy,
                                       generator=g, device=device)
        self.ln1 = LayerNormalization(hidden_size, device=device)
        self.ln2 = LayerNormalization(hidden_size, device=device)
        self.mlp_up_kernel = _param(
            glorot_uniform(g, (hidden_size, self.intermediate)), device)
        self.mlp_up_bias = _param(zeros_init((self.intermediate,)), device)
        self.mlp_down_kernel = _param(
            glorot_uniform(g, (self.intermediate, hidden_size)), device)
        self.mlp_down_bias = _param(zeros_init((hidden_size,)), device)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        """ln2 + MLP + residual — the block tail shared by every path."""
        h = self.ln2(x)
        h = h @ self.mlp_up_kernel.to(x.dtype) + self.mlp_up_bias.to(x.dtype)
        h = self.activation(h)
        h = (h @ self.mlp_down_kernel.to(x.dtype)
             + self.mlp_down_bias.to(x.dtype))
        return x + h

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        return self.apply(x, rng=rng)

    def apply(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        """The block; in training mode with a ``dropout`` rate and a key,
        the attention output is dropped with ``fold_in(rng, 1)``'s mask
        before the residual (the JAX layer has no dropout without a
        key)."""
        x = as_compute(x)
        a = self.attn.apply(self.ln1(x))
        if self.training and self.dropout > 0 and rng is not None:
            a = _dropout(a, self.dropout, prng.fold_in(rng, 1))
        x = x + a
        return self._mlp(x)

    def attn_qkv(self, x: torch.Tensor) -> torch.Tensor:
        """Remat split point 1: ln1 + the fused QKV projection, as one
        (B, T, 3, n_head, head_dim) tensor."""
        return self.attn.qkv_fused(self.ln1(as_compute(x)))

    def attend(self, qkv: torch.Tensor) -> torch.Tensor:
        """The attention call between the split points."""
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        return self.attn._attend(q, k, v, qkv.shape[1])

    def attn_tail(self, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """Remat split point 2: out-projection + residual + ln2/MLP."""
        x = as_compute(x)
        return self._mlp(x + self.attn.out_proj(o, x.dtype))

    def apply_with_kv(self, x: torch.Tensor):
        """Prefill forward: the ``apply`` computation that also returns this
        block's projected K/V, each (B, T, n_head, head_dim)."""
        x = as_compute(x)
        a, k, v = self.attn.apply_with_kv(self.ln1(x))
        x = x + a
        return self._mlp(x), k, v

    def decode_step(self, x, k_pages, v_pages, table, pos, *, page_size: int):
        """One cache-threaded decode step for this block. ``x``: (B, 1,
        hidden); ``k_pages``/``v_pages``: this LAYER's (P, page_size, H, D)
        pool, written in place; ``table``: (B, pages_per_slot) int32;
        ``pos``: (B,) int32 — the position being decoded. Returns
        ``(x_out, k_pages, v_pages)``."""
        return self._cached_step(x, k_pages, v_pages, table, pos,
                                 page_size=page_size, in_table=True)

    def verify_step(self, x, k_pages, v_pages, table, pos, *,
                    page_size: int, in_table: bool = False):
        """The multi-token twin of :meth:`decode_step` (the speculative
        verify step and prefill chunks): ``x``: (B, q_len, hidden); ``pos``:
        (B,) — the FIRST position written; token i lands at ``pos + i`` and
        attends causally to itself, the earlier new tokens and the cached
        prefix. Writes past the table are dropped (``in_table=True``: the
        caller guarantees there are none)."""
        return self._cached_step(x, k_pages, v_pages, table, pos,
                                 page_size=page_size, in_table=in_table)

    def _cached_step(self, x, k_pages, v_pages, table, pos, *,
                     page_size: int, in_table: bool):
        """Write the q_len new tokens' K/V into the paged pool FIRST, then
        attend (so each token sees itself): the lengths handed to the
        kernel include the new tokens, ``pos + q_len``."""
        x = as_compute(x)
        q_len = x.shape[1]
        q, k, v = self.attn.qkv_proj(self.ln1(x))          # (B, q_len, H, D)
        for pages, new in ((k_pages, k), (v_pages, v)):
            paged_write_multi(pages, table, pos, new, page_size=page_size,
                              in_table=in_table)
        lengths = (pos + q_len).to(torch.int32)
        o = paged_attention(q, k_pages, v_pages, table, lengths,
                            page_size=page_size)
        x = x + self.attn.out_proj(o, x.dtype)
        return self._mlp(x), k_pages, v_pages


__all__ = ["MultiHeadAttention", "TransformerLayer"]
