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

Under a runtime context whose mesh is set (``init_zoo_context``), every
strategy but ``"full"`` dispatches through
``ops/attention.py::sharded_attention``: the sequence-parallel ``ring``,
``zigzag`` and ``ulysses`` over the mesh's ``sp`` axis, single-device
attention where ``sp`` is 1, as the JAX layer does.

Tensor parallelism (Megatron-style over the mesh's ``tp`` axis): the
Estimator puts a layer in tp mode (``tp_mesh``) when it placed the layer's
leaves over ``tp`` (``parallel/placement.py``, ``tp_compute_dims``). A
rank then holds and attends over its own ``n_head / tp`` heads:
``qkv_kernel`` and ``mlp_up_kernel`` are column-parallel (their input
through ``comm.copy_to``; the QKV columns in
``parallel.sharding.qkv_tp_permutation``'s order, so a rank's block holds
its heads' q, k and v), ``out_kernel`` and ``mlp_down_kernel`` are
row-parallel (their output through ``comm.reduce_from``, the bias added
after the reduction). Under ``sp`` the attention strategy sees the local
heads (Ulysses needs them to divide by ``sp``).

``PositionalEmbedding``, ``MultiHeadAttention``, ``TransformerLayer`` and
``BERT`` are graph layers (``build(input_shape, gen)``,
``compute_output_shape``, a ``name``): a ``Sequential`` or a ``Model``
holds them under their slot keys, with the JAX tree's parameter names
below the slot. ``BERT`` has two outputs, ``(sequence, pooled)``: its
graph node's value is the pair and its shape the pair of shapes, as in
the JAX graph.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...common import prng
from ...parallel import comm
from ...parallel.sharding import qkv_tp_permutation
from ...ops.attention import (STRATEGIES, full_attention,
                              prefer_flash_single_device, sharded_attention)
from ...ops.flash_attention import flash_attention
from ...ops.kv_cache import paged_write_multi
from ...ops.paged_attention import paged_attention
from ..activations import get_activation
from ..module import (Layer, as_compute, embedding_normal, glorot_uniform,
                      split_rng, zeros_init)
from .core import dropout as _dropout
from .normalization import LayerNormalization



def _build_now(layer: Layer, generator, device) -> None:
    """Draw a layer's weights at construction (the standalone form,
    :class:`MultiHeadAttention`): for an input of width ``hidden_size``
    (``input_shape``'s last dim when given), moved to ``device``. Given a
    generator or a device the layer is built; else it stays unbuilt and a
    container that takes it builds it anew."""
    shape = layer.input_shape_hint or (layer.hidden_size,)
    layer.build(shape, generator if generator is not None
                else torch.Generator())
    layer.to(device)
    layer.built = generator is not None or device is not None


def _tp_size(module) -> int:
    """The tp axis's size when ``module`` computes in tp mode, else 1."""
    mesh = module.tp_mesh
    return 1 if mesh is None else mesh.shape["tp"]


def _tp_copy(module, x: torch.Tensor) -> torch.Tensor:
    """A column-parallel projection's input: the identity, whose backward
    sums the tp ranks' partial gradients (tp mode only)."""
    mesh = module.tp_mesh
    return x if mesh is None else comm.copy_to(x, "tp", mesh=mesh)


def _tp_reduce(module, y: torch.Tensor) -> torch.Tensor:
    """A row-parallel projection's output: the sum of the tp ranks'
    partials (tp mode only)."""
    mesh = module.tp_mesh
    return y if mesh is None else comm.reduce_from(y, "tp", mesh=mesh)


def _context_mesh():
    """The initialised runtime context's mesh, else None."""
    from ...common.context import get_zoo_context

    try:
        return get_zoo_context(auto_init=False).mesh
    except RuntimeError:
        return None


class PositionalEmbedding(Layer):
    """Learned position embeddings added to the input: ``x +
    pos_embeddings[:T]`` (a (max_len, dim) table, normal·0.02)."""

    def __init__(self, max_len: int, dim: int, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.max_len = int(max_len)
        self.dim = int(dim)

    def build(self, input_shape, gen: torch.Generator) -> None:
        self.pos_embeddings = nn.Parameter(
            embedding_normal(gen, (self.max_len, self.dim)))
        self.built = True

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pos_embeddings[:x.shape[1]].to(x.dtype)


class MultiHeadAttention(Layer):
    """Self-attention with fused QKV projection and strategy dispatch.

    A graph layer (``build(input_shape, gen)``: ``qkv_kernel`` is (d,
    3·hidden) for an input of width d) that also stands alone: made
    outside a container it draws its weights at once for an input of
    width ``hidden_size`` (``input_shape``'s last dim when given), from
    ``generator`` on ``device``. Without either it draws from a fresh
    CPU generator and stays unbuilt, so a Sequential or a Model that
    takes it draws it anew from its own generator for its input shape;
    ``lazy=True`` draws nothing until ``build``."""

    #: the mesh whose ``tp`` axis this layer computes over (module
    #: docstring); None: the whole layer on every rank
    tp_mesh = None

    def __init__(self, hidden_size: int, n_head: int, causal: bool = False,
                 attn_strategy: str = "auto", name=None, input_shape=None, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 lazy: bool = False):
        super().__init__(name=name, input_shape=input_shape)
        if hidden_size % n_head:
            raise ValueError(f"hidden_size {hidden_size} must divide into "
                             f"{n_head} heads")
        if attn_strategy not in STRATEGIES:
            raise ValueError(f"unknown attention strategy {attn_strategy!r};"
                             f" known: {', '.join(STRATEGIES)}")
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.head_dim = hidden_size // n_head
        self.causal = causal
        self.attn_strategy = attn_strategy
        if not lazy:
            _build_now(self, generator, device)

    def build(self, input_shape, gen: torch.Generator) -> None:
        d, h = input_shape[-1], self.hidden_size
        self.qkv_kernel = nn.Parameter(glorot_uniform(gen, (d, 3 * h)))
        self.qkv_bias = nn.Parameter(zeros_init((3 * h,)))
        self.out_kernel = nn.Parameter(glorot_uniform(gen, (h, h)))
        self.out_bias = nn.Parameter(zeros_init((h,)))
        self.built = True

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.hidden_size,)

    def tp_compute_dims(self, tp: int):
        """The dims this layer splits over tp: QKV column-parallel in
        :func:`~...parallel.sharding.qkv_tp_permutation`'s order, the
        out-projection row-parallel."""
        perm = qkv_tp_permutation(self.hidden_size, self.n_head, tp)
        return {"qkv_kernel": (1, perm), "qkv_bias": (0, perm),
                "out_kernel": (0, None)}

    def qkv_fused(self, x: torch.Tensor) -> torch.Tensor:
        """Fused QKV projection → one (B, T, 3, heads, head_dim) tensor
        (this rank's ``n_head / tp`` heads in tp mode)."""
        b, t, _ = x.shape
        x = _tp_copy(self, x)
        qkv = x @ self.qkv_kernel.to(x.dtype) + self.qkv_bias.to(x.dtype)
        return qkv.reshape(b, t, 3, self.n_head // _tp_size(self),
                           self.head_dim)

    def qkv_proj(self, x: torch.Tensor):
        """Fused QKV projection → (q, k, v), each a (B, T, n_head, head_dim)
        view into one (B, T, 3, H, Dh) tensor."""
        qkv = self.qkv_fused(x)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def out_proj(self, o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, T, heads, head_dim) attention output → (B, T, hidden)."""
        b, t = o.shape[:2]
        o = o.reshape(b, t, -1)
        return (_tp_reduce(self, o @ self.out_kernel.to(dtype))
                + self.out_bias.to(dtype))

    def _attend(self, q, k, v, t: int):
        """Strategy dispatch: (B, T, n_head, head_dim) q/k/v → output of
        the same shape."""
        mesh = _context_mesh()
        if mesh is not None and self.attn_strategy != "full":
            return sharded_attention(q, k, v, mesh,
                                     strategy=self.attn_strategy,
                                     causal=self.causal)
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


class TransformerLayer(Layer):
    """One pre-LN transformer block: MHA + MLP with residuals. Made and
    built as :class:`MultiHeadAttention` is (``generator``, ``device``,
    ``lazy``); its draws are the attention's, then ``mlp_up_kernel`` and
    ``mlp_down_kernel``."""

    #: as :attr:`MultiHeadAttention.tp_mesh`, for the MLP
    tp_mesh = None
    takes_rng = True

    def __init__(self, hidden_size: int, n_head: int,
                 intermediate_size: Optional[int] = None,
                 causal: bool = False, activation="gelu",
                 dropout: float = 0.0, attn_strategy: str = "auto",
                 name=None, input_shape=None, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 lazy: bool = False):
        super().__init__(name=name, input_shape=input_shape)
        self.dropout = float(dropout)
        self.hidden_size = hidden_size
        self.intermediate = intermediate_size or 4 * hidden_size
        self.activation = get_activation(activation)
        self.attn = MultiHeadAttention(hidden_size, n_head, causal=causal,
                                       attn_strategy=attn_strategy,
                                       name=f"{self.name}_attn", lazy=True)
        self.ln1 = LayerNormalization(name=f"{self.name}_ln1")
        self.ln2 = LayerNormalization(name=f"{self.name}_ln2")
        if not lazy:
            _build_now(self, generator, device)

    def build(self, input_shape, gen: torch.Generator) -> None:
        d = input_shape[-1]
        for sub in (self.attn, self.ln1, self.ln2):
            sub.build(input_shape, gen)
        self.mlp_up_kernel = nn.Parameter(
            glorot_uniform(gen, (d, self.intermediate)))
        self.mlp_up_bias = nn.Parameter(zeros_init((self.intermediate,)))
        self.mlp_down_kernel = nn.Parameter(
            glorot_uniform(gen, (self.intermediate, self.hidden_size)))
        self.mlp_down_bias = nn.Parameter(zeros_init((self.hidden_size,)))
        self.built = True

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.hidden_size,)

    def tp_compute_dims(self, tp: int):
        """The MLP's dims over tp: up column-parallel, down row-parallel."""
        return {"mlp_up_kernel": (1, None), "mlp_up_bias": (0, None),
                "mlp_down_kernel": (0, None)}

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        """ln2 + MLP + residual — the block tail shared by every path."""
        h = _tp_copy(self, self.ln2(x))
        h = h @ self.mlp_up_kernel.to(x.dtype) + self.mlp_up_bias.to(x.dtype)
        h = self.activation(h)
        h = (_tp_reduce(self, h @ self.mlp_down_kernel.to(x.dtype))
             + self.mlp_down_bias.to(x.dtype))
        return x + h

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


class BERT(Layer):
    """BERT encoder: token + position + segment embeddings, ``n_block``
    blocks without a causal mask (and no padding mask, as in the JAX
    layer), a final LayerNorm and the pooler. Input ``ids`` (B, T) or
    ``[ids, segment_ids]``; output ``(sequence (B, T, hidden), pooled (B,
    hidden))`` with ``pooled = tanh(h[:, 0] @ pooler_kernel +
    pooler_bias)``. Parameters keep the JAX tree: ``token_embeddings``,
    ``pos_embeddings``, ``segment_embeddings``, ``block{i}``, ``ln_f``,
    ``pooler_kernel``, ``pooler_bias``; ``build`` draws them in that
    order. Attention dispatches as :class:`MultiHeadAttention` does: K1
    on CUDA (K3/K4 in its backward), plain attention on the CPU."""

    takes_rng = True

    def __init__(self, vocab: int, hidden_size: int = 768, n_block: int = 12,
                 n_head: int = 12, seq_len: int = 512,
                 intermediate_size: int = 3072, attn_strategy: str = "auto",
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.vocab = vocab
        self.hidden_size = hidden_size
        self.n_block = n_block
        self.seq_len = seq_len
        self.blocks = []
        for i in range(n_block):
            blk = TransformerLayer(hidden_size, n_head, intermediate_size,
                                   causal=False, attn_strategy=attn_strategy,
                                   name=f"{self.name}_block{i}", lazy=True)
            self.add_module(f"block{i}", blk)
            self.blocks.append(blk)
        self.ln_f = LayerNormalization(name=f"{self.name}_lnf")

    def build(self, input_shape, gen: torch.Generator) -> None:
        h = self.hidden_size
        self.token_embeddings = nn.Parameter(
            embedding_normal(gen, (self.vocab, h)))
        self.pos_embeddings = nn.Parameter(
            embedding_normal(gen, (self.seq_len, h)))
        self.segment_embeddings = nn.Parameter(embedding_normal(gen, (2, h)))
        for blk in self.blocks:
            blk.build((h,), gen)
        self.ln_f.build((h,), gen)
        self.pooler_kernel = nn.Parameter(glorot_uniform(gen, (h, h)))
        self.pooler_bias = nn.Parameter(zeros_init((h,)))
        self.built = True

    def apply(self, x, rng=None):
        ids, segs = x if isinstance(x, (list, tuple)) else (x, None)
        dev = self.token_embeddings.device
        ids = torch.as_tensor(ids, device=dev).long()
        h = F.embedding(ids, self.token_embeddings)
        h = h + self.pos_embeddings[:ids.shape[1]][None]
        if segs is not None:
            h = h + F.embedding(torch.as_tensor(segs, device=dev).long(),
                                self.segment_embeddings)
        h = as_compute(h)
        for blk, key in zip(self.blocks, split_rng(rng, self.n_block)):
            h = blk.apply(h, rng=key)
        h = self.ln_f(h)
        pooled = torch.tanh(h[:, 0] @ self.pooler_kernel.to(h.dtype)
                            + self.pooler_bias.to(h.dtype))
        return h, pooled

    def compute_output_shape(self, input_shape):
        """``[(T, hidden), (hidden,)]``; T is the first input's length
        (``seq_len`` without a shape)."""
        if input_shape and isinstance(input_shape[0], (tuple, list)):
            input_shape = input_shape[0]
        t = input_shape[0] if input_shape else self.seq_len
        return [(t, self.hidden_size), (self.hidden_size,)]


__all__ = ["BERT", "MultiHeadAttention", "PositionalEmbedding",
           "TransformerLayer"]
