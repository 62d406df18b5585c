"""TransformerLM (port of ``analytics_zoo_tpu/models/transformer.py``).

A decoder-only transformer over int token ids (B, T) → logits (B, T, V),
with the cache-threaded serving steps ``prefill``, ``decode_step``,
``verify_step`` (speculative), ``prefill_chunk`` and ``prefill_from``
(chunked prefill, and prefill from a shared-prefix hit) over the paged KV
cache. Parameters live in the module, named as in the JAX
param tree (``token_embeddings``, ``block0.attn.qkv_kernel``, ``ln_f.gamma``,
...), so ``model.load_state_dict(bridge.params_from_jax(tree))`` loads a JAX
model's weights. The JAX methods take ``params`` first; here the module's
own parameters are used and the remaining arguments are the same. Like the
layers, the model keeps the JAX method name ``apply`` for its forward,
which shadows ``nn.Module.apply(fn)``; as a :class:`KerasNet` it also keeps
``compile``/``fit``/``predict``, and ``compile`` shadows
``nn.Module.compile``.

``apply`` and ``apply_features`` are differentiable: training runs them
through the Estimator (``model.compile(optimizer="adam", loss=lm_loss);
model.fit(x, y, batch_size, nb_epoch)``). The serving steps stay under
``torch.no_grad``. Remat modes: ``False`` keeps every activation;
``"full"`` checkpoints each block whole, so K1 runs again in backward;
``True``/``"flash"`` checkpoints the ln1+QKV segment and the
out-projection+MLP segment of each block separately and keeps the flash
call between them, whose Function holds its own ``(q, k, v, out, lse)`` —
K1 never runs again in backward (the guarantee of the JAX
``FLASH_REMAT_POLICY``; unlike it, q/k/v stay saved rather than being
recomputed from the block input). ``"dots"`` is ``"flash"`` with the
outputs of the plain matmuls (``aten.mm``/``addmm``: the projections and
the MLP, the JAX ``dots_with_no_batch_dims_saveable``) saved through
``torch.utils.checkpoint``'s selective policy, so backward recomputes
only the layer norms, activations and adds; K1 never runs again either.

``prefill_chunk`` looks its padding rows' positions up at most at the
last row of the position table: the JAX package's lookup fills NaN past
it, which reaches the chunk's valid rows through the scratch page (0·NaN);
the valid rows, all below ``max_seq_len <= seq_len``, are unchanged.

Under ``tp`` (the Estimator places ``TP_RULES``' leaves, ``parallel/
placement.py``) the blocks run Megatron-style (``nn/layers/attention.py``)
and the embeddings and head are vocab-parallel: ``token_embeddings``'
rows are looked up by their owners and summed (``parallel/
embedding_sharding.py``'s replicated-batch exchange), the position table
is gathered where it is read, and ``logits_kernel`` gives each rank its
vocab columns. In training the Estimator takes the loss through
:meth:`TransformerLM.sharded_loss`: :func:`vocab_parallel_lm_loss`,
Megatron's vocab-parallel cross entropy, so no rank holds ``(B, T,
vocab)`` logits; ``apply`` (``predict``, ``evaluate``) returns whole
logits through ``comm.gather_along``. The serving steps are not tp-aware:
serve a tp-trained model from its gathered checkpoint.

:class:`PipelinedTransformerLM` is the ``pp`` strategy: its blocks'
parameters are stacked on a leading ``(n_block, ...)`` axis under
``blocks.*`` (one block module's structure, the JAX ``params["blocks"]``),
and under a runtime context with ``pp > 1`` its blocks run as a GPipe
pipeline (``parallel/pipeline.py``); off a pp mesh it applies them in
turn, so one checkpoint serves both layouts.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..nn.layers.attention import TransformerLayer
from ..nn.layers.normalization import LayerNormalization
from ..nn.module import (as_compute, compute_dtype, embedding_normal,
                         glorot_uniform, precision_policy, resolve_device)
from ..nn.topology import KerasNet
from ..ops.kv_cache import (KVCacheConfig, _host_list, init_cache,
                            prefill_write, sample_tokens)
from ..ops.speculative import verify_draft_tokens

_REMAT_MODES = (False, "flash", "full", "dots")

#: what remat "dots" saves: the outputs of matmuls with no batch dims
_DOT_OPS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _checkpointed(fn, *args, save_dots: bool = False):
    """``torch.utils.checkpoint`` of ``fn`` with the compute dtype of this
    forward pinned for its recompute in backward; ``save_dots``: keep the
    plain matmuls' outputs instead of recomputing them."""
    dt = compute_dtype()

    def seg(*a):
        with precision_policy(compute_dtype=dt):
            return fn(*a)

    kw = {}
    if save_dots:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOT_OPS)
    return checkpoint(seg, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


class TransformerLM(KerasNet, nn.Module):
    """Decoder-only LM. ``device``: where the weights live — CUDA unless
    the caller names another device; raises when CUDA is absent and no
    device is given. ``seed`` draws the initial weights (normal·0.02
    embeddings, glorot-uniform kernels, zero biases) from a CPU generator,
    so a seed gives the same weights on every device. ``remat``: False,
    True/"flash", "full" or "dots" (module docstring)."""

    #: the mesh whose ``tp`` axis the vocab is split over (module
    #: docstring), or None
    tp_mesh = None

    def __init__(self, vocab: int, hidden_size: int = 256, n_block: int = 4,
                 n_head: int = 8, seq_len: int = 512,
                 intermediate_size: Optional[int] = None,
                 attn_strategy: str = "auto", remat=False, *,
                 device=None, seed: int = 0):
        super().__init__()
        remat = "flash" if remat is True else remat
        if remat not in _REMAT_MODES:
            raise ValueError(f"unknown remat mode {remat!r}; known: False, "
                             f"True/'flash', 'full', 'dots'")
        self.remat = remat
        self.device = resolve_device(device)
        self.vocab = vocab
        self.hidden_size = hidden_size
        self.n_block = n_block
        self.seq_len = seq_len
        self.intermediate_size = intermediate_size
        self.attn_strategy = attn_strategy
        g = torch.Generator().manual_seed(int(seed))
        dev = self.device
        self.token_embeddings = nn.Parameter(
            embedding_normal(g, (vocab, hidden_size)).to(dev))
        self.pos_embeddings = nn.Parameter(
            embedding_normal(g, (seq_len, hidden_size)).to(dev))
        self.logits_kernel = nn.Parameter(
            glorot_uniform(g, (hidden_size, vocab)).to(dev))
        self.blocks = []
        for i in range(n_block):
            blk = TransformerLayer(hidden_size, n_head, intermediate_size,
                                   causal=True, attn_strategy=attn_strategy,
                                   generator=g, device=dev)
            self.add_module(f"block{i}", blk)
            self.blocks.append(blk)
        self.ln_f = LayerNormalization(dim=hidden_size, device=dev)

    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).long()

    def _i32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(torch.int32)

    def tp_compute_dims(self, tp: int):
        """Vocab-parallel embedding rows and head columns."""
        return {"token_embeddings": (0, None), "logits_kernel": (1, None)}

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp_mesh is None:
            return self.token_embeddings[ids]
        from ..parallel.embedding_sharding import sharded_gather

        return sharded_gather(self.token_embeddings, ids, self.tp_mesh, "tp",
                              shard_batch=False)

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        """Logits; in tp mode this rank's vocab columns."""
        if self.tp_mesh is not None:
            from ..parallel import comm

            h = comm.copy_to(h, "tp", mesh=self.tp_mesh)
        return h @ self.logits_kernel.to(h.dtype)

    def _block(self, blk: TransformerLayer, h: torch.Tensor) -> torch.Tensor:
        if not self.remat or not torch.is_grad_enabled():
            return blk.apply(h)
        if self.remat == "full":
            return _checkpointed(blk.apply, h)
        # "flash"/"dots": the attention call sits between two checkpointed
        # segments, so its saved (q, k, v, out, lse) survive and backward
        # goes straight to K3 + K4
        dots = self.remat == "dots"
        qkv = _checkpointed(blk.attn_qkv, h, save_dots=dots)
        return _checkpointed(blk.attn_tail, h, blk.attend(qkv),
                             save_dots=dots)

    def apply_features(self, x) -> torch.Tensor:
        """Hidden states before the LM head: (B, T, hidden). Pair with
        :func:`~analytics_zoo_tpu_torch.ops.fused_ce.fused_softmax_xent`
        to train without the (B, T, vocab) logits."""
        ids = self._ids(x)
        h = self._embed(ids) + self.pos_embeddings[:ids.shape[1]][None]
        h = as_compute(h)
        for blk in self.blocks:
            h = self._block(blk, h)
        return self.ln_f(h)

    def apply(self, x) -> torch.Tensor:
        """Logits (B, T, vocab) in the compute dtype (whole on every rank
        in tp mode)."""
        logits = self._head(self.apply_features(x))
        if self.tp_mesh is not None:
            from ..parallel import comm

            logits = comm.gather_along(logits, "tp", logits.dim() - 1,
                                       mesh=self.tp_mesh)
        return logits

    def sharded_loss(self, loss_fn):
        """The Estimator's loss in tp mode with :func:`lm_loss`: ``(x, y)
        -> loss`` over this rank's vocab columns
        (:func:`vocab_parallel_lm_loss`); else None (the loss of whole
        logits)."""
        if self.tp_mesh is None or loss_fn is not lm_loss:
            return None
        mesh = self.tp_mesh
        return lambda x, y: vocab_parallel_lm_loss(
            y, self._head(self.apply_features(x)), mesh)

    def forward(self, x) -> torch.Tensor:
        return self.apply(x)

    # -------------------------------------------------------- decode serving

    def init_kv_cache(self, n_slots: int, *, page_size: int = 16,
                      max_seq_len: Optional[int] = None,
                      n_pages: Optional[int] = None, dtype=None
                      ) -> Tuple[KVCacheConfig, Dict[str, torch.Tensor]]:
        """Build a paged KV cache for ``n_slots`` concurrent sequences on
        the model's device. Returns ``(KVCacheConfig, {"k", "v"})``."""
        max_seq = int(max_seq_len or self.seq_len)
        pps = -(-max_seq // page_size)          # ceil: full pages only
        if pps * page_size > self.seq_len:
            # the rounded capacity is what decode positions can reach;
            # positions past the table would index past the embeddings
            raise ValueError(
                f"max_seq_len {max_seq} rounds up to {pps * page_size} "
                f"(full pages of {page_size}), exceeding the model's "
                f"position table ({self.seq_len}); choose max_seq_len <= "
                f"{self.seq_len // page_size * page_size}")
        attn = self.blocks[0].attn
        cfg = KVCacheConfig(
            n_layers=self.n_block, n_heads=attn.n_head,
            head_dim=attn.head_dim, n_slots=n_slots, page_size=page_size,
            pages_per_slot=pps, n_pages=n_pages,
            dtype=dtype or compute_dtype())
        return cfg, init_cache(cfg, self.device)

    @torch.no_grad()
    def prefill(self, cache, ids, lengths, table, *, page_size: int):
        """One batched forward that fills the cache (in place) and returns
        last-token logits.

        ``ids``: (B, T_bucket) right-padded to a bucket that is a multiple
        of ``page_size``; ``lengths``: (B,) true prompt lengths; ``table``:
        (B, pages_per_slot) page tables (entries past the allocated prefix
        = scratch). Returns ``(logits (B, V) f32 at position length-1,
        cache)``."""
        ids = self._ids(ids)
        lengths = self._ids(lengths)
        table = self._i32(table)
        h = self.token_embeddings[ids] + self.pos_embeddings[:ids.shape[1]][None]
        h = as_compute(h)
        for i, blk in enumerate(self.blocks):
            h, k, v = blk.apply_with_kv(h)
            prefill_write(cache["k"][i], table, k, page_size=page_size)
            prefill_write(cache["v"][i], table, v, page_size=page_size)
        h = self.ln_f(h)
        last = h[torch.arange(h.shape[0], device=h.device),
                 (lengths - 1).clamp_min(0)]                  # (B, hidden)
        return self._head(last).float(), cache

    @torch.no_grad()
    def decode_step(self, cache, ids, lengths, table, seeds, token_idx,
                    temperature, *, page_size: int, top_k: int = 0):
        """One fixed-shape decode step over every slot.

        ``ids``: (B,) the token sampled by the previous step; ``lengths``:
        (B,) tokens already cached (the position ``ids`` occupies);
        ``seeds``/``token_idx``/``temperature``: (B,) per-request sampling
        state (:func:`~analytics_zoo_tpu_torch.ops.kv_cache.sample_tokens`).
        Returns ``(next_ids (B,) int32, logits (B, V) f32, cache)``."""
        ids = self._ids(ids)
        pos = self._i32(lengths)
        table = self._i32(table)
        h = (self.token_embeddings[ids]
             + self.pos_embeddings[pos.long()])[:, None]
        h = as_compute(h)
        for i, blk in enumerate(self.blocks):
            h, _, _ = blk.decode_step(h, cache["k"][i], cache["v"][i], table,
                                      pos, page_size=page_size)
        h = self.ln_f(h)
        logits = self._head(h[:, 0]).float()
        next_ids = sample_tokens(logits, seeds, token_idx, temperature,
                                 top_k=top_k)
        return next_ids, logits, cache

    @torch.no_grad()
    def prefill_from(self, cache, ids, start, lengths, table, *,
                     page_size: int):
        """Suffix prefill from the divergence point of a shared-prefix hit:
        ``ids`` (B, T_bucket) are the suffix tokens at positions ``start ..
        start + T_bucket - 1``; ``start``: (B,) the first position to
        compute (everything below it is cached, on shared pages);
        ``lengths``: (B,) the TOTAL true prompt length. The bucket's padding
        may reach past the table; those writes are dropped. Returns
        ``(logits (B, V) f32 at position lengths - 1, cache)``."""
        start = np.asarray(_host_list(start), np.int64)
        lengths = np.asarray(_host_list(lengths), np.int64)
        return self.prefill_chunk(cache, ids, start, lengths - start, table,
                                  page_size=page_size)

    @torch.no_grad()
    def prefill_chunk(self, cache, ids, n_done, n_valid, table, *,
                      page_size: int):
        """One prefill chunk against a cache that already holds ``n_done``
        tokens of the same prompt (in place): ``ids`` (B, chunk) are the
        tokens at positions ``n_done .. n_done + chunk - 1``, right-padded
        past ``n_valid`` (B,) true tokens; ``table`` must cover every
        position the chunk's true tokens write (padding past the table is
        dropped; entries past the allocated pages are scratch). Returns
        ``(logits (B, V) f32 at position n_done + n_valid - 1, cache)``."""
        ids = self._ids(ids)
        n_done_host = np.asarray(_host_list(n_done), np.int64)
        n_valid = self._ids(n_valid)
        table = self._i32(table)
        t = ids.shape[1]
        in_table = int(n_done_host.max()) + t <= table.shape[1] * page_size
        n_done = self._i32(n_done_host)
        positions = n_done.long()[:, None] + torch.arange(
            t, device=self.device)[None]
        # padding rows past the position table read its last row (the JAX
        # lookup fills NaN there); true tokens never reach it
        h = (self.token_embeddings[ids]
             + self.pos_embeddings[positions.clamp(max=self.seq_len - 1)])
        h = as_compute(h)
        for i, blk in enumerate(self.blocks):
            h, _, _ = blk.verify_step(h, cache["k"][i], cache["v"][i], table,
                                      n_done, page_size=page_size,
                                      in_table=in_table)
        h = self.ln_f(h)
        last = h[torch.arange(h.shape[0], device=h.device),
                 (n_valid - 1).clamp_min(0)]                   # (B, hidden)
        return self._head(last).float(), cache

    @torch.no_grad()
    def verify_step(self, cache, ids, lengths, table, seeds, token_idx,
                    temperature, *, page_size: int, top_k: int = 0):
        """One speculative verify step: score ``k`` tokens per slot in one
        dispatch (K2 at q_len k). ``ids``: (B, k) — column 0 the previous
        step's sampled token, columns 1.. the drafts — at positions
        ``lengths .. lengths + k - 1`` (pages allocated through the last);
        ``token_idx``: (B,) the ordinal of the FIRST token this step emits.
        Returns ``(accepted (B,) int32, tokens (B, k) int32, draft_probs
        (B, k-1) f32, cache)``: ``tokens[:, :accepted+1]`` are the emitted
        tokens (:func:`~analytics_zoo_tpu_torch.ops.speculative.
        verify_draft_tokens`)."""
        ids = self._ids(ids)
        pos = self._i32(lengths)
        table = self._i32(table)
        k = ids.shape[1]
        positions = pos.long()[:, None] + torch.arange(
            k, device=self.device)[None]
        h = self.token_embeddings[ids] + self.pos_embeddings[positions]
        h = as_compute(h)
        for i, blk in enumerate(self.blocks):
            h, _, _ = blk.verify_step(h, cache["k"][i], cache["v"][i], table,
                                      pos, page_size=page_size, in_table=True)
        logits = self._head(self.ln_f(h)).float()               # (B, k, V)
        accepted, tokens, draft_probs = verify_draft_tokens(
            logits, ids[:, 1:], seeds, token_idx, temperature, top_k=top_k)
        return accepted, tokens, draft_probs, cache


def _pp_mesh():
    """The initialised context's mesh and its pp size when above 1, else
    ``(None, 1)``."""
    from ..common.context import get_zoo_context

    try:
        mesh = get_zoo_context(auto_init=False).mesh
    except RuntimeError:
        return None, 1
    pp = mesh.shape.get("pp", 1) if mesh is not None else 1
    return (mesh, pp) if pp > 1 else (None, 1)


class PipelinedTransformerLM(KerasNet, nn.Module):
    """TransformerLM whose blocks run as a GPipe pipeline over ``pp``.

    ``blocks.*`` hold every block's parameters stacked on a leading axis;
    :meth:`param_spec` shards that axis over ``pp`` for the Estimator's
    ``param_sharding`` (each rank keeps its stage's blocks). Embeddings,
    the final LN and the LM head stay replicated outside the pipeline.
    ``seed`` draws the weights as :class:`TransformerLM`'s does (CPU
    generator: tables, LM head, then each block in turn)."""

    def __init__(self, vocab: int, hidden_size: int = 256, n_block: int = 4,
                 n_head: int = 8, seq_len: int = 512,
                 intermediate_size: Optional[int] = None,
                 n_microbatches: int = 4, attn_strategy: str = "full", *,
                 device=None, seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        self.vocab = vocab
        self.hidden_size = hidden_size
        self.n_block = n_block
        self.n_head = n_head
        self.seq_len = seq_len
        self.intermediate_size = intermediate_size
        self.n_microbatches = n_microbatches
        self.attn_strategy = attn_strategy
        g = torch.Generator().manual_seed(int(seed))
        dev = self.device
        self.token_embeddings = nn.Parameter(
            embedding_normal(g, (vocab, hidden_size)).to(dev))
        self.pos_embeddings = nn.Parameter(
            embedding_normal(g, (seq_len, hidden_size)).to(dev))
        self.logits_kernel = nn.Parameter(
            glorot_uniform(g, (hidden_size, vocab)).to(dev))
        per_block = [TransformerLayer(hidden_size, n_head, intermediate_size,
                                      causal=True,
                                      attn_strategy=attn_strategy,
                                      generator=g, device="cpu")
                     for _ in range(n_block)]
        # one block module holds the structure; its parameters are the
        # stacked (n_block, ...) leaves, and a block applies through
        # functional_call with its slice
        self.blocks = per_block[0]
        stacked = {n: torch.stack([dict(b.named_parameters())[n].detach()
                                   for b in per_block])
                   for n, _ in per_block[0].named_parameters()}
        for name, t in stacked.items():
            *path, leaf = name.split(".")
            owner = self.blocks
            for part in path:
                owner = getattr(owner, part)
            setattr(owner, leaf, nn.Parameter(t.to(dev)))
        self.blocks.to(dev)
        self.ln_f = LayerNormalization(dim=hidden_size, device=dev)

    def param_spec(self, path, leaf):
        """``(name, leaf) -> P`` for ``Estimator(param_sharding=...)``:
        the stacked ``blocks.*`` leaves shard their block axis over ``pp``
        (a top-level ``blocks`` key only); everything else replicates."""
        from ..parallel.sharding import P, path_keys

        keys = path_keys(path)
        if keys and keys[0] == "blocks" and getattr(leaf, "ndim", 0) >= 1:
            _, pp = _pp_mesh()
            if pp > 1 and self.n_block % pp:
                raise ValueError(
                    f"n_block={self.n_block} is not divisible by the mesh's "
                    f"pp={pp}: pipeline stages must hold equal block counts")
            return P("pp")
        return P()

    def _stacked(self) -> Dict[str, torch.Tensor]:
        return dict(self.blocks.named_parameters())

    def _apply_block_stack(self, stacked: Dict[str, torch.Tensor],
                           h: torch.Tensor) -> torch.Tensor:
        """The blocks of ``stacked`` (leaves (k, ...)) in turn."""
        from torch.func import functional_call

        k = next(iter(stacked.values())).shape[0]
        for j in range(k):
            h = functional_call(self.blocks,
                                {n: p[j] for n, p in stacked.items()}, (h,))
        return h

    def apply_features(self, x) -> torch.Tensor:
        ids = torch.as_tensor(x, device=self.device).long()
        h = self.token_embeddings[ids] + self.pos_embeddings[:ids.shape[1]][None]
        h = as_compute(h)
        stacked = self._stacked()
        mesh, pp = _pp_mesh()
        if pp > 1:
            from ..parallel.pipeline import pipeline_apply

            if self.n_block % pp:
                raise ValueError(f"n_block={self.n_block} not divisible by "
                                 f"pp={pp}")
            k = self.n_block // pp
            lead = next(iter(stacked.values())).shape[0]
            stages = {n: p.reshape((lead // k, k) + tuple(p.shape[1:]))
                      for n, p in stacked.items()}
            h = pipeline_apply(self._apply_block_stack, stages, h, mesh,
                               n_microbatches=self.n_microbatches)
        else:
            h = self._apply_block_stack(stacked, h)
        return self.ln_f(h)

    def apply(self, x) -> torch.Tensor:
        h = self.apply_features(x)
        return h @ self.logits_kernel.to(h.dtype)

    def forward(self, x) -> torch.Tensor:
        return self.apply(x)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.vocab,)

    def constructor_config(self):
        return dict(vocab=self.vocab, hidden_size=self.hidden_size,
                    n_block=self.n_block, n_head=self.n_head,
                    seq_len=self.seq_len,
                    intermediate_size=self.intermediate_size,
                    n_microbatches=self.n_microbatches,
                    attn_strategy=self.attn_strategy)


def lm_loss(y_true, logits) -> torch.Tensor:
    """Next-token cross entropy over (B, T) int targets and (B, T, V)
    logits, in f32 and in the lse form (CE = logsumexp(z) − z[label]), as
    the JAX package computes it."""
    logits = logits.float()
    labels = torch.as_tensor(y_true, device=logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(lse - picked)


def vocab_parallel_lm_loss(y_true, logits, mesh) -> torch.Tensor:
    """:func:`lm_loss` over vocab shards (Megatron's vocab-parallel cross
    entropy): ``logits`` (B, T, V/n) are this rank's contiguous block of
    the vocab over ``tp``. The global max (``pmax``, no gradient: a
    shift), the ``psum`` of the exp-sums beside the target logit from the
    rank that owns it (one all-reduce), then the mean of ``lse −
    z[label]`` in f32, the same on every rank."""
    from ..parallel import comm

    z = logits.float()
    labels = torch.as_tensor(y_true, device=z.device).long()
    v = z.shape[-1]
    lo = comm.axis_index("tp", mesh) * v
    m = comm.pmax(z.amax(-1), "tp", mesh=mesh)
    local = labels - lo
    own = (local >= 0) & (local < v)
    picked = torch.gather(z, -1, torch.where(own, local, 0)[..., None])[..., 0]
    picked = torch.where(own, picked, torch.zeros((), device=z.device))
    sums = comm.reduce_from(torch.stack(
        [torch.exp(z - m[..., None]).sum(-1), picked]), "tp", mesh=mesh)
    return torch.mean(m + torch.log(sums[0]) - sums[1])


__all__ = ["PipelinedTransformerLM", "TransformerLM", "lm_loss",
           "vocab_parallel_lm_loss"]
