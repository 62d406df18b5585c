"""Mixture-of-Experts layer with expert parallelism over the ``ep`` axis
(port of ``nn/layers/moe.py``).

GShard dense dispatch: a top-k router gives each token its experts; slot
s's capacity positions start after every slot < s assignment to that
expert (the running per-expert fill), a token past an expert's capacity
``ceil(k·N/E·capacity_factor)`` is dropped there, and the gates of the
kept slots weight the experts' outputs back per token. Expert compute is
one batched product over the expert dim. The load-balancing loss (mean
dispatch fraction × mean router probability per expert, × E²/k) is kept
in :attr:`MoE.state` under ``"aux_loss"``, the JAX layer state.

Ties: ``jax.lax.top_k`` puts the lower expert index first among equal
probabilities, and ``torch.topk`` promises no order, so the top-k here is
a stable descending sort: equal probabilities keep index order.

Under a runtime context whose mesh has ``ep > 1``: ``ep`` is not a batch
axis, so every ep rank holds the same tokens. Each rank computes the whole
dispatch, runs only its ``E/ep`` experts (its blocks of the expert
weights, the dispatched tokens and the combine weights, through
``comm.shard_along``, whose backward all-gathers the gradients), and one
``psum`` of the partial combines (``comm.reduce_from``) gives the JAX
result, capacity drops included. ``n_experts`` not divisible by ``ep``
raises.

Inside a step that computes over a global batch (a rank's block of it,
``comm.global_batch_shard()``: the Estimator's replicated and per-leaf
steps, BN's global-statistics test) the dispatch is the global batch's, as
JAX's ``MoE.apply`` runs under GSPMD on global shapes. The global token
order is the blocks' order (block ``dp_index * fsdp + fsdp_index``; under
accumulation the rank's block of each global micro-batch). The capacity
is ``ceil(k·N_global/E·capacity_factor)`` with ``N_global = N_local ·
shard.count``, and slot s's positions in expert e start after every
slot < s assignment to e over the whole global batch and every slot-s
assignment to e on an earlier block. So what crosses ranks is one (count,
k, E) table of each block's per-slot assignment counts, a ``psum`` over
the batch axes of a layout holding this rank's row (one all-reduce per
batch axis above 1), and no token: a capacity position depends on no
other, so a rank's ``expert_in`` holds its own tokens at their global
positions and its combine reads only those. The aux loss is the global
one: the per-expert dispatch and probability sums are summed over the
batch axes (a second all-reduce per axis) and divided by ``N_global``.
The cost is memory: the dispatch and combine tensors are (N_local, E,
cap_global), the per-device footprint of JAX's global (N_global, E,
cap_global) sharded over the batch. The flat (ZeRO-1) step, and a forward
outside a step, dispatch the rank's own tokens alone: the per-replica
body of JAX's flat ``shard_map`` (which the JAX package cannot run with
an MoE in it: the layer's ``build`` returns no state, its ``apply`` adds
``aux_loss``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import comm
from ..activations import get_activation
from ..module import Layer, as_compute, glorot_uniform, zeros_init


def _ep_axis(axis: str):
    from ...common.context import get_zoo_context

    try:
        mesh = get_zoo_context(auto_init=False).mesh
    except RuntimeError:
        return None
    if mesh is None or mesh.shape.get(axis, 1) <= 1:
        return None
    return mesh


def top_k_stable(probs: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest along the last dim, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoE(Layer):
    """Token-wise top-k mixture of expert MLPs: (B, T, D) → (B, T, D)."""

    def __init__(self, hidden_size: int, n_experts: int = 8,
                 intermediate_size: Optional[int] = None, top_k: int = 2,
                 capacity_factor: float = 1.25, activation="gelu",
                 ep_axis: str = "ep", name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.hidden_size = hidden_size
        self.n_experts = int(n_experts)
        self.intermediate = intermediate_size or 4 * hidden_size
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.activation = get_activation(activation)
        self.ep_axis = ep_axis
        #: the JAX layer state: ``{"aux_loss": 0-d f32}`` after a forward
        self.state = {}

    def build(self, input_shape, gen: torch.Generator) -> None:
        d, e, i = input_shape[-1], self.n_experts, self.intermediate
        self.router_kernel = nn.Parameter(glorot_uniform(gen, (d, e)))
        self.expert_up = nn.Parameter(glorot_uniform(gen, (e, d, i)))
        self.expert_up_bias = nn.Parameter(zeros_init((e, i)))
        self.expert_down = nn.Parameter(glorot_uniform(gen, (e, i, d)))
        self.expert_down_bias = nn.Parameter(zeros_init((e, d)))
        self.built = True

    def dispatch(self, probs: torch.Tensor,
                 shard: Optional[comm.BatchShard] = None):
        """``(dispatch, combine)``, each (N, E, capacity) f32, from the
        router's (N, E) probabilities. With ``shard`` (``probs`` is block
        ``shard.index`` of a global batch of ``shard.count`` blocks) the
        capacity and the running fill are the global batch's (module
        docstring)."""
        n_tok, e = probs.shape
        k = self.top_k
        count = 1 if shard is None else shard.count
        cap = max(1, int(math.ceil(k * n_tok * count / e
                                   * self.capacity_factor)))
        gate_vals, gate_idx = top_k_stable(probs, k)
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                            min=1e-9)
        onehots = F.one_hot(gate_idx, e).float()                  # (N, k, E)
        totals = onehots.sum(0)                                   # (k, E)
        before = torch.zeros_like(totals)
        if shard is not None:
            layout = torch.zeros((count,) + tuple(totals.shape),
                                 dtype=totals.dtype, device=totals.device)
            layout[shard.index] = totals
            blocks = comm.batch_psum(layout)
            totals = blocks.sum(0)
            before = blocks[:shard.index].sum(0)
        # slot s starts after every slot < s assignment (GShard's running
        # fill) and, on a block of a global batch, after the slot-s ones
        # of the blocks before it
        fill = torch.cumsum(totals, 0) - totals + before
        dispatch = torch.zeros((n_tok, e, cap), dtype=torch.float32,
                               device=probs.device)
        combine = torch.zeros_like(dispatch)
        for slot in range(k):
            onehot = onehots[:, slot]                             # (N, E)
            pos = torch.cumsum(onehot, 0) - onehot + fill[slot][None, :]
            pos_tok = (pos * onehot).sum(1).to(torch.int64)        # (N,)
            keep = pos_tok < cap
            pos_oh = F.one_hot(torch.clamp(pos_tok, max=cap - 1), cap).float()
            contrib = (onehot * keep[:, None])[:, :, None] * pos_oh[:, None, :]
            dispatch = dispatch + contrib
            combine = combine + contrib * gate_vals[:, slot][:, None, None]
        return dispatch, combine

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        x = as_compute(x)
        b, t, d = x.shape
        tokens = x.reshape(b * t, d)
        e = self.n_experts
        logits = (tokens @ self.router_kernel.to(x.dtype)).float()
        probs = torch.softmax(logits, dim=-1)
        shard = comm.global_batch_shard()
        dispatch, combine = self.dispatch(probs, shard)
        expert_in = torch.einsum("nec,nd->ecd", dispatch,
                                 tokens.float()).to(x.dtype)
        up, up_b = self.expert_up, self.expert_up_bias
        down, down_b = self.expert_down, self.expert_down_bias
        mesh = _ep_axis(self.ep_axis)
        if mesh is not None:
            n = mesh.shape[self.ep_axis]
            if e % n:
                raise ValueError(f"n_experts={e} not divisible by "
                                 f"{self.ep_axis}={n}")
            expert_in, up, up_b, down, down_b = (
                comm.shard_along(a, self.ep_axis, 0, mesh=mesh)
                for a in (expert_in, up, up_b, down, down_b))
            combine = comm.shard_along(combine, self.ep_axis, 1, mesh=mesh)
        h = torch.einsum("ecd,edi->eci", expert_in, up.to(x.dtype))
        h = self.activation(h + up_b.to(x.dtype)[:, None, :])
        out = torch.einsum("eci,eid->ecd", h, down.to(x.dtype))
        out = out + down_b.to(x.dtype)[:, None, :]
        y = torch.einsum("nec,ecd->nd", combine, out.float())
        if mesh is not None:
            y = comm.reduce_from(y, self.ep_axis, mesh=mesh)
        sums = torch.cat([dispatch.sum(-1).sum(0), probs.sum(0)])
        if shard is not None:
            sums = comm.batch_psum(sums)
        means = sums / (b * t * (1 if shard is None else shard.count))
        frac_tokens, frac_probs = means[:e], means[e:]
        aux = (frac_tokens * frac_probs).sum() * (e ** 2) / self.top_k
        self.state = {"aux_loss": aux}
        return y.to(x.dtype).reshape(b, t, d)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


__all__ = ["MoE", "top_k_stable"]
