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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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

    def dispatch(self, probs: torch.Tensor):
        """``(dispatch, combine)``, each (N, E, capacity) f32, from the
        router's (N, E) probabilities."""
        n_tok, e = probs.shape
        cap = max(1, int(math.ceil(self.top_k * n_tok / e
                                   * self.capacity_factor)))
        gate_vals, gate_idx = top_k_stable(probs, self.top_k)
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                            min=1e-9)
        dispatch = torch.zeros((n_tok, e, cap), dtype=torch.float32,
                               device=probs.device)
        combine = torch.zeros_like(dispatch)
        fill = torch.zeros((e,), dtype=torch.float32, device=probs.device)
        for slot in range(self.top_k):
            onehot = F.one_hot(gate_idx[:, slot], e).float()      # (N, E)
            pos = torch.cumsum(onehot, 0) - onehot + fill[None, :]
            pos_tok = (pos * onehot).sum(1).to(torch.int64)        # (N,)
            keep = pos_tok < cap
            pos_oh = F.one_hot(torch.clamp(pos_tok, max=cap - 1), cap).float()
            contrib = (onehot * keep[:, None])[:, :, None] * pos_oh[:, None, :]
            dispatch = dispatch + contrib
            combine = combine + contrib * gate_vals[:, slot][:, None, None]
            fill = fill + onehot.sum(0)
        return dispatch, combine

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        from ...parallel import comm

        x = as_compute(x)
        b, t, d = x.shape
        tokens = x.reshape(b * t, d)
        e = self.n_experts
        logits = (tokens @ self.router_kernel.to(x.dtype)).float()
        probs = torch.softmax(logits, dim=-1)
        dispatch, combine = self.dispatch(probs)
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
        frac_tokens = dispatch.sum(-1).mean(0)
        frac_probs = probs.mean(0)
        aux = (frac_tokens * frac_probs).sum() * (e ** 2) / self.top_k
        self.state = {"aux_loss": aux}
        return y.to(x.dtype).reshape(b, t, d)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


__all__ = ["MoE", "top_k_stable"]
