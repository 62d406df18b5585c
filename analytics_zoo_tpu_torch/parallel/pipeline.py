"""Pipeline parallelism over the ``pp`` axis (port of
``parallel/pipeline.py``): GPipe micro-batching.

Rank s of the ``pp`` axis holds stage s. Every rank runs the same
program: at step t it applies its stage to the activation it holds and
``ppermute``s the result to the next stage; stage 0 takes micro-batch t
(micro-batch 0 again once they run out, as in JAX) in place of the ring's
input, through a ``where`` that keeps the ring's input in its graph too,
so every rank's autograd graph has the same shape and the backward issues
the reverse collectives in the same order everywhere. After ``n_micro +
n_stages − 1`` steps every micro-batch has passed every stage; the last
stage's outputs reach every rank through one ``psum`` of the owner's
(``comm.reduce_from``: the gradient comes back to the owner alone), and
the input's gradient, which only stage 0 sees, is summed back over the
axis (``comm.copy_to``). The stage function must keep the activation's
shape.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from . import comm


def stack_stage_params(params_list: List[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """[per-stage param dict] → one dict with a leading stage axis."""
    return {n: torch.stack([p[n] for p in params_list])
            for n in params_list[0]}


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Dict[str, torch.Tensor], x: torch.Tensor,
                   mesh=None, *, n_microbatches: int,
                   axis_name: str = "pp") -> torch.Tensor:
    """``n_stages`` copies of ``stage_fn(stage_params, activation)`` as a
    pipeline over ``x`` (B, ...), B divisible by ``n_microbatches``.
    ``stacked_params``: leading stage axis of the axis's size (this rank
    takes its stage, the gradients all-gathered back) or of 1 (this rank's
    stage already). Returns the last stage's activations (B, ...) on every
    rank."""
    n = comm.axis_size(axis_name, mesh)
    idx = comm.axis_index(axis_name, mesh)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches} "
                         f"microbatches")
    mine = {}
    for name, p in stacked_params.items():
        if p.shape[0] == n and n > 1:
            p = comm.shard_along(p, axis_name, 0, mesh=mesh)
        elif p.shape[0] != 1 and n > 1:
            raise ValueError(f"stage param {name}: leading dim {p.shape[0]} "
                             f"is neither {axis_name}={n} nor 1")
        mine[name] = p[0] if p.shape[0] == 1 else p[idx]
    x = comm.copy_to(x, axis_name, mesh=mesh)
    micro = x.reshape((n_microbatches, b // n_microbatches) + x.shape[1:])
    first = torch.tensor(idx == 0, device=x.device)
    carry = torch.zeros_like(micro[0])
    perm = comm.ring_perm(n)
    total = n_microbatches + n - 1
    outs = []
    for t in range(total):
        inject = micro[t if t < n_microbatches else 0]
        y = stage_fn(mine, torch.where(first, inject, carry))
        if t >= n - 1:
            outs.append(y)
        if t < total - 1:
            carry = comm.ppermute(y, axis_name, perm, mesh=mesh)
    outputs = torch.stack(outs)
    owner = float(idx == n - 1)
    outputs = comm.reduce_from(outputs * owner, axis_name, mesh=mesh)
    return outputs.reshape((b,) + x.shape[1:])


__all__ = ["pipeline_apply", "stack_stage_params"]
