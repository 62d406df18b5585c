"""Fused LM-head softmax cross-entropy with O(chunk × V) logits memory
(port of ``ops/fused_ce.py``).

The LM-head counterpart of flash attention: the (N, V) logits never exist
whole. The forward walks the tokens in chunks, computes each chunk's
logits ``h_c @ W`` in the operands' promoted dtype with f32 accumulation,
keeps only the chunk's ``logsumexp`` minus the label logit, and drops the
logits. The backward recomputes each chunk's logits and accumulates
``dh_c = dz @ Wᵀ`` and ``dW += h_cᵀ @ dz`` with ``dz = softmax − onehot``
scaled by the incoming grad over N — one more ``N·H·V`` product in
exchange for never holding (N, V). Chunking is shared by both halves
(:func:`_prepare`), as in JAX. This is plain PyTorch; there is no kernel
behind it (the JAX version is plain jnp under a custom VJP).
"""

from __future__ import annotations

import torch


def _promoted(h: torch.Tensor, kernel: torch.Tensor) -> torch.dtype:
    return torch.promote_types(h.dtype, kernel.dtype)


def _mm(a: torch.Tensor, b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``a @ b`` with both operands rounded to ``dt`` and the product
    taken in f32 (f32 accumulation, as ``preferred_element_type`` does)."""
    return a.to(dt).float() @ b.to(dt).float()


def _prepare(h: torch.Tensor, labels: torch.Tensor, chunk: int):
    """Flatten to a token axis, pad to a chunk multiple and split. Returns
    ``(h3, l3, valid3, n)``: (n_chunks, chunk, H) activations,
    (n_chunks, chunk) labels, the validity mask and the true token count."""
    hdim = h.shape[-1]
    hf, lf = h.reshape(-1, hdim), labels.reshape(-1).long()
    n = hf.shape[0]
    if n == 0:
        raise ValueError("fused_softmax_xent: zero tokens (h has an empty "
                         "leading shape); the mean over n=0 tokens is "
                         "undefined")
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        hf = torch.cat([hf, hf.new_zeros((pad, hdim))])
        lf = torch.cat([lf, lf.new_zeros((pad,))])
    n_chunks = hf.shape[0] // chunk
    valid = (torch.arange(hf.shape[0], device=h.device) < n)
    return (hf.reshape(n_chunks, chunk, hdim), lf.reshape(n_chunks, chunk),
            valid.reshape(n_chunks, chunk), n)


class FusedSoftmaxXent(torch.autograd.Function):
    """Forward: chunked lse-form cross entropy; backward: per-chunk
    recompute of the logits."""

    @staticmethod
    def forward(ctx, h, kernel, labels, chunk: int):
        h3, l3, valid3, n = _prepare(h, labels, chunk)
        dt = _promoted(h, kernel)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for h_c, l_c, v_c in zip(h3, l3, valid3):
            z = _mm(h_c, kernel, dt)                           # (chunk, V)
            lse = torch.logsumexp(z, dim=-1)
            picked = torch.gather(z, -1, l_c[:, None])[:, 0]
            total = total + torch.sum(torch.where(v_c, lse - picked, 0.0))
        ctx.save_for_backward(h, kernel, labels)
        ctx.chunk = chunk
        return total / n

    @staticmethod
    def backward(ctx, g):
        h, kernel, labels = ctx.saved_tensors
        h3, l3, valid3, n = _prepare(h, labels, ctx.chunk)
        dt = _promoted(h, kernel)
        scale = (g / n).float()
        dw = torch.zeros(kernel.shape, dtype=torch.float32,
                         device=kernel.device)
        dhs = []
        for h_c, l_c, v_c in zip(h3, l3, valid3):
            z = _mm(h_c, kernel, dt)                           # recompute
            dz = torch.softmax(z, dim=-1)
            dz[torch.arange(dz.shape[0], device=dz.device), l_c] -= 1.0
            dz = torch.where(v_c[:, None], dz, 0.0) * scale
            dhs.append(_mm(dz, kernel.t(), dt))
            dw = dw + _mm(h_c.t(), dz, dt)
        dh = torch.cat(dhs)[:n].reshape(h.shape)
        return dh.to(h.dtype), dw.to(kernel.dtype), None, None


def fused_softmax_xent(h: torch.Tensor, kernel: torch.Tensor,
                       labels: torch.Tensor, chunk: int = 4096
                       ) -> torch.Tensor:
    """Mean softmax cross-entropy of ``h @ kernel`` against int
    ``labels``. ``h``: (..., H), ``kernel``: (H, V), ``labels`` matching
    ``h``'s leading shape. Peak extra memory is ``chunk × V`` f32."""
    return FusedSoftmaxXent.apply(h, kernel, labels, chunk)


__all__ = ["FusedSoftmaxXent", "fused_softmax_xent"]
