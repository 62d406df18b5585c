"""Speculative multi-token decode (port of ``analytics_zoo_tpu/ops/speculative.py``).

A cheap proposer guesses the next ``k - 1`` tokens of a stream, the target
model scores all ``k`` positions (the certain last-sampled token and the
drafts) in one verify step — K2 at q_len k over the paged cache — and the
accept rule advances each stream by a variable count of tokens.

**Proposer** (:func:`propose_kgram`): the continuation that followed the
most recent earlier occurrence of the stream's trailing n-gram, in host
numpy (prompt-lookup decoding; no second model).

**Accept rule** (:func:`verify_draft_tokens`): position j samples under the
same per-(seed, ordinal) key the plain loop uses at that ordinal
(:func:`~analytics_zoo_tpu_torch.ops.kv_cache.sample_tokens`); draft j is
accepted iff the target's token equals it, the first mismatching token is
emitted as the correction and a fully accepted run emits the bonus token.
Same seeds, ordinals and prefixes give the same draws, so a speculative
stream is the plain stream at every temperature.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from .kv_cache import _host_list, sample_tokens


@dataclasses.dataclass(frozen=True)
class SpecDecodeConfig:
    """Speculative-decode schedule. ``k``: tokens scored per verify step
    (1 certain + k-1 drafted; k=1 is plain decode); ``max_ngram``: the
    longest suffix the proposer backs off from."""

    k: int = 4
    max_ngram: int = 3

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if self.max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {self.max_ngram}")


def propose_kgram(history: Sequence[int], n_draft: int,
                  max_ngram: int = 3) -> List[int]:
    """Draft ``n_draft`` tokens by suffix-matching the stream's own history:
    the tokens that followed the most recent earlier occurrence of the
    trailing ``n``-gram (n = max_ngram down to 1), padded with the last
    token when the match runs out; the last token repeated when nothing
    matches."""
    hist = np.asarray(history, np.int32).reshape(-1)
    n_hist = hist.size
    if n_hist == 0:
        return [0] * n_draft
    for n in range(min(max_ngram, n_hist - 1), 0, -1):
        suffix = hist[n_hist - n:]
        starts = np.flatnonzero(hist[: n_hist - n] == suffix[0])
        for s in starts[::-1]:
            if n == 1 or np.array_equal(hist[s:s + n], suffix):
                cont = hist[s + n: s + n + n_draft]
                if cont.size:
                    out = cont.tolist()
                    while len(out) < n_draft:
                        out.append(int(hist[-1]))
                    return out[:n_draft]
    return [int(hist[-1])] * n_draft


def verify_draft_tokens(logits: torch.Tensor, draft_ids, seeds, token_idx,
                        temperature, *, top_k: int = 0):
    """Batched accept/reject over one verify step's logits.

    ``logits``: (B, k, V); ``draft_ids``: (B, k-1); ``seeds``/``token_idx``/
    ``temperature``: (B,) — ``token_idx`` is the ordinal of the FIRST token
    this step emits, and position j samples under ordinal
    ``token_idx + j`` (mod 2**32, as the JAX package's uint32).

    Returns ``(accepted (B,) int32, tokens (B, k) int32, draft_probs
    (B, k-1) f32)``: ``tokens[:, :accepted+1]`` are the emitted tokens and
    ``draft_probs`` each draft's probability under the target."""
    b, k, v = logits.shape
    seeds = np.asarray(_host_list(seeds), np.int64)
    token_idx = np.asarray(_host_list(token_idx), np.int64)
    temps = np.asarray(_host_list(temperature), np.float32)
    ordinals = (token_idx[:, None] + np.arange(k)[None]) & 0xFFFFFFFF
    tokens, probs = sample_tokens(
        logits.reshape(b * k, v), np.repeat(seeds, k), ordinals.reshape(-1),
        np.repeat(temps, k), top_k=top_k, return_probs=True)
    tokens = tokens.reshape(b, k)
    if k == 1:
        return (torch.zeros(b, dtype=torch.int32, device=logits.device),
                tokens, torch.zeros((b, 0), dtype=torch.float32,
                                    device=logits.device))
    probs = probs.reshape(b, k, v)
    draft_ids = torch.as_tensor(draft_ids, device=logits.device).long()
    match = (tokens[:, : k - 1].long() == draft_ids).to(torch.int32)
    accepted = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    draft_probs = probs[:, : k - 1].gather(2, draft_ids[..., None])[..., 0]
    return accepted, tokens, draft_probs


__all__ = ["SpecDecodeConfig", "propose_kgram", "verify_draft_tokens"]
