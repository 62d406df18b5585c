"""Linear-chain CRF (port of ``analytics_zoo_tpu/nn/layers/crf.py``): the
log-likelihood by the forward algorithm, Viterbi decoding, the ``CRF``
head and the NLL over its packed output.

Both algorithms are Python loops over time on (B, E) tensors (the JAX
``lax.scan``), with JAX's masking: a padded step holds the forward
variables as they were and keeps the identity backpointer, so a
left-aligned padded sequence scores and decodes as its real prefix;
padded positions decode to tag 0.
"""

from __future__ import annotations

import torch
from torch import nn

from ..module import Layer


def crf_log_likelihood(emissions, tags, mask, transitions, start, end):
    """log p(tags | emissions) a sequence. emissions (B, T, E); tags
    (B, T) int (ignored where mask is 0); mask (B, T), true on real
    tokens, a prefix; transitions (E, E); start, end (E,)."""
    emissions = emissions.float()
    transitions, start, end = transitions.float(), start.float(), end.float()
    mask = mask.float()
    b, t, e = emissions.shape
    tags = tags.long().clamp(0, e - 1)

    em_score = emissions.gather(2, tags[..., None])[..., 0]      # (B, T)
    em_score = (em_score * mask).sum(dim=1)
    trans_score = transitions[tags[:, :-1], tags[:, 1:]]         # (B, T-1)
    trans_score = (trans_score * mask[:, 1:]).sum(dim=1)
    last_idx = (mask.sum(dim=1).long() - 1).clamp(min=0)
    last_tag = tags.gather(1, last_idx[:, None])[:, 0]
    path = em_score + trans_score + start[tags[:, 0]] + end[last_tag]

    alpha = start[None] + emissions[:, 0]
    for i in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + transitions[None], dim=1)
        nxt = nxt + emissions[:, i]
        alpha = torch.where(mask[:, i, None] > 0, nxt, alpha)
    log_z = torch.logsumexp(alpha + end[None], dim=1)
    return path - log_z


def crf_decode(emissions, mask, transitions, start, end):
    """Viterbi: the most likely tag path, (B, T) int32; padded positions
    give tag 0."""
    emissions = emissions.float()
    transitions = transitions.float()
    mask_f = mask.float()
    b, t, e = emissions.shape
    ident = torch.arange(e, device=emissions.device)[None].expand(b, e)
    alpha = start.float()[None] + emissions[:, 0]
    back = []
    for i in range(1, t):
        scores = alpha[:, :, None] + transitions[None]           # (B, E, E)
        best, best_prev = scores.max(dim=1)
        nxt = best + emissions[:, i]
        real = mask_f[:, i, None] > 0
        alpha = torch.where(real, nxt, alpha)
        back.append(torch.where(real, best_prev, ident))
    tag = (alpha + end.float()[None]).argmax(dim=1)              # (B,)
    path = [tag]
    for bp in reversed(back):
        tag = bp.gather(1, tag[:, None])[:, 0]
        path.append(tag)
    tags = torch.stack(path[::-1], dim=1).to(torch.int32)
    return torch.where(mask.bool(), tags, torch.zeros_like(tags))


class CRF(Layer):
    """A CRF head over emissions (B, T, E): its output is ``(emissions,
    packed)``, the (E + 2, E) energies (transitions, then the start and
    end rows) tiled over the batch, so a loss computes the exact NLL
    through ``f(y_true, y_pred)`` and its gradient reaches them."""

    def __init__(self, num_tags: int, name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.num_tags = int(num_tags)

    def build(self, input_shape, gen: torch.Generator) -> None:
        e = self.num_tags
        self.transitions = nn.Parameter(torch.zeros((e, e)))
        self.start = nn.Parameter(torch.zeros((e,)))
        self.end = nn.Parameter(torch.zeros((e,)))
        self.built = True

    def pack(self) -> torch.Tensor:
        return torch.cat([self.transitions.float(), self.start.float()[None],
                          self.end.float()[None]], dim=0)

    @staticmethod
    def unpack(packed):
        e = packed.shape[-1]
        return packed[..., :e, :], packed[..., e, :], packed[..., e + 1, :]

    def apply(self, emissions):
        packed = self.pack()[None].expand(
            (emissions.shape[0], self.num_tags + 2, self.num_tags))
        return emissions, packed

    def compute_output_shape(self, input_shape):
        t = input_shape[0] if input_shape else None
        return [(t, self.num_tags), (self.num_tags + 2, self.num_tags)]


def crf_nll_from_packed(tags, emissions, packed, pad_tag: int = -1):
    """The mean NLL over the CRF layer's ``(emissions, packed)`` output;
    ``tags`` hold ``pad_tag`` on padded positions."""
    mask = tags != pad_tag
    trans, start, end = CRF.unpack(packed[0])
    ll = crf_log_likelihood(emissions, tags.clamp(min=0), mask, trans, start,
                            end)
    return -ll.mean()


__all__ = ["CRF", "crf_decode", "crf_log_likelihood", "crf_nll_from_packed"]
