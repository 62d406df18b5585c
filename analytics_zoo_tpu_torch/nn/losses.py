"""Loss objectives, Keras-style and string-addressable (port of
``nn/losses.py``).

Every loss reduces to a scalar mean over the batch and computes in f32
whatever the compute dtype, as in the JAX package. Any
``f(y_true, y_pred) -> scalar`` tensor function is a custom loss: pass the
callable itself.
"""

from __future__ import annotations

from typing import Callable, Dict, Union

import torch

_EPS = 1e-7


def _t(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, device=device)


def _f32(y_true, y_pred):
    y_pred = _t(y_pred, y_true).float()
    return _t(y_true, y_pred).to(y_pred.device).float(), y_pred


def mean_squared_error(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    return torch.mean(torch.square(y_pred - y_true))


def mean_absolute_error(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    return torch.mean(torch.abs(y_pred - y_true))


def mean_absolute_percentage_error(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    diff = torch.abs((y_true - y_pred) / torch.clamp(torch.abs(y_true),
                                                     min=_EPS))
    return 100.0 * torch.mean(diff)


def mean_squared_logarithmic_error(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    a = torch.log(torch.clamp(y_pred, min=_EPS) + 1.0)
    b = torch.log(torch.clamp(y_true, min=_EPS) + 1.0)
    return torch.mean(torch.square(a - b))


def binary_crossentropy(y_true, y_pred, from_logits: bool = False):
    y_true, y_pred = _f32(y_true, y_pred)
    if from_logits:
        return torch.mean(torch.clamp(y_pred, min=0) - y_pred * y_true
                          + torch.log1p(torch.exp(-torch.abs(y_pred))))
    p = torch.clamp(y_pred, _EPS, 1.0 - _EPS)
    return -torch.mean(y_true * torch.log(p)
                       + (1.0 - y_true) * torch.log(1.0 - p))


def categorical_crossentropy(y_true, y_pred, from_logits: bool = False):
    y_true, y_pred = _f32(y_true, y_pred)
    if from_logits:
        logp = torch.log_softmax(y_pred, dim=-1)
    else:
        logp = torch.log(torch.clamp(y_pred, _EPS, 1.0))
    return -torch.mean(torch.sum(y_true * logp, dim=-1))


def sparse_categorical_crossentropy(y_true, y_pred, from_logits: bool = False):
    """``y_true`` int class ids (B,) or (B, 1); ``y_pred`` (B, C)."""
    y_pred = _t(y_pred, y_true).float()
    labels = _t(y_true, y_pred).to(y_pred.device).long().reshape(
        y_pred.shape[:-1])
    if from_logits:
        logp = torch.log_softmax(y_pred, dim=-1)
    else:
        logp = torch.log(torch.clamp(y_pred, _EPS, 1.0))
    picked = torch.gather(logp, -1, labels[..., None])[..., 0]
    return -torch.mean(picked)


def kullback_leibler_divergence(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    p = torch.clamp(y_true, _EPS, 1.0)
    q = torch.clamp(y_pred, _EPS, 1.0)
    return torch.mean(torch.sum(p * torch.log(p / q), dim=-1))


def poisson(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    return torch.mean(y_pred - y_true * torch.log(y_pred + _EPS))


def cosine_proximity(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    a = y_true / (torch.linalg.vector_norm(y_true, dim=-1, keepdim=True)
                  + _EPS)
    b = y_pred / (torch.linalg.vector_norm(y_pred, dim=-1, keepdim=True)
                  + _EPS)
    return -torch.mean(torch.sum(a * b, dim=-1))


def hinge(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    return torch.mean(torch.clamp(1.0 - y_true * y_pred, min=0.0))


def squared_hinge(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    return torch.mean(torch.square(torch.clamp(1.0 - y_true * y_pred,
                                               min=0.0)))


def rank_hinge(y_true, y_pred, margin: float = 1.0):
    """Pairwise rank hinge over (pos, neg) interleaved batches."""
    y_pred = _t(y_pred, y_true).float().reshape(-1)
    pos = y_pred[0::2]
    neg = y_pred[1::2]
    return torch.mean(torch.clamp(margin - pos + neg, min=0.0))


LOSSES: Dict[str, Callable] = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "mape": mean_absolute_percentage_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "binary_crossentropy": binary_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "kld": kullback_leibler_divergence,
    "kullback_leibler_divergence": kullback_leibler_divergence,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "rank_hinge": rank_hinge,
}


def get_loss(loss: Union[str, Callable]) -> Callable:
    """Resolve a loss by name, or accept any ``f(y_true, y_pred) ->
    scalar``."""
    if callable(loss):
        return loss
    try:
        return LOSSES[loss.lower()]
    except KeyError:
        raise ValueError(f"unknown loss {loss!r}; known: {sorted(LOSSES)}")


__all__ = ["LOSSES", "get_loss"] + sorted(
    {f.__name__ for f in LOSSES.values()})
