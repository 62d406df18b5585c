"""Optimizers and learning-rate schedules (port of ``nn/optimizers.py``).

The JAX package builds each optimizer from optax transformations; the port
keeps that shape. A :class:`GradientTransformation` is a pair of functions
over dicts of tensors keyed by parameter name — ``init(params) -> state``
and ``update(grads, state, params) -> (updates, state)`` — and the
factories compose them exactly as optax does, with optax's arithmetic:

- Adam's ``eps`` is added outside the square root (no ``eps_root``) and the
  bias correction ``1 - b**t`` uses the post-increment step count, in f32;
- ``AdamWeightDecay``/``adamw`` adds ``weight_decay * param`` after the Adam
  scaling and before the learning rate;
- ``clip_by_global_norm`` rescales only when the norm exceeds the limit;
- a schedule is read at the count before it is incremented.

Counts are host integers, so a schedule costs no device sync. Not ported
yet: RMSprop, Adagrad, Adadelta, Adamax and LARS (ROADMAP Queue 1).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Schedule = Union[float, Callable[[int], float]]


class GradientTransformation(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Any]


# ------------------------------------------------------------------- schedules

def fixed(lr: float) -> Schedule:
    """Constant learning rate."""
    return lr


def _polynomial(init_value: float, end_value: float, power: float,
                transition_steps: int) -> Callable[[int], float]:
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * (frac ** power) + end_value

    return schedule


def poly(lr: float, power: float, max_iteration: int) -> Schedule:
    return _polynomial(lr, 0.0, power, max_iteration)


def exponential_decay(lr: float, decay_rate: float, decay_steps: int,
                      staircase: bool = False) -> Schedule:
    if decay_steps <= 0 or decay_rate == 0:
        return lambda count: lr

    def schedule(count: int) -> float:
        p = count / decay_steps
        if staircase:
            p = math.floor(p)
        return lr if count <= 0 else lr * decay_rate ** p

    return schedule


def warmup_linear(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """Linear warmup to ``lr``, then linear decay to 0."""
    up = _polynomial(0.0, lr, 1, warmup_steps)
    down = _polynomial(lr, 0.0, 1, max(1, total_steps - warmup_steps))

    def schedule(count: int) -> float:
        return up(count) if count < warmup_steps else down(
            count - warmup_steps)

    return schedule


# ------------------------------------------------------------ transformations

def _zeros_like(params: Params) -> Params:
    return {n: torch.zeros_like(p, dtype=torch.float32
                                if p.is_floating_point() else p.dtype)
            for n, p in params.items()}


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: None,
                                  lambda g, state, params=None: (g, state))


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


def scale_by_learning_rate(lr: Schedule) -> GradientTransformation:
    """``-lr * g``; a schedule is read at the count before the update."""
    if not callable(lr):
        return GradientTransformation(
            lambda params: None,
            lambda g, state, params=None: ({n: (-lr) * x for n, x in
                                            g.items()}, state))

    def update(g, count, params=None):
        step = np.float32(-1 * lr(count))
        return {n: x * float(step) for n, x in g.items()}, count + 1

    return GradientTransformation(lambda params: 0, update)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in f32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class AdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return AdamState(0, _zeros_like(params), _zeros_like(params))

    def update(g, state, params=None):
        mu = {n: (1 - b1) * x + b1 * state.mu[n] for n, x in g.items()}
        nu = {n: (1 - b2) * (x ** 2) + b2 * state.nu[n]
              for n, x in g.items()}
        count = state.count + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        out = {n: (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps) for n in g}
        return out, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(g, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return {n: x + weight_decay * params[n] for n, x in g.items()}, state

    return GradientTransformation(lambda params: None, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """Momentum: ``t = g + decay * t``."""
    def update(g, state, params=None):
        t = {n: x + decay * state[n] for n, x in g.items()}
        out = {n: g[n] + decay * t[n] for n in g} if nesterov else t
        return out, t

    return GradientTransformation(_zeros_like, update)


def global_norm(tree: Params) -> torch.Tensor:
    """The L2 norm over every leaf, as a 0-d f32 tensor (no host sync)."""
    return torch.sqrt(sum(torch.sum(x.float() * x.float())
                          for x in tree.values()))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(g, state, params=None):
        g_norm = global_norm(g)
        keep = g_norm < max_norm
        return {n: torch.where(keep, x, (x / g_norm.to(x.dtype)) * max_norm)
                for n, x in g.items()}, state

    return GradientTransformation(lambda params: None, update)


def clip_by_range(lo: float, hi: float) -> GradientTransformation:
    """Clamp every gradient element to ``[lo, hi]`` (asymmetric ranges
    allowed): ``setConstantGradientClipping(min, max)``."""
    return GradientTransformation(
        lambda params: None,
        lambda g, state, params=None: ({n: torch.clamp(x, lo, hi)
                                        for n, x in g.items()}, state))


def apply_updates(params: Params, updates: Params) -> Params:
    """``p + u`` cast back to each param's dtype."""
    return {n: (p + updates[n]).to(p.dtype) for n, p in params.items()}


# ------------------------------------------------------------------ optimizers

def SGD(lr: Schedule = 0.01, momentum: float = 0.0, dampening: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False):
    """SGD as ``optax.sgd`` (``dampening`` is accepted and unused, as in
    the JAX package)."""
    tx = chain(trace(momentum, nesterov) if momentum else identity(),
               scale_by_learning_rate(lr))
    if weight_decay:
        tx = chain(add_decayed_weights(weight_decay), tx)
    return tx


def Adam(lr: Schedule = 1e-3, beta_1: float = 0.9, beta_2: float = 0.999,
         epsilon: float = 1e-8):
    return chain(scale_by_adam(beta_1, beta_2, epsilon),
                 scale_by_learning_rate(lr))


def AdamWeightDecay(lr: Schedule = 1e-3, warmup_portion: float = -1.0,
                    total: int = -1, schedule: str = "linear",
                    beta_1: float = 0.9, beta_2: float = 0.999,
                    epsilon: float = 1e-6, weight_decay: float = 0.01):
    """BERT-style AdamW with warmup, as ``optax.adamw``."""
    if total > 0 and warmup_portion > 0:
        sched = warmup_linear(lr if isinstance(lr, float) else 1e-3,
                              int(total * warmup_portion), total)
    else:
        sched = lr
    return chain(scale_by_adam(beta_1, beta_2, epsilon),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(sched))


OPTIMIZERS: Dict[str, Callable] = {
    "sgd": SGD,
    "adam": Adam,
    "adamw": AdamWeightDecay,
    "adamweightdecay": AdamWeightDecay,
}
_UNPORTED = ("rmsprop", "adagrad", "adadelta", "adamax", "lars")


def get_optimizer(opt) -> GradientTransformation:
    """Resolve ``'adam'`` / a factory / a transformation."""
    if isinstance(opt, GradientTransformation):
        return opt
    if callable(opt):
        return opt()
    name = opt.lower()
    if name in _UNPORTED:
        raise NotImplementedError(f"optimizer {opt!r} is not ported yet "
                                  f"(ROADMAP Queue 1); ported: "
                                  f"{sorted(OPTIMIZERS)}")
    try:
        return OPTIMIZERS[name]()
    except KeyError:
        raise ValueError(f"unknown optimizer {opt!r}; known: "
                         f"{sorted(OPTIMIZERS)}")


def with_clipping(tx: GradientTransformation,
                  clip_norm: Optional[float] = None,
                  clip_value: Optional[tuple] = None
                  ) -> GradientTransformation:
    """Global-L2 and/or constant-range clipping composed before ``tx``."""
    parts = []
    if clip_norm is not None:
        parts.append(clip_by_global_norm(clip_norm))
    if clip_value is not None:
        lo, hi = clip_value
        parts.append(clip_by_range(lo, hi))
    parts.append(tx)
    return chain(*parts) if len(parts) > 1 else tx


__all__ = ["Adam", "AdamWeightDecay", "GradientTransformation", "OPTIMIZERS",
           "SGD", "add_decayed_weights", "apply_updates", "chain",
           "clip_by_global_norm", "clip_by_range", "exponential_decay",
           "fixed", "get_optimizer", "global_norm", "identity", "poly",
           "scale_by_adam", "scale_by_learning_rate", "trace",
           "warmup_linear", "with_clipping"]
