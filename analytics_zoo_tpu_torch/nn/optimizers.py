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
- a schedule is read at the count before it is incremented;
- RMSprop adds ``eps`` inside the square root (``rsqrt(nu + eps)``, from a
  zero ``nu``), Adadelta inside both roots, and Adagrad starts its sum of
  squares at ``initial_accumulator_value=0.1`` (``rsqrt(s + eps)`` where
  ``s > 0``); Adamax bias-corrects ``mu`` only, its ``nu`` is
  ``max(|g| + eps, b2 * nu)``; LARS is weight decay and the trust ratio
  ``trust_coefficient * |p| / (|u| + eps)`` (1 where either norm is 0),
  then the learning rate, then momentum.

Each state is the NamedTuple optax keeps (``ScaleByAdamState``,
``TraceState``, ``ScaleByScheduleState``, ...) with optax's field names, and
a stateless transformation's state is ``None`` (optax's ``EmptyState``), so
the train state maps onto a JAX checkpoint's leaf paths
(``bridge.train_state_to_jax``). Counts are host integers, so a schedule
costs no device sync.
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


# optax's state types: their field names are the checkpoint's leaf paths
class ScaleByAdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


class ScaleByScheduleState(NamedTuple):
    count: int


class TraceState(NamedTuple):
    trace: Params


class ScaleByRmsState(NamedTuple):
    nu: Params


class ScaleByRssState(NamedTuple):
    sum_of_squares: Params


class ScaleByAdaDeltaState(NamedTuple):
    e_g: Params
    e_x: Params


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

    def update(g, state, params=None):
        step = np.float32(-1 * lr(state.count))
        return ({n: x * float(step) for n, x in g.items()},
                ScaleByScheduleState(state.count + 1))

    return GradientTransformation(lambda params: ScaleByScheduleState(0),
                                  update)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in f32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(0, _zeros_like(params),
                                _zeros_like(params))

    def update(g, state, params=None):
        mu = {n: (1 - b1) * x + b1 * state.mu[n] for n, x in g.items()}
        nu = {n: (1 - b2) * (x ** 2) + b2 * state.nu[n]
              for n, x in g.items()}
        count = state.count + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        out = {n: (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps) for n in g}
        return out, ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def scale_by_adamax(b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> GradientTransformation:
    """optax's: ``nu = max(|g| + eps, b2 * nu)``, only ``mu`` corrected."""
    def init(params):
        return ScaleByAdamState(0, _zeros_like(params), _zeros_like(params))

    def update(g, state, params=None):
        count = state.count + 1
        mu = {n: (1 - b1) * x + b1 * state.mu[n] for n, x in g.items()}
        nu = {n: torch.maximum(x.abs() + eps, b2 * state.nu[n])
              for n, x in g.items()}
        c1 = _bias_correction(b1, count)
        return ({n: (mu[n] / c1) / nu[n] for n in g},
                ScaleByAdamState(count, mu, nu))

    return GradientTransformation(init, update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0) -> GradientTransformation:
    """optax's with ``eps_in_sqrt``: ``g * rsqrt(nu + eps)``."""
    def init(params):
        return ScaleByRmsState({n: torch.full_like(p, initial_scale)
                                for n, p in params.items()})

    def update(g, state, params=None):
        nu = {n: (1 - decay) * (x ** 2) + decay * state.nu[n]
              for n, x in g.items()}
        return ({n: torch.rsqrt(nu[n] + eps) * x for n, x in g.items()},
                ScaleByRmsState(nu))

    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
    """optax's Adagrad scaling: ``g * rsqrt(s + eps)`` where ``s > 0``."""
    def init(params):
        return ScaleByRssState({n: torch.full_like(
            p, initial_accumulator_value) for n, p in params.items()})

    def update(g, state, params=None):
        sos = {n: x * x + state.sum_of_squares[n] for n, x in g.items()}
        inv = {n: torch.where(t > 0, torch.rsqrt(t + eps),
                              torch.zeros((), dtype=t.dtype, device=t.device))
               for n, t in sos.items()}
        return {n: inv[n] * x for n, x in g.items()}, ScaleByRssState(sos)

    return GradientTransformation(init, update)


def scale_by_adadelta(rho: float = 0.9,
                      eps: float = 1e-6) -> GradientTransformation:
    def init(params):
        return ScaleByAdaDeltaState(_zeros_like(params), _zeros_like(params))

    def update(g, state, params=None):
        e_g = {n: (1 - rho) * (x ** 2) + rho * state.e_g[n]
               for n, x in g.items()}
        out = {n: (torch.sqrt(state.e_x[n] + eps) / torch.sqrt(e_g[n] + eps))
               * x for n, x in g.items()}
        e_x = {n: (1 - rho) * (u ** 2) + rho * state.e_x[n]
               for n, u in out.items()}
        return out, ScaleByAdaDeltaState(e_g, e_x)

    return GradientTransformation(init, update)


def scale_by_trust_ratio(trust_coefficient: float = 1.0,
                         eps: float = 0.0) -> GradientTransformation:
    """``u * trust_coefficient * |p| / (|u| + eps)`` per leaf, the ratio 1
    where either norm is 0 (optax's, ``min_norm=0``)."""
    def update(g, state, params=None):
        if params is None:
            raise ValueError("scale_by_trust_ratio needs the params")
        out = {}
        for n, u in g.items():
            pn = torch.linalg.vector_norm(params[n])
            un = torch.linalg.vector_norm(u)
            ratio = trust_coefficient * pn / (un + eps)
            one = torch.ones((), dtype=params[n].dtype, device=u.device)
            out[n] = u * torch.where((pn == 0) | (un == 0), one, ratio)
        return out, state

    return GradientTransformation(lambda params: None, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(g, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return {n: x + weight_decay * params[n] for n, x in g.items()}, state

    return GradientTransformation(lambda params: None, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """Momentum: ``t = g + decay * t``."""
    def update(g, state, params=None):
        t = {n: x + decay * state.trace[n] for n, x in g.items()}
        out = {n: g[n] + decay * t[n] for n in g} if nesterov else t
        return out, TraceState(t)

    return GradientTransformation(
        lambda params: TraceState(_zeros_like(params)), update)


def global_norm(tree: Params) -> torch.Tensor:
    """The L2 norm over every leaf, as a 0-d f32 tensor (no host sync)."""
    return torch.sqrt(sum(torch.sum(x.float() * x.float())
                          for x in tree.values()))


def clip_by_global_norm(max_norm: float,
                        norm_fn: Optional[Callable[[Params], torch.Tensor]]
                        = None) -> GradientTransformation:
    """optax's rule: keep ``g`` below ``max_norm``, else ``g / norm *
    max_norm``. ``norm_fn``: the norm of the whole gradient when ``g``
    holds only this rank's shards of it (default :func:`global_norm`)."""
    norm_fn = norm_fn or global_norm

    def update(g, state, params=None):
        g_norm = norm_fn(g)
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


def RMSprop(lr: Schedule = 1e-3, decay_rate: float = 0.9,
            epsilon: float = 1e-8):
    """As ``optax.rmsprop(lr, decay, eps)``."""
    return chain(scale_by_rms(decay_rate, epsilon), scale_by_learning_rate(lr),
                 identity())


def Adagrad(lr: Schedule = 0.01, epsilon: float = 1e-8):
    """As ``optax.adagrad(lr, eps=epsilon)``."""
    return chain(scale_by_rss(0.1, epsilon), scale_by_learning_rate(lr))


def Adadelta(lr: Schedule = 1.0, rho: float = 0.95, epsilon: float = 1e-8):
    """As ``optax.adadelta(lr, rho, eps)``."""
    return chain(add_decayed_weights(0.0), scale_by_adadelta(rho, epsilon),
                 scale_by_learning_rate(lr))


def Adamax(lr: Schedule = 2e-3, beta_1: float = 0.9, beta_2: float = 0.999,
           epsilon: float = 1e-8):
    """As ``optax.adamax``."""
    return chain(scale_by_adamax(beta_1, beta_2, epsilon),
                 scale_by_learning_rate(lr))


def LARS(lr: Schedule = 0.1, momentum: float = 0.9,
         weight_decay: float = 1e-4):
    """As ``optax.lars`` (trust coefficient 0.001, eps 0): the JAX factory
    leaves both of optax's masks at their default, every leaf, so weight
    decay and the trust ratio apply to each (optax's ``MaskedState``
    around them holds no leaves)."""
    return chain(add_decayed_weights(weight_decay),
                 scale_by_trust_ratio(0.001, 0.0),
                 scale_by_learning_rate(lr), trace(momentum))


OPTIMIZERS: Dict[str, Callable] = {
    "sgd": SGD,
    "adam": Adam,
    "adamw": AdamWeightDecay,
    "adamweightdecay": AdamWeightDecay,
    "rmsprop": RMSprop,
    "adagrad": Adagrad,
    "adadelta": Adadelta,
    "adamax": Adamax,
    "lars": LARS,
}


def get_optimizer(opt) -> GradientTransformation:
    """Resolve ``'adam'`` / a factory / a transformation."""
    if isinstance(opt, GradientTransformation):
        return opt
    if callable(opt):
        return opt()
    try:
        return OPTIMIZERS[opt.lower()]()
    except KeyError:
        raise ValueError(f"unknown optimizer {opt!r}; known: "
                         f"{sorted(OPTIMIZERS)}")


def with_clipping(tx: GradientTransformation,
                  clip_norm: Optional[float] = None,
                  clip_value: Optional[tuple] = None, *,
                  norm_fn: Optional[Callable[[Params], torch.Tensor]] = None
                  ) -> GradientTransformation:
    """Global-L2 and/or constant-range clipping composed before ``tx``
    (``norm_fn``: as :func:`clip_by_global_norm`'s)."""
    parts = []
    if clip_norm is not None:
        parts.append(clip_by_global_norm(clip_norm, norm_fn))
    if clip_value is not None:
        lo, hi = clip_value
        parts.append(clip_by_range(lo, hi))
    parts.append(tx)
    return chain(*parts) if len(parts) > 1 else tx


__all__ = ["Adadelta", "Adagrad", "Adam", "AdamWeightDecay", "Adamax",
           "GradientTransformation", "LARS", "OPTIMIZERS",
           "RMSprop", "SGD", "ScaleByAdaDeltaState", "ScaleByAdamState",
           "ScaleByRmsState", "ScaleByRssState", "ScaleByScheduleState",
           "TraceState", "add_decayed_weights", "apply_updates", "chain",
           "clip_by_global_norm", "clip_by_range", "exponential_decay",
           "fixed", "get_optimizer", "global_norm", "identity", "poly", "scale_by_adadelta", "scale_by_adam", "scale_by_adamax",
           "scale_by_learning_rate", "scale_by_rms", "scale_by_rss",
           "scale_by_trust_ratio", "trace", "warmup_linear", "with_clipping"]
