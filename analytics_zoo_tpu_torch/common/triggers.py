"""Training triggers — when to stop (port of ``common/triggers.py``).

A copy of the JAX package's module, which imports no JAX: triggers are
pure predicates over a :class:`TrainerState` snapshot, kept on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TrainerState:
    """Host-side loop counters handed to triggers."""

    epoch: int = 0            # completed epochs
    iteration: int = 0        # completed global steps
    records_processed: int = 0
    last_score: float = float("-inf")
    # float OR a 0-d device tensor (set lazily by the epoch epilogue): a
    # device->host copy waits for the card, so the scalar is materialized
    # only when something reads ``last_loss``. Excluded from repr/compare so
    # neither forces a sync.
    _last_loss: object = field(default=float("inf"), repr=False, compare=False)

    @property
    def last_loss(self) -> float:
        v = self._last_loss
        if not isinstance(v, float):
            v = float(v)             # the device->host copy happens here, once
            self._last_loss = v
        return v

    @last_loss.setter
    def last_loss(self, v) -> None:
        self._last_loss = v


class Trigger:
    def __call__(self, state: TrainerState) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def __and__(self, other: "Trigger") -> "Trigger":
        return _And(self, other)

    def __or__(self, other: "Trigger") -> "Trigger":
        return _Or(self, other)


class _And(Trigger):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __call__(self, state):
        return self.a(state) and self.b(state)


class _Or(Trigger):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __call__(self, state):
        return self.a(state) or self.b(state)


class MaxEpoch(Trigger):
    def __init__(self, max_epoch: int):
        self.max_epoch = max_epoch

    def __call__(self, state):
        return state.epoch >= self.max_epoch


class MaxIteration(Trigger):
    def __init__(self, max_iteration: int):
        self.max_iteration = max_iteration

    def __call__(self, state):
        return state.iteration >= self.max_iteration


class EveryEpoch(Trigger):
    """Fires at each epoch boundary (checkpoint/validation cadence)."""

    def __init__(self):
        self._last_epoch = -1

    def __call__(self, state):
        if state.epoch != self._last_epoch:
            self._last_epoch = state.epoch
            return True
        return False


class SeveralIteration(Trigger):
    def __init__(self, interval: int):
        assert interval > 0
        self.interval = interval

    def __call__(self, state):
        return state.iteration > 0 and state.iteration % self.interval == 0


class MinLoss(Trigger):
    def __init__(self, min_loss: float):
        self.min_loss = min_loss

    def __call__(self, state):
        return state.last_loss <= self.min_loss


class MaxScore(Trigger):
    def __init__(self, max_score: float):
        self.max_score = max_score

    def __call__(self, state):
        return state.last_score >= self.max_score


__all__ = ["EveryEpoch", "MaxEpoch", "MaxIteration", "MaxScore", "MinLoss",
           "SeveralIteration", "Trigger", "TrainerState"]
