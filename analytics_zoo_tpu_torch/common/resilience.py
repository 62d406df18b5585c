"""Retry policies (port of the retry half of ``common/resilience.py``).

:class:`RetryPolicy` is the JAX package's one retry implementation: max
attempts, exponential backoff with jitter drawn from ``random.Random(seed)``
(so the two packages sleep the same delays for the same seed), an overall
deadline and a retryable-exception predicate. ``Estimator.fit``'s
rollback loop drives its retries through a :class:`RetryTracker`. Every
primitive takes injectable ``clock``/``sleep``.

A copy of the JAX package's classes, which need no JAX. Not ported yet:
``CircuitBreaker``, ``Heartbeat``, ``HealthRegistry`` and the
``zoo_retry_attempts_total`` counter (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Iterable, Optional, Tuple, Union


class ResilienceError(Exception):
    """Base class for resilience-layer failures."""


class RetryExhaustedError(ResilienceError):
    """All attempts of a :class:`RetryPolicy` failed."""


class DeadlineExceededError(ResilienceError):
    """The policy's overall deadline would be exceeded by the next attempt."""


class RetryAbortedError(ResilienceError):
    """The caller's ``abort`` predicate became true while retrying."""


class CircuitOpenError(ResilienceError):
    """A call was refused because the circuit is open."""

    def __init__(self, name: str, retry_after_s: float = 0.0):
        super().__init__(f"circuit {name!r} is open "
                         f"(retry after {retry_after_s:.1f}s)")
        self.name = name
        self.retry_after_s = retry_after_s


_DEFAULT_RETRYABLE = (ConnectionError, TimeoutError, OSError)


@dataclasses.dataclass
class RetryPolicy:
    """Declarative retry/backoff policy.

    ``max_attempts=None`` retries forever (bounded only by ``deadline_s`` and
    the caller's ``abort`` predicate) — the serving engine's
    connect-until-shutdown loop. ``retryable`` is a tuple of exception types
    or a predicate ``exc -> bool``. ``jitter`` is a ± fraction of each delay,
    drawn from a ``seed``-keyed stream so schedules are reproducible.
    ``attempt_timeout_s`` is advisory: callers pass it to whatever primitive
    supports cancellation (e.g. ``socket.create_connection(timeout=...)``) —
    Python cannot preempt an arbitrary function from outside.
    """

    max_attempts: Optional[int] = 5
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    attempt_timeout_s: Optional[float] = None
    deadline_s: Optional[float] = None
    retryable: Union[Tuple[type, ...], Callable[[BaseException], bool]] = \
        _DEFAULT_RETRYABLE
    seed: Optional[int] = None
    sleep: Optional[Callable[[float], None]] = None   # None => time.sleep
    clock: Optional[Callable[[], float]] = None       # None => time.monotonic

    def is_retryable(self, exc: BaseException) -> bool:
        if callable(self.retryable) and not isinstance(self.retryable, tuple):
            return bool(self.retryable(exc))
        return isinstance(exc, tuple(self.retryable))

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Delay after the ``attempt``-th failure (1-based), jittered."""
        d = min(self.max_delay_s,
                self.base_delay_s * (self.multiplier ** (attempt - 1)))
        if self.jitter:
            d *= 1.0 + rng.uniform(-self.jitter, self.jitter)
        return max(0.0, d)

    def delays(self) -> Iterable[float]:
        """The (possibly infinite) deterministic backoff schedule."""
        rng = random.Random(self.seed)
        attempt = 1
        while self.max_attempts is None or attempt < self.max_attempts:
            yield self.backoff_s(attempt, rng)
            attempt += 1

    def tracker(self) -> "RetryTracker":
        """Stateful attempt bookkeeping for loops that cannot be expressed as
        a plain ``call`` (e.g. fit's rollback-then-continue epoch loop)."""
        return RetryTracker(self)

    def call(self, fn: Callable, *args,
             abort: Optional[Callable[[], bool]] = None,
             on_retry: Optional[Callable[[BaseException, int, float], None]]
             = None, **kw) -> Any:
        """Run ``fn(*args, **kw)`` under this policy.

        Raises :class:`RetryExhaustedError` (chained to the last error) after
        ``max_attempts`` failures, :class:`DeadlineExceededError` when the
        next backoff would pass ``deadline_s``, and :class:`RetryAbortedError`
        when ``abort()`` turns true after a failure. ``abort`` gates
        *retries*, not the first attempt — a shutting-down component can
        still complete healthy calls (e.g. a sink draining results), it just
        stops fighting a dead peer. Non-retryable exceptions propagate
        immediately. ``on_retry(exc, attempt, delay_s)`` is called before
        each backoff sleep.
        """
        tracker = self.tracker()
        sleep = self.sleep or time.sleep
        while True:
            try:
                return fn(*args, **kw)
            except BaseException as e:
                if not self.is_retryable(e):
                    raise
                delay = tracker.record_failure(e)
            if on_retry is not None:
                on_retry(tracker.last_error, tracker.attempts, delay)
            if abort is not None and abort():
                raise RetryAbortedError(
                    f"aborted after attempt {tracker.attempts}") \
                    from tracker.last_error
            if delay > 0:
                sleep(delay)


class RetryTracker:
    """Attempt counter + backoff schedule for one logical operation.

    ``record_failure(exc)`` returns the delay to sleep before the next
    attempt, or raises ``RetryExhaustedError`` / ``DeadlineExceededError``
    (both chained to ``exc``).
    """

    def __init__(self, policy: RetryPolicy):
        self.policy = policy
        self.attempts = 0
        self.last_error: Optional[BaseException] = None
        self._rng = random.Random(policy.seed)
        self._clock = policy.clock or time.monotonic
        self._start = self._clock()

    @property
    def exhausted(self) -> bool:
        return (self.policy.max_attempts is not None
                and self.attempts >= self.policy.max_attempts)

    def record_failure(self, exc: BaseException) -> float:
        self.attempts += 1
        self.last_error = exc
        if self.exhausted:
            raise RetryExhaustedError(
                f"gave up after {self.attempts} attempts: {exc}") from exc
        delay = self.policy.backoff_s(self.attempts, self._rng)
        # a server-provided Retry-After hint (an exception carrying
        # ``retry_after_s`` — CircuitOpenError, serving ShedError) is the
        # BACKOFF FLOOR: the server computed it from its real queue drain
        # time, so retrying sooner is guaranteed wasted load. The policy's
        # seeded jitter still rides on top (+only — an overloaded server
        # must never be retried EARLIER than it asked).
        hint = getattr(exc, "retry_after_s", None)
        if isinstance(hint, (int, float)) and hint > 0 and hint > delay:
            delay = float(hint)
            if self.policy.jitter:
                delay *= 1.0 + self._rng.uniform(0.0, self.policy.jitter)
        if self.policy.deadline_s is not None and \
                self._clock() - self._start + delay > self.policy.deadline_s:
            raise DeadlineExceededError(
                f"deadline of {self.policy.deadline_s}s exceeded after "
                f"{self.attempts} attempts: {exc}") from exc
        return delay


__all__ = ["CircuitOpenError", "DeadlineExceededError", "ResilienceError",
           "RetryAbortedError", "RetryExhaustedError", "RetryPolicy",
           "RetryTracker"]
