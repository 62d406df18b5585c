"""Resilience primitives (port of ``common/resilience.py``, which needs no
JAX): retry/backoff policies and heartbeat-based health tracking.

* :class:`RetryPolicy` — max attempts, exponential backoff with jitter
  drawn from ``random.Random(seed)`` (so the two packages sleep the same
  delays for the same seed), an overall deadline and a retryable-exception
  predicate. ``Estimator.fit``'s rollback loop drives its retries through
  a :class:`RetryTracker`; every failure it records counts in
  ``zoo_retry_attempts_total``.
* :class:`CircuitBreaker` — closed/open/half-open over a sliding outcome
  window (``zoo_breaker_state``, ``zoo_breaker_opens_total``, a
  ``breaker.open`` event); the HTTP frontend guards its broker path with
  one, so a dead broker answers 503 at once.
* :class:`HealthRegistry` / :class:`Heartbeat` — liveness bookkeeping for
  worker threads (``zoo_component_alive``); ``ContinuousBatcher(registry=)``
  and ``ClusterServing`` take one, as the JAX ones do.

Every primitive takes injectable ``clock``/``sleep`` so the deterministic
fault-injection harness (:mod:`.chaos`) can test them without real
flakiness or wall-clock waits.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import time
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

from . import telemetry as _tm
from .locks import traced_lock

# breaker/heartbeat state lands on the shared scrape: live instances register
# into weak sets and scrape-time collectors walk them — no per-beat overhead
# beyond what the classes already pay
_LIVE_BREAKERS: "weakref.WeakSet[CircuitBreaker]" = weakref.WeakSet()
_LIVE_REGISTRIES: "weakref.WeakSet[HealthRegistry]" = weakref.WeakSet()
_BREAKER_STATE_VALUE = {"closed": 0.0, "half_open": 1.0, "open": 2.0}
_BREAKER_OPENS = _tm.counter("zoo_breaker_opens_total",
                             "Circuit-breaker open transitions",
                             labels=("name",))
_RETRIES = _tm.counter("zoo_retry_attempts_total",
                       "Failures recorded by retry trackers (each implies a "
                       "backoff or a terminal retry error)")


def _collect_breaker_states():
    # same-named breakers (two frontends in one process both default to
    # "serving-frontend") aggregate by WORST state, so an open breaker can
    # never be masked by a healthy same-named sibling on the scrape
    out = {}
    for b in list(_LIVE_BREAKERS):
        key = (b.name,)
        v = _BREAKER_STATE_VALUE.get(b.state, -1.0)
        out[key] = max(out.get(key, -1.0), v)
    return out.items()


def _collect_component_liveness():
    # keyed by (registry, component): two registries in one process (e.g. two
    # serving jobs) may register same-named components, and last-write-wins
    # over a bare component label would nondeterministically report a dead
    # job's entry for a live one
    out = {}
    for reg in list(_LIVE_REGISTRIES):
        for name, comp in reg.status()["components"].items():
            out[(reg.name, name)] = 1.0 if comp["alive"] else 0.0
    return out.items()


_tm.collector("zoo_breaker_state",
              "Circuit-breaker state (0=closed, 1=half_open, 2=open)",
              _collect_breaker_states, labels=("name",))
_tm.collector("zoo_component_alive",
              "Heartbeat liveness per registered component (1=alive)",
              _collect_component_liveness, labels=("registry", "component"))


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
        _RETRIES.inc()
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


# --------------------------------------------------------------------------
# circuit breaker
# --------------------------------------------------------------------------

class CircuitBreaker:
    """Closed/open/half-open breaker over a sliding outcome window.

    CLOSED: calls flow; outcomes land in a ``window``-sized deque; when the
    window holds >= ``failure_threshold`` failures the circuit OPENs.
    OPEN: ``allow()`` is False until ``reset_timeout_s`` passes, then the
    breaker goes HALF_OPEN and admits up to ``half_open_max_calls`` probes.
    HALF_OPEN: a probe success closes the circuit (window cleared); a probe
    failure re-opens it and restarts the timer.

    Thread-safe; ``clock`` is injectable for deterministic tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5, window: int = 20,
                 reset_timeout_s: float = 5.0, half_open_max_calls: int = 1,
                 name: str = "breaker",
                 clock: Optional[Callable[[], float]] = None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_max_calls = half_open_max_calls
        self._clock = clock or time.monotonic
        # the breaker lock is taken UNDER other locks (the router resolves
        # probes while holding ReplicaRouter._lock) and acquires no lock of
        # its own — the leaf declaration is what makes that nesting legal,
        # and the static pass + runtime witness both enforce it
        # zoo-lock: leaf
        self._lock = traced_lock("CircuitBreaker._lock")
        self._outcomes: collections.deque = collections.deque(maxlen=window)
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probes = 0
        _LIVE_BREAKERS.add(self)

    # -- state ---------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self):  # caller holds the lock
        if self._state == self.OPEN and \
                self._clock() - self._opened_at >= self.reset_timeout_s:
            self._state = self.HALF_OPEN
            self._probes = 0

    def _open(self):  # caller holds the lock
        self._state = self.OPEN
        self._opened_at = self._clock()
        self._outcomes.clear()
        _BREAKER_OPENS.labels(name=self.name).inc()

    def retry_after_s(self) -> float:
        """Seconds until the next probe is admitted (0 when not open)."""
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(0.0, self.reset_timeout_s
                       - (self._clock() - self._opened_at))

    # -- protocol ------------------------------------------------------------
    def allow(self) -> bool:
        """True if a call may proceed right now (reserves a half-open probe
        slot — pair every allowed call with a record_success/failure)."""
        with self._lock:
            self._maybe_half_open()
            if self._state == self.OPEN:
                return False
            if self._state == self.HALF_OPEN:
                if self._probes >= self.half_open_max_calls:
                    return False
                self._probes += 1
            return True

    def record_success(self):
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._state = self.CLOSED
                self._outcomes.clear()
                self._probes = 0
            else:
                self._outcomes.append(True)

    def _emit_open(self, cause: str) -> None:
        """Decision event for an OPEN transition — emitted OUTSIDE the
        breaker lock (the lock is a declared leaf). Callers may still hold
        THEIR locks here (the router resolves probes under its own); emit is
        safe there — sink I/O runs on the event log's drain thread, never
        on this thread."""
        from ..observability import events as _ev

        _ev.emit("breaker.open", severity="warning", name=self.name,
                 cause=cause)

    def record_failure(self):
        opened = False
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._open()
                opened = True
            else:
                self._outcomes.append(False)
                if sum(1 for ok in self._outcomes if not ok) \
                        >= self.failure_threshold:
                    self._open()
                    opened = True
        if opened:
            self._emit_open("failures")

    def trip(self):
        """Force the circuit OPEN immediately, regardless of the outcome
        window — out-of-band eviction (a health registry declaring the
        guarded component dead shouldn't wait for ``failure_threshold``
        doomed calls to discover it). The normal open → half-open → probe
        readmission path applies from here."""
        opened = False
        with self._lock:
            if self._state != self.OPEN:
                self._open()
                opened = True
            else:
                self._opened_at = self._clock()   # restart the probe timer
        if opened:
            self._emit_open("tripped")

    def reset(self):
        """Force-close on out-of-band proof of recovery — the inverse of
        :meth:`trip`. A supervisor that SEES the guarded component healthy
        again (a re-registered host heartbeating) shouldn't make traffic
        wait out the reset timeout to rediscover it; the outcome window
        restarts clean."""
        with self._lock:
            self._state = self.CLOSED
            self._outcomes.clear()
            self._probes = 0

    def call(self, fn: Callable, *args, **kw) -> Any:
        """Run ``fn`` through the breaker; raises :class:`CircuitOpenError`
        without calling when open."""
        if not self.allow():
            raise CircuitOpenError(self.name, self.retry_after_s())
        try:
            result = fn(*args, **kw)
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return result


# --------------------------------------------------------------------------
# heartbeats / health
# --------------------------------------------------------------------------

class Heartbeat:
    """One component's liveness handle. ``beat()`` refreshes it; ``stop()``
    deregisters. Usable as a context manager."""

    def __init__(self, registry: "HealthRegistry", name: str):
        self.registry = registry
        self.name = name

    def beat(self, **meta):
        self.registry.beat(self.name, **meta)

    def stop(self):
        self.registry.deregister(self.name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class HealthRegistry:
    """Last-beat bookkeeping for a set of named components.

    A component is *alive* while its most recent beat is younger than its
    timeout. ``status()`` is the ``/healthz`` payload; ``dead()`` drives the
    serving supervisor's respawn and the TaskPool watchdog.
    """

    _seq = 0
    # zoo-lock: leaf
    _seq_lock = traced_lock("HealthRegistry._seq_lock")

    def __init__(self, default_timeout_s: float = 5.0,
                 clock: Optional[Callable[[], float]] = None,
                 name: Optional[str] = None):
        self.default_timeout_s = default_timeout_s
        if name is None:
            with HealthRegistry._seq_lock:
                HealthRegistry._seq += 1
                name = f"hr{HealthRegistry._seq}"
        self.name = name     # distinguishes registries on the shared scrape
        self._clock = clock or time.monotonic
        # zoo-lock: guards(_entries, _listeners, _last_dead) — transition
        # listeners fire OUTSIDE it (check_transitions), so listing a
        # callback here would be a hold-hazard, not a convenience
        self._lock = traced_lock("HealthRegistry._lock")
        self._entries: Dict[str, Dict[str, Any]] = {}
        # liveness-transition listeners (fleet eviction/readmission hooks):
        # fired by check_transitions(), never under the lock
        self._listeners: List[Callable[[str, bool], None]] = []
        self._last_dead: set = set()
        _LIVE_REGISTRIES.add(self)

    def register(self, name: str, timeout_s: Optional[float] = None,
                 **meta) -> Heartbeat:
        with self._lock:
            self._entries[name] = {
                "last": self._clock(),
                "timeout_s": (self.default_timeout_s if timeout_s is None
                              else timeout_s),
                "beats": 0,
                "meta": dict(meta),
            }
        return Heartbeat(self, name)

    def beat(self, name: str, **meta):
        with self._lock:
            e = self._entries.get(name)
            if e is None:  # implicit registration keeps call sites simple
                self._entries[name] = e = {
                    "last": 0.0, "timeout_s": self.default_timeout_s,
                    "beats": 0, "meta": {}}
            e["last"] = self._clock()
            e["beats"] += 1
            if meta:
                e["meta"].update(meta)

    def deregister(self, name: str):
        with self._lock:
            self._entries.pop(name, None)

    def _age(self, e) -> float:
        return self._clock() - e["last"]

    def alive(self, name: str) -> bool:
        with self._lock:
            e = self._entries.get(name)
            return e is not None and self._age(e) < e["timeout_s"]

    def beats(self, name: str) -> int:
        """How many times ``name`` has beaten since its last register()."""
        with self._lock:
            e = self._entries.get(name)
            return 0 if e is None else e["beats"]

    def components(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def dead(self) -> List[str]:
        with self._lock:
            return sorted(n for n, e in self._entries.items()
                          if self._age(e) >= e["timeout_s"])

    def add_transition_listener(self,
                                fn: Callable[[str, bool], None]) -> None:
        """Subscribe ``fn(component, alive)`` to liveness TRANSITIONS:
        called with ``alive=False`` when a component's heartbeat goes stale
        (eviction hook — e.g. trip a replica's circuit breaker) and
        ``alive=True`` when a previously-dead component beats again or is
        re-registered (readmission hook). Transitions are detected by
        :meth:`check_transitions`, which the supervising loop must poll."""
        with self._lock:
            self._listeners.append(fn)

    def check_transitions(self) -> List[Tuple[str, bool]]:
        """Diff liveness against the last check and fire listeners for every
        component that changed state. Listeners run OUTSIDE the registry
        lock (they typically call back into breakers/routers that may read
        this registry). Returns the ``(component, alive)`` transition list.

        A deregistered component produces no transition — deregistration is
        deliberate shutdown, not death."""
        with self._lock:
            dead_now = {n for n, e in self._entries.items()
                        if self._age(e) >= e["timeout_s"]}
            newly_dead = dead_now - self._last_dead
            # revived = was dead at last check AND still registered AND alive
            revived = {n for n in self._last_dead - dead_now
                       if n in self._entries}
            self._last_dead = dead_now
            listeners = list(self._listeners)
        transitions = [(n, False) for n in sorted(newly_dead)] + \
                      [(n, True) for n in sorted(revived)]
        for name, alive in transitions:
            for fn in listeners:
                try:
                    fn(name, alive)
                except Exception:   # a broken listener must not stop the
                    pass            # supervisor loop or its peers
        return transitions

    def healthy(self) -> bool:
        return not self.dead()

    def status(self) -> Dict[str, Any]:
        """``/healthz`` payload: overall status + per-component detail."""
        with self._lock:
            comps = {
                n: {"alive": self._age(e) < e["timeout_s"],
                    "age_s": round(self._age(e), 3),
                    "beats": e["beats"],
                    **({"meta": e["meta"]} if e["meta"] else {})}
                for n, e in self._entries.items()}
        return {"status": "ok" if all(c["alive"] for c in comps.values())
                else "unhealthy",
                "components": comps}


__all__ = ["CircuitBreaker", "CircuitOpenError", "DeadlineExceededError",
           "HealthRegistry", "Heartbeat", "ResilienceError",
           "RetryAbortedError", "RetryExhaustedError", "RetryPolicy",
           "RetryTracker"]
