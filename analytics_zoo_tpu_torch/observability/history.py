"""Metrics history — multi-resolution ring buffers behind the live registry.
(port of ``analytics_zoo_tpu/observability/history.py``, which needs no JAX:
a copy over the port's own telemetry registry).

``GET /metrics`` is a point-in-time scrape; every question an operator (or
the SLO engine) actually asks is about a WINDOW — "what's the error rate
over the last minute", "p99 over the last ten". This module runs a
background sampler over the telemetry registry into ring buffers at several
resolutions (default 1s × 10min and 10s × 2h) and answers ``rate()`` /
``delta()`` / ``quantile_over_time()`` queries from them — the in-process
sliver of a real TSDB, enough to make burn-rate alerting and the ``/debug``
sparklines self-contained.

Samples are full ``registry.snapshot(buckets=True)`` dicts, so histogram
quantiles over a window come from DIFFERENCING cumulative bucket counts
between the window's edges (the ``histogram_quantile(rate(...))`` identity),
not from re-observing anything.

All locks here are plain terminal ``threading.Lock`` (telemetry rationale);
listeners fire outside them.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..common import telemetry as _tm

__all__ = ["MetricsHistory", "DEFAULT_RESOLUTIONS"]

#: (step seconds, ring capacity): 1s grain for 10 minutes, 10s for 2 hours
DEFAULT_RESOLUTIONS: Tuple[Tuple[float, int], ...] = ((1.0, 600),
                                                      (10.0, 720))


class _Ring:
    __slots__ = ("step", "buf", "last_ts")

    def __init__(self, step: float, capacity: int):
        import collections

        self.step = step
        self.buf: "Any" = collections.deque(maxlen=capacity)
        self.last_ts = float("-inf")


class MetricsHistory:
    """Background sampler + window queries over a telemetry registry."""

    def __init__(self, registry: Optional[_tm.MetricRegistry] = None,
                 resolutions: Sequence[Tuple[float, int]]
                 = DEFAULT_RESOLUTIONS,
                 clock: Optional[Callable[[], float]] = None):
        if not resolutions:
            raise ValueError("need at least one (step_s, capacity) ring")
        self._registry = registry or _tm.default_registry()
        self._rings = [_Ring(float(s), int(c))
                       for s, c in sorted(resolutions)]
        self._clock = clock or time.time
        self._lock = threading.Lock()
        self._listeners: List[Callable[[float], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_taken = 0

    # -- sampling ------------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> None:
        """Take one sample (the background loop calls this; tests drive it
        directly with a synthetic ``now``)."""
        now = self._clock() if now is None else now
        snap = self._registry.snapshot(buckets=True)
        with self._lock:
            for ring in self._rings:
                # keep one sample per step (the finest ring keeps them all)
                if now - ring.last_ts >= ring.step - 1e-9:
                    ring.buf.append((now, snap))
                    ring.last_ts = now
            self.samples_taken += 1
            listeners = list(self._listeners)
        for fn in listeners:       # outside the lock (SLO evaluation etc.)
            try:
                fn(now)
            except Exception:
                pass

    def add_listener(self, fn: Callable[[float], None]) -> None:
        """``fn(now)`` after every base-resolution sample — how the SLO
        engine rides the sampler's clock instead of running its own."""
        with self._lock:
            self._listeners.append(fn)

    def start(self, interval_s: Optional[float] = None) -> "MetricsHistory":
        if self._thread is not None:
            return self
        interval = interval_s if interval_s is not None \
            else self._rings[0].step
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.sample()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="zoo-metrics-history")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- window access ---------------------------------------------------------

    def _window(self, window_s: float,
                now: Optional[float] = None) -> List[Tuple[float, dict]]:
        """Samples covering the last ``window_s`` seconds, from the finest
        ring whose CAPACITY (step × maxlen) spans the window — a ring that
        merely hasn't run long enough yet still serves its partial data
        (falling back to a coarser ring there would return FEWER points,
        not more)."""
        now = self._clock() if now is None else now
        with self._lock:
            chosen = None
            for ring in self._rings:
                if not ring.buf:
                    continue
                chosen = ring
                if ring.step * ring.buf.maxlen >= window_s - 1e-9:
                    break          # this ring can hold the whole window
            if chosen is None:
                return []
            buf = list(chosen.buf)
        cutoff = now - window_s
        return [(ts, snap) for ts, snap in buf if ts >= cutoff]

    @staticmethod
    def _value(snap: dict, name: str, key: str = "",
               field: str = "count") -> Optional[Any]:
        fam = snap.get(name)
        if fam is None:
            return None
        sample = fam["samples"].get(key)
        if isinstance(sample, dict):
            return sample.get(field)
        return sample

    def series(self, name: str, key: str = "", window_s: float = 60.0,
               field: str = "count",
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """``[(ts, value)]`` for one sample key over the window. ``key`` is
        the snapshot label-values key (comma-joined label values, ``""`` for
        unlabeled); ``field`` selects ``count``/``sum`` on histograms."""
        out = []
        for ts, snap in self._window(window_s, now=now):
            v = self._value(snap, name, key, field)
            if v is not None:
                out.append((ts, float(v)))
        return out

    def keys(self, name: str,
             now: Optional[float] = None) -> List[str]:
        """Sample keys (label-value combinations) seen for ``name`` in the
        newest sample."""
        for ts, snap in reversed(self._window(float("inf"), now=now)):
            fam = snap.get(name)
            if fam is not None:
                return sorted(fam["samples"])
        return []

    def delta(self, name: str, key: str = "", window_s: float = 60.0,
              field: str = "count", now: Optional[float] = None
              ) -> Optional[float]:
        """Increase of a cumulative value over the window (counter/histogram
        count/sum). A reset (value went down — process restart) clamps to
        the end value, Prometheus ``increase()`` style."""
        pts = self.series(name, key, window_s, field=field, now=now)
        if len(pts) < 2:
            return None
        d = pts[-1][1] - pts[0][1]
        return d if d >= 0 else pts[-1][1]

    def rate(self, name: str, key: str = "", window_s: float = 60.0,
             field: str = "count", now: Optional[float] = None
             ) -> Optional[float]:
        """Per-second increase over the window."""
        pts = self.series(name, key, window_s, field=field, now=now)
        if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
            return None
        d = pts[-1][1] - pts[0][1]
        if d < 0:
            d = pts[-1][1]
        return d / (pts[-1][0] - pts[0][0])

    def sum_delta(self, name: str, window_s: float = 60.0,
                  field: str = "count",
                  key_pred: Optional[Callable[[str], bool]] = None,
                  now: Optional[float] = None) -> float:
        """Summed :meth:`delta` across every sample key matching
        ``key_pred`` (all keys when ``None``) — e.g. all 5xx codes of
        ``zoo_http_requests_total``."""
        pts = self._window(window_s, now=now)
        if len(pts) < 2:
            return 0.0
        total = 0.0
        first, last = pts[0][1], pts[-1][1]
        fam = last.get(name)
        if fam is None:
            return 0.0
        for key in fam["samples"]:
            if key_pred is not None and not key_pred(key):
                continue
            v1 = self._value(last, name, key, field)
            v0 = self._value(first, name, key, field) or 0.0
            if v1 is None:
                continue
            d = float(v1) - float(v0)
            total += d if d >= 0 else float(v1)
        return total

    # -- histogram-over-time ---------------------------------------------------

    def bucket_delta(self, name: str, key: str = "",
                     window_s: float = 60.0, now: Optional[float] = None
                     ) -> List[Tuple[float, float]]:
        """Cumulative ``(le, count)`` ladder of observations WITHIN the
        window: end-of-window buckets minus start-of-window buckets."""
        pts = self._window(window_s, now=now)
        if not pts:
            return []
        end = self._value(pts[-1][1], name, key, "buckets")
        if not end:
            return []
        start = self._value(pts[0][1], name, key, "buckets") \
            if len(pts) > 1 else None
        start_by_le = dict(start) if start else {}
        out = []
        for le, cum in end:
            d = cum - start_by_le.get(le, 0)
            out.append((le, float(max(0, d))))
        return out

    def fraction_le(self, name: str, key: str, le: float,
                    window_s: float = 60.0, now: Optional[float] = None
                    ) -> Tuple[float, float]:
        """``(good, total)`` observation counts within the window, where
        good = observations at/under the LARGEST bucket bound <= ``le``
        (bucket-aligned strictly: an observation above the declared
        threshold can never count as good, at the cost of the effective
        threshold rounding DOWN to a bucket bound)."""
        ladder = self.bucket_delta(name, key, window_s, now=now)
        if not ladder:
            return 0.0, 0.0
        total = ladder[-1][1]
        good = 0.0
        for b, cum in ladder:
            if b <= le + 1e-12:
                good = cum
            else:
                break
        return good, total

    def quantile_over_time(self, name: str, key: str, q: float,
                           window_s: float = 60.0,
                           now: Optional[float] = None) -> Optional[float]:
        """Interpolated quantile of the observations made WITHIN the window
        (``histogram_quantile`` over the bucket-count delta)."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile must be in [0, 1], got {q!r}")
        ladder = self.bucket_delta(name, key, window_s, now=now)
        if not ladder or ladder[-1][1] <= 0:
            return None
        total = ladder[-1][1]
        rank = q * total
        prev_le, prev_cum = 0.0, 0.0
        for le, cum in ladder:
            if cum >= rank:
                if le == float("inf"):
                    return prev_le      # open-ended top bucket: lower bound
                if cum == prev_cum:
                    return le
                frac = (rank - prev_cum) / (cum - prev_cum)
                return prev_le + (le - prev_le) * frac
            prev_le, prev_cum = le, cum
        return ladder[-1][0]
