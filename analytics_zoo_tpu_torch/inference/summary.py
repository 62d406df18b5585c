"""Inference observability: ``timing`` blocks + throughput counters (port
of ``analytics_zoo_tpu/inference/summary.py``, which needs no JAX).

``timing(name)`` aggregates the wall time of a block in-process and
observes ``zoo_timing_seconds{name}``; :class:`InferenceSummary` counts the
records, batches and latency an :class:`~.inference_model.InferenceModel`
serves, optionally mirrored to a TensorBoard event file.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

from ..common import telemetry as _tm
from ..common.locks import traced_lock

logger = logging.getLogger("analytics_zoo_tpu_torch.inference")

_TIMING_HIST = _tm.histogram(
    "zoo_timing_seconds",
    "Wall time of timing() blocks (buckets give the percentiles the "
    "count/total/max dict never could)", labels=("name",))


class _TimingStats:
    __slots__ = ("count", "total_s", "max_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0


_STATS: Dict[str, _TimingStats] = {}
# zoo-lock: leaf
_STATS_LOCK = traced_lock("summary._STATS_LOCK")


@contextlib.contextmanager
def timing(name: str, log: bool = False):
    """``with timing("preprocess"): ...`` — records wall time under ``name``.

    InferenceSupportive.scala's ``timing`` logs every call; here logging is
    opt-in (``log=True``) and aggregation is always on.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _STATS_LOCK:
            st = _STATS.setdefault(name, _TimingStats())
            st.count += 1
            st.total_s += dt
            st.max_s = max(st.max_s, dt)
        _TIMING_HIST.labels(name=name).observe(dt)
        if log:
            logger.info("%s time elapsed [%.3f ms]", name, dt * 1e3)


def timing_stats() -> Dict[str, Dict[str, float]]:
    with _STATS_LOCK:
        return {k: {"count": v.count, "total_s": v.total_s, "max_s": v.max_s,
                    "mean_s": v.total_s / max(v.count, 1)}
                for k, v in _STATS.items()}


def reset_timing_stats() -> None:
    with _STATS_LOCK:
        _STATS.clear()


class InferenceSummary:
    """Throughput/latency counters for a serving process, optionally mirrored to
    a TensorBoard event file (InferenceSummary.scala parity)."""

    def __init__(self, log_dir: Optional[str] = None, name: str = "inference"):
        # zoo-lock: guards(records, batches, total_latency_s)
        self._lock = traced_lock("InferenceSummary._lock")
        self.records = 0
        self.batches = 0
        self.total_latency_s = 0.0
        self._writer = None
        if log_dir is not None:
            import os

            from ..common.summary import EventWriter

            self._writer = EventWriter(os.path.join(log_dir, name))

    def add_batch(self, n_records: int, latency_s: float) -> None:
        with self._lock:
            self.records += n_records
            self.batches += 1
            self.total_latency_s += latency_s
            step = self.batches
        if self._writer is not None:
            self._writer.add_scalars(step, {
                "Throughput": n_records / max(latency_s, 1e-9),
                "Latency_ms": latency_s * 1e3,
            })

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                "records": self.records,
                "batches": self.batches,
                "mean_latency_s": self.total_latency_s / max(self.batches, 1),
                "throughput": self.records / max(self.total_latency_s, 1e-9),
            }

    def close(self):
        if self._writer is not None:
            self._writer.close()
