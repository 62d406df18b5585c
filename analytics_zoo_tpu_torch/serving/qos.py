"""Serving quality-of-service primitives the decode loop needs (part of the
port of ``analytics_zoo_tpu/serving/qos.py``): the measured service-time
EMA and the chunked-prefill token budget.

Pure host code. Priorities, deadlines and shedding are not ported yet
(ROADMAP Queue 1 [6], serving remainder).
"""

from __future__ import annotations

import threading
from typing import Any, Dict


class ServiceTimeEMA:
    """Thread-safe EMA of observed service seconds. ``value()`` is 0.0
    until the first observation."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self._value = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        with self._lock:
            self._n += 1
            self._value = (seconds if self._n == 1
                           else (1 - self.alpha) * self._value
                           + self.alpha * seconds)

    def value(self) -> float:
        with self._lock:
            return self._value

    def observations(self) -> int:
        with self._lock:
            return self._n


def prefill_budget_from_slo(itl_target_s: float, decode_ema_s: float,
                            chunk_ema_s: float, chunk_tokens: int) -> int:
    """Per-loop-pass prefill token budget from an inter-token-latency
    target: the headroom a decode step leaves under the target, in whole
    chunks. No evidence yet (either EMA unobserved) or no headroom gives
    ONE chunk, the progress floor."""
    chunk_tokens = max(1, int(chunk_tokens))
    if chunk_ema_s <= 0.0 or decode_ema_s <= 0.0:
        return chunk_tokens                       # cold: floor of one chunk
    headroom = float(itl_target_s) - float(decode_ema_s)
    if headroom <= 0.0:
        return chunk_tokens                       # saturated: floor
    return max(1, int(headroom / float(chunk_ema_s))) * chunk_tokens


def prefill_budget_decision(inputs: Dict[str, Any]) -> Dict[str, Any]:
    """One prefill-budget verdict for the decode loop. ``inputs``:
    ``chunk_tokens``, ``static_budget`` (0 = unset), ``itl_target_s`` (or
    None), ``decode_ema_s``, ``chunk_ema_s``; extra keys are ignored.
    Returns ``{"budget_tokens", "chunks", "source"}``, ``source`` one of
    ``"slo"``, ``"static"`` and ``"floor"``."""
    chunk_tokens = max(1, int(inputs.get("chunk_tokens", 1)))
    itl = inputs.get("itl_target_s")
    if itl is not None and float(itl) > 0.0:
        budget = prefill_budget_from_slo(
            float(itl), float(inputs.get("decode_ema_s", 0.0)),
            float(inputs.get("chunk_ema_s", 0.0)), chunk_tokens)
        source = "slo"
    elif int(inputs.get("static_budget", 0)) > 0:
        budget = max(chunk_tokens, int(inputs["static_budget"]))
        source = "static"
    else:
        budget = chunk_tokens
        source = "floor"
    return {"budget_tokens": int(budget),
            "chunks": int(budget) // chunk_tokens, "source": source}


__all__ = ["ServiceTimeEMA", "prefill_budget_decision",
           "prefill_budget_from_slo"]
