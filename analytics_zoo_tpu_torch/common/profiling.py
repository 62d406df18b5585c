"""Profiling and tracing helpers (port of ``common/profiling.py``), over
``torch.profiler`` where the JAX package uses the XLA profiler.

* :func:`xprof_trace` records CPU activity and, where CUDA is available,
  CUDA activity (kernels, copies) for the block, and exports a Chrome trace
  (``trace.json``, for Perfetto or ``chrome://tracing``) into ``log_dir``.
* :func:`annotate` names a region: a ``record_function`` range in any
  trace that is recording (entered by ``telemetry.span``) and an
  observation of ``zoo_span_duration_seconds{span=name}`` in the port's
  registry, beside a log line with its wall time.
* :func:`profile_steps` runs ``warmup`` untraced steps, then ``steps``
  traced ones, synchronizing the device after each, and returns the traced
  steps' median wall time in milliseconds.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator

import torch

log = logging.getLogger("analytics_zoo_tpu_torch")

#: the Chrome trace's file name under ``log_dir``
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def xprof_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record a ``torch.profiler`` trace of the block (CUDA activity too
    where CUDA is available) and write it as ``log_dir/trace.json``.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region: a profiler range and a span observed in
    ``zoo_span_duration_seconds{span=name}``, then logged."""
    from . import telemetry

    t0 = time.perf_counter()
    with telemetry.span(name):
        yield
    log.info("%s: %.1f ms", name, (time.perf_counter() - t0) * 1e3)


def _sync(out) -> None:
    """Wait for the device work behind ``out`` (a tensor or a tree of
    them): every card in use is synchronized."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    elif isinstance(out, torch.Tensor):
        out.cpu()


def profile_steps(step_fn, args_iter, log_dir: str, *, warmup: int = 2,
                  steps: int = 5) -> float:
    """Run ``step_fn(*args)`` over argument tuples from ``args_iter``:
    ``warmup`` untraced steps, then ``steps`` traced ones (each a
    ``step_<i>`` range), the device synchronized after every step. Returns
    the traced steps' median wall time in ms; the trace is in
    ``log_dir/trace.json``."""
    times = []
    it = iter(args_iter)
    for _ in range(warmup):
        _sync(step_fn(*next(it)))
    with xprof_trace(log_dir):
        for i in range(steps):
            with torch.profiler.record_function(f"step_{i}"):
                t0 = time.perf_counter()
                _sync(step_fn(*next(it)))
                times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e3


__all__ = ["TRACE_FILE", "annotate", "profile_steps", "xprof_trace"]
