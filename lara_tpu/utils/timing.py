"""Phase timers: the device-side equivalent of the reference's hand-rolled phase
accounting (``/root/reference/src/subgradient_solver.hpp:199-203,335-351``
accumulates align/matching/update wall time per thread under ``omp critical``
and logs it at verbosity >= 1; ``src/lara.cpp:46,60`` reports total run
time).

The fused device solver runs every phase inside one XLA program, so the
per-phase split lives at a different altitude here: host-side buckets for
input parse, edge filter + model build, device solve, and output -- plus an
optional ``jax.profiler`` trace (``LARA_PROFILE=<dir>``) that captures the
true on-device op-level timeline for the phases the reference timed
individually.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict
from typing import Iterator

from lara_tpu.utils.logging import log

_BUCKETS: "OrderedDict[str, float]" = OrderedDict()
_COUNTS: "OrderedDict[str, int]" = OrderedDict()
# the driver's cross-chunk pipeline times device phases on a worker thread
# while the main thread times host phases -- serialize the accumulation
_LOCK = threading.Lock()


def reset() -> None:
    with _LOCK:
        _BUCKETS.clear()
        _COUNTS.clear()


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Accumulate wall time into the named bucket (thread-safe)."""
    start = time.monotonic()
    try:
        yield
    finally:
        elapsed = time.monotonic() - start
        with _LOCK:
            _BUCKETS[name] = _BUCKETS.get(name, 0.0) + elapsed
            _COUNTS[name] = _COUNTS.get(name, 0) + 1


def add(name: str, seconds: float) -> None:
    with _LOCK:
        _BUCKETS[name] = _BUCKETS.get(name, 0.0) + float(seconds)
        _COUNTS[name] = _COUNTS.get(name, 0) + 1


def snapshot() -> "OrderedDict[str, float]":
    """Copy of the accumulated phase buckets (seconds), for benchmark
    reporting (``bench.py`` records warm per-phase times per scale)."""
    with _LOCK:
        return OrderedDict(_BUCKETS)


def report() -> None:
    """Log the accumulated phase table at verbosity 1 (the reference's
    'Alignment time / Matching time / Update time' block)."""
    with _LOCK:
        rows = [(n, s, _COUNTS[n]) for n, s in _BUCKETS.items()]
    if not rows:
        return
    log(1, "Phase timings:")
    for name, seconds, count in rows:
        log(1, f"  {name:<28s} {seconds:8.3f} s  (x{count})")


@contextlib.contextmanager
def maybe_trace() -> Iterator[None]:
    """Wrap a region in a ``jax.profiler`` trace when ``LARA_PROFILE`` names
    a directory (view with TensorBoard / xprof)."""
    trace_dir = os.environ.get("LARA_PROFILE")
    if not trace_dir:
        yield
        return
    import jax.profiler

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log(1, f"profiler trace written to {trace_dir}")
