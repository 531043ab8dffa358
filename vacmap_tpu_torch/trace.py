"""Lightweight stage tracing/metrics.

The reference has no tracing (vestigial commented timers,
SURVEY.md section 5).  Here every pipeline stage can be timed with a
near-zero-overhead accumulator; enable with VACMAP_TPU_TRACE=1 or
``trace.enable()``.  The CLI prints the summary at exit.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_enabled = os.environ.get("VACMAP_TPU_TRACE", "") not in ("", "0")
_lock = threading.Lock()
_times = defaultdict(float)
_counts = defaultdict(int)


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


@contextmanager
def span(name: str):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _times[name] += dt
            _counts[name] += 1


def add(name: str, seconds: float, n: int = 1) -> None:
    if _enabled:
        with _lock:
            _times[name] += seconds
            _counts[name] += n


def summary() -> str:
    with _lock:
        if not _times:
            return "trace: no spans recorded"
        total = sum(_times.values())
        rows = sorted(_times.items(), key=lambda kv: -kv[1])
        out = ["stage                      total_s   calls    avg_ms   share"]
        for name, t in rows:
            n = _counts[name]
            out.append(
                f"{name:<26} {t:8.2f} {n:7d} {t / max(n, 1) * 1e3:9.2f} "
                f"{t / total * 100:6.1f}%"
            )
        return "\n".join(out)


def reset() -> None:
    with _lock:
        _times.clear()
        _counts.clear()
