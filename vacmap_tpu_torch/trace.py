"""Lightweight stage tracing/metrics.

The reference has no tracing (vestigial commented timers,
SURVEY.md section 5).  Here every pipeline stage can be timed with a
near-zero-overhead accumulator; enable with VACMAP_TPU_TRACE=1 or
``trace.enable()``.  The CLI prints the summary at exit.

While tracing is on, every closed span is also kept as a record
(``Span``): its id, the id of the span open around it on its thread
(``parent``, 0 at the top), an optional ``cause`` (the id of a span on
another thread that it serves), the read id of the ``read`` context
around it, the recording thread (a number of this module's, one a
thread), its name, its start and end on the shared clock (``now_ns``)
and the thread's CPU nanoseconds inside it (``time.thread_time_ns``;
the rest of its wall time the thread was off the CPU: blocked, asleep,
or waiting for the interpreter lock).  Each thread appends to a buffer
of its own; ``events()`` gathers them.  ``count`` keeps counters.

The shared clock is the epoch clock that torch.profiler (Kineto) stamps
its events on: one (``time.time_ns``, ``time.perf_counter_ns``) pair is
taken when tracing is switched on, and the clock advances by
``perf_counter_ns`` from there, so it never steps within a run.  A
record minus the profiler's ``trace_start_ns()`` is on the device
trace's axis.  This module imports no torch: the host path imports it.

Off, each instrumented point costs one flag check: ``span`` and ``read``
hand back one shared object that does nothing, and no clock is read.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

_enabled = os.environ.get("VACMAP_TPU_TRACE", "") not in ("", "0")
_lock = threading.Lock()
_times = defaultdict(float)
_counts = defaultdict(int)
_counters: Dict[str, int] = defaultdict(int)
_ids = itertools.count(1)
_tids = itertools.count(1)
_tls = threading.local()
_threads: list = []  # [(threading.Thread, _Thread)], every buffer made
_clock = (time.time_ns(), time.perf_counter_ns())


class Span(NamedTuple):
    id: int
    parent: int
    cause: int
    read: Optional[str]
    tid: int
    name: str
    t0: int    # ns, shared clock
    t1: int
    cpu: int   # ns of this thread's CPU time inside the span


class _Thread:
    __slots__ = ("buf", "stack", "read", "tid")

    def __init__(self, tid: int):
        self.buf: List[tuple] = []  # Span fields
        self.stack: List[int] = []
        self.read: Optional[str] = None
        self.tid = tid


def _state() -> _Thread:
    st = getattr(_tls, "st", None)
    if st is None:
        with _lock:
            st = _Thread(next(_tids))
            _threads.append((threading.current_thread(), st))
        _tls.st = st
    return st


def now_ns() -> int:
    """Nanoseconds since the epoch on the shared clock."""
    return _clock[0] + time.perf_counter_ns() - _clock[1]


def enable(on: bool = True) -> None:
    global _enabled, _clock
    if on and not _enabled:
        _clock = (time.time_ns(), time.perf_counter_ns())
    _enabled = on


def enabled() -> bool:
    return _enabled


class _Off:
    """What ``span`` and ``read`` give while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """One open span.  ``cause`` may be set while it is open."""

    __slots__ = ("name", "cause", "id", "parent", "read", "st", "t0", "c0")

    def __init__(self, name: str):
        self.name = name
        self.cause = 0

    def __enter__(self):
        st = self.st = _state()
        self.id = next(_ids)
        self.parent = st.stack[-1] if st.stack else 0
        st.stack.append(self.id)
        self.read = st.read
        # the CPU reading inside the wall one; the two clocks' steps differ,
        # so the CPU time is capped at the wall time
        self.t0 = time.perf_counter_ns()
        self.c0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        c1 = time.thread_time_ns()
        t1 = time.perf_counter_ns()
        cpu = min(c1 - self.c0, t1 - self.t0)
        st = self.st
        st.stack.pop()
        off = _clock[0] - _clock[1]
        # a plain tuple here (a Span costs ten times as much to make)
        st.buf.append((self.id, self.parent, self.cause, self.read, st.tid,
                       self.name, self.t0 + off, t1 + off, cpu))
        with _lock:
            _times[self.name] += (t1 - self.t0) / 1e9
            _counts[self.name] += 1
        return False


def span(name: str):
    """A context that times ``name``; while tracing is on it yields the
    open span (its ``id``; ``cause`` may be set), else None."""
    if not _enabled:
        return _OFF
    return _Open(name)


class _Read:
    __slots__ = ("read_id", "st", "prev")

    def __init__(self, read_id):
        self.read_id = read_id

    def __enter__(self):
        st = self.st = _state()
        self.prev, st.read = st.read, self.read_id
        return None

    def __exit__(self, *exc):
        self.st.read = self.prev
        return False


def read(read_id):
    """A context that stamps every span opened inside it on this thread
    with ``read_id``."""
    if not _enabled:
        return _OFF
    return _Read(read_id)


def current() -> int:
    """The id of this thread's innermost open span (0: none, or off)."""
    if not _enabled:
        return 0
    stack = _state().stack
    return stack[-1] if stack else 0


def add(name: str, seconds: float, n: int = 1) -> None:
    if _enabled:
        with _lock:
            _times[name] += seconds
            _counts[name] += n


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if _enabled:
        with _lock:
            _counters[name] += n


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def events() -> List[Span]:
    """Every record kept since the last ``reset``, by start."""
    with _lock:
        bufs = [st.buf for _, st in _threads]
    return sorted((Span._make(e) for b in bufs for e in list(b)),
                  key=lambda e: e.t0)


def self_and_cpu(evs) -> Dict[str, tuple]:
    """{name: (self seconds, on-CPU seconds)} over records: self time is a
    span's duration minus that of its children (spans whose parent it
    is)."""
    child = defaultdict(int)
    for e in evs:
        if e.parent:
            child[e.parent] += e.t1 - e.t0
    out: Dict[str, list] = {}
    for e in evs:
        s = out.setdefault(e.name, [0.0, 0.0])
        s[0] += (e.t1 - e.t0 - child.get(e.id, 0)) / 1e9
        s[1] += e.cpu / 1e9
    return {k: tuple(v) for k, v in out.items()}


def summary() -> str:
    with _lock:
        times, counts = dict(_times), dict(_counts)
        ctrs = dict(_counters)
    if not times and not ctrs:
        return "trace: no spans recorded"
    out = []
    if times:
        sc = self_and_cpu(events())
        total = sum(times.values())
        rows = sorted(times.items(), key=lambda kv: -kv[1])
        out.append("stage                      total_s   calls    avg_ms   "
                   "share   self_s  on_cpu_s")
        for name, t in rows:
            n = counts[name]
            s, c = (f"{v:8.2f}" for v in sc[name]) if name in sc else (
                f"{'-':>8}", f"{'-':>8}")
            out.append(
                f"{name:<26} {t:8.2f} {n:7d} {t / max(n, 1) * 1e3:9.2f} "
                f"{t / total * 100:6.1f}% {s} {c:>9}"
            )
    else:
        out.append("trace: no spans recorded")
    if ctrs:
        out.append("counter                        count")
        for name, v in sorted(ctrs.items()):
            out.append(f"{name:<26} {v:9d}")
    return "\n".join(out)


def reset() -> None:
    """Clear the sums, the counters and every thread's records (those of
    threads started before the reset too); buffers of threads that have
    ended are dropped."""
    with _lock:
        _times.clear()
        _counts.clear()
        _counters.clear()
        for _, st in _threads:
            st.buf.clear()
        _threads[:] = [(t, st) for t, st in _threads if t.is_alive()]
