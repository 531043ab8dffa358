"""The device's side of a traced window, from ``torch.profiler``'s raw
events (the arithmetic of ``profile_port.py::device_events``): device
time by kernel and copy, the busy time as the union of their intervals,
and the longest idle gaps, each named by what the host was doing then
(the benchmark's own spans, ``spans.py``)."""

from __future__ import annotations

from typing import Dict, List, Tuple


def device_intervals(torch, prof) -> List[Tuple[str, float, float]]:
    """[(name, start s, end s)] of every kernel, copy and memset the
    profiler recorded, in seconds from the trace's start."""
    cuda = torch.autograd.DeviceType.CUDA
    res = prof.profiler.kineto_results
    if hasattr(res, "trace_start_ns"):
        t0 = res.trace_start_ns()
    else:
        t0 = res.trace_start_us() * 1000
    out = []
    for ev in res.events():
        if ev.device_type() != cuda:
            continue
        if hasattr(ev, "start_ns"):
            st, dur = ev.start_ns(), ev.duration_ns()
        else:
            st, dur = ev.start_us() * 1000, ev.duration_us() * 1000
        out.append((ev.name(), (st - t0) / 1e9, (st - t0 + dur) / 1e9))
    return out


def by_name(intervals) -> Dict[str, Tuple[int, float]]:
    """{name: (count, device seconds)}."""
    out: Dict[str, Tuple[int, float]] = {}
    for name, a, b in intervals:
        n, s = out.get(name, (0, 0.0))
        out[name] = (n + 1, s + (b - a))
    return out


def union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The busy periods inside [lo, hi]: the union of the intervals."""
    spans = sorted((max(a, lo), min(b, hi)) for _, a, b in intervals
                   if b > lo and a < hi)
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_gaps(busy, lo: float, hi: float) -> List[Tuple[float, float]]:
    edges = [lo] + [x for a, b in busy for x in (a, b)] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
