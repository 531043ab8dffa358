"""The program's own records of a traced window, and the split of the
finish threads' time that the ``finish.*``, ``refine.fill_wait_*`` and
``local_rechain.agg_wait_*`` readers report.

The records are ``vacmap_tpu_torch.trace.Span``s (id, parent, cause,
read, tid, name, t0, t1 in ns, cpu in ns) and the counters the
program's ``trace.counters()``.  A context holds them under ``program``
(the records inside the window) and ``program_counters`` (their
deltas over it) where the cell puts them there.  The cell of this
benchmark does not (an edit of ``cell.py`` would): there they are read
from the program's trace module in this process, where the traced run
leaves them (it switches tracing off and does not reset it when the
window closes; it resets it as the window opens), and cut to the window
as the program saw it, from the first batch's seeding (``ex.prepare``)
to the end of the last batch (``ex.batch``).  A program whose trace
keeps no records, as before it had ``trace.events``, gives None, and so
does a context without a read in its window.
"""

from __future__ import annotations

from collections import defaultdict

AGG_WAITS = ("chain_agg.gather", "chain_agg.wait")
FILL_WAITS = ("fill_wait", "edit_wait")


def _is_wait(name: str) -> bool:
    return (name in FILL_WAITS or name.endswith("_agg.gather")
            or name.endswith("_agg.wait"))


def _clip(evs, lo: int, hi: int):
    """Records overlapping [lo, hi], cut to it (CPU time pro rata)."""
    out = []
    for e in evs:
        a, b = max(e.t0, lo), min(e.t1, hi)
        if b <= a and not (e.t0 == e.t1 and lo <= e.t0 <= hi):
            continue
        cpu = e.cpu if (a, b) == (e.t0, e.t1) else int(
            e.cpu * (b - a) / max(e.t1 - e.t0, 1))
        out.append(e._replace(t0=a, t1=b, cpu=cpu))
    return out


def records(ctx):
    """(records, counters) of the window, or None."""
    if "program" in ctx:
        return ctx["program"], ctx.get("program_counters", {})
    if "port_trace" not in ctx or not ctx.get("reads"):
        return None
    from vacmap_tpu_torch import trace

    if not hasattr(trace, "events"):
        return None
    evs = trace.events()
    starts = [e.t0 for e in evs if e.name == "ex.prepare"]
    ends = [e.t1 for e in evs if e.name == "ex.batch"]
    if not starts or not ends:
        return None
    return _clip(evs, min(starts), max(ends)), trace.counters()


def finish_split(ctx):
    """The finish threads' seconds in the window, split; None without
    records.  Finish threads are those that ran ``ex.finish``; ``n`` the
    most of them in one batch.  ``thread_s`` is n x the window's
    seconds, and

        on_cpu + agg_wait + fill_wait + gil_wait + barrier_idle
            = thread_s - outside_batches

    ``on_cpu``: CPU time inside ``ex.finish`` outside the named waits;
    ``agg_wait``, ``fill_wait``: wall time in ``chain_agg.gather`` and
    ``.wait``, in ``fill_wait`` and ``edit_wait``; ``gil_wait``: the
    rest of ``ex.finish``'s off-CPU time (the interpreter lock, mostly;
    also the chain aggregator's read-back, reported apart as
    ``agg_run_off_cpu``); ``barrier_idle``: time inside ``ex.batch``
    with no ``ex.finish`` open; ``outside_batches``: the window outside
    ``ex.batch`` (the main thread waits for the seeder, or hands on the
    records)."""
    if "program_split" in ctx:
        return ctx["program_split"]
    got = records(ctx)
    if got is None:
        return None
    evs, _ = got
    batches = [e for e in evs if e.name == "ex.batch"]
    finishes = [e for e in evs if e.name == "ex.finish"]
    if not batches or not finishes:
        return None
    fin_tids = {e.tid for e in finishes}
    n = max(len({f.tid for f in finishes if b.t0 <= f.t0 < b.t1})
            for b in batches)
    if not n:
        return None
    s = defaultdict(float)
    for e in evs:
        if e.tid not in fin_tids:
            continue
        wall, cpu = (e.t1 - e.t0) / 1e9, e.cpu / 1e9
        if e.name == "ex.finish":
            s["finish_wall"] += wall
            s["finish_cpu"] += cpu
        elif _is_wait(e.name):
            s["wait_wall"] += wall
            s["wait_cpu"] += cpu
            if e.name in AGG_WAITS:
                s["agg_wait"] += wall
            elif e.name in FILL_WAITS:
                s["fill_wait"] += wall
        elif e.name == "chain_agg.run":
            s["agg_run_off_cpu"] += wall - cpu
        elif e.name == "ex.sam":
            s["sam"] += wall
    in_batches = sum(b.t1 - b.t0 for b in batches) / 1e9
    window_s = ctx["window_s"]
    out = {
        "n": n,
        "thread_s": n * window_s,
        "on_cpu": s["finish_cpu"] - s["wait_cpu"],
        "agg_wait": s["agg_wait"],
        "fill_wait": s["fill_wait"],
        "gil_wait": (s["finish_wall"] - s["finish_cpu"]
                     - (s["wait_wall"] - s["wait_cpu"])),
        "barrier_idle": n * in_batches - s["finish_wall"],
        "outside_batches": n * (window_s - in_batches),
        "agg_run_off_cpu": s["agg_run_off_cpu"],
        "sam": s["sam"],
    }
    ctx["program_split"] = out
    return out
