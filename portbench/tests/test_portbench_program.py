"""The readers of the program's own spans and counters against a window
built by hand: two finish threads with known waits, compute and idle."""

import pytest

from vacmap_tpu_torch import trace
from yardstick import program
from yardstick.cell import load_reader

MS = 1_000_000
_ids = iter(range(1, 1000))


def rec(tid, name, a, b, cpu=0, parent=0, read=None):
    """A record from ms."""
    return trace.Span(next(_ids), parent, 0, read, tid, name, a * MS, b * MS,
                      cpu * MS)


def window():
    """Window 0-1000 ms; the main thread's batch 0-900 ms.  Thread 2:
    one read 0-800 ms, 400 ms on the CPU, in it a 50 ms gather (5 ms of
    CPU) and a 100 ms fill wait.  Thread 3: one read 100-700 ms, 300 ms
    on the CPU, in it a 100 ms wait on the chain aggregator, a 50 ms edit
    wait and a 20 ms fill wait.  The service's thread 4 is no finish
    thread."""
    f2 = rec(2, "ex.finish", 0, 800, 400, read="a")
    f3 = rec(3, "ex.finish", 100, 700, 300, read="b")
    return [
        rec(1, "ex.batch", 0, 900, 10),
        f2, f3,
        rec(2, "chain_agg.gather", 100, 150, 5, parent=f2.id),
        rec(2, "chain_agg.run", 150, 170, 15, parent=f2.id),
        rec(2, "fill_wait", 200, 300, parent=f2.id),
        rec(2, "ex.sam", 790, 800, 10, parent=f2.id),
        rec(3, "chain_agg.wait", 150, 250, parent=f3.id),
        rec(3, "edit_wait", 300, 350, parent=f3.id),
        rec(3, "fill_wait", 400, 420, parent=f3.id),
        rec(4, "fill_svc.gather", 0, 900),
        rec(4, "fill_wait", 0, 900),
    ]


def ctx():
    return {"window_s": 1.0, "reads": 2, "mbp": 0.5, "spans": {},
            "port_trace": {}, "program": window(),
            "program_counters": {"chain_agg.jobs": 30,
                                 "chain_agg.dispatches": 12}}


def test_the_split_adds_up():
    s = program.finish_split(ctx())
    assert s["n"] == 2 and s["thread_s"] == 2.0
    assert s["on_cpu"] == pytest.approx(0.695)
    assert s["agg_wait"] == pytest.approx(0.150)
    assert s["fill_wait"] == pytest.approx(0.170)
    assert s["gil_wait"] == pytest.approx(1.4 - 0.7 - (0.32 - 0.005))
    assert s["barrier_idle"] == pytest.approx(0.4)
    assert s["outside_batches"] == pytest.approx(0.2)
    assert s["agg_run_off_cpu"] == pytest.approx(0.005)
    assert sum(s[k] for k in ("on_cpu", "agg_wait", "fill_wait", "gil_wait",
                              "barrier_idle", "outside_batches")) == (
        pytest.approx(s["thread_s"]))


@pytest.mark.parametrize("name, want", [
    ("local_rechain.agg_wait_s_per_mbp", 0.3),
    ("refine.fill_wait_s_per_mbp", 0.34),
    ("finish.gil_wait_frac", 0.385 / 2),
    ("finish.barrier_idle_frac", 0.2),
    ("chain_agg.jobs_per_launch", 2.5),
])
def test_reader_reads_the_hand_computed_value(name, want):
    read = load_reader(name)
    assert read(ctx()) == pytest.approx(want)
    without = ctx()
    del without["program"]
    without["reads"] = 0
    assert read(without) is None


def test_the_window_is_cut_from_the_program_trace(monkeypatch):
    """Without ``program`` in the context, the records come from the
    program's trace module, cut to the first seeding and the last batch's
    end; a trace without records (the parent's) reads as None."""
    recs = [
        rec(5, "ex.prepare", -50, 40, 30),
        rec(1, "ex.seed_wait", -70, -55),  # before the window: dropped
        *window(),
        rec(5, "ex.prepare", 880, 1000, 60),  # the next batch: cut
    ]
    recs = [r._replace(t0=r.t0 + 50 * MS, t1=r.t1 + 50 * MS) for r in recs]
    monkeypatch.setattr(trace, "events", lambda: list(recs))
    monkeypatch.setattr(trace, "counters", lambda: {
        "chain_agg.jobs": 30, "chain_agg.dispatches": 12})
    c = ctx()
    del c["program"], c["program_counters"]
    evs, counters = program.records(c)
    assert min(e.t0 for e in evs) == 0 and max(e.t1 for e in evs) == 950 * MS
    assert "ex.seed_wait" not in {e.name for e in evs}
    (nxt,) = [e for e in evs if e.name == "ex.prepare" and e.t0 > 0]
    assert nxt.t1 == 950 * MS and nxt.cpu == 10 * MS
    assert load_reader("finish.barrier_idle_frac")(c) == pytest.approx(0.2)
    assert load_reader("chain_agg.jobs_per_launch")(dict(c)) == 2.5
    monkeypatch.delattr(trace, "events")
    assert program.records(dict(c)) is None
