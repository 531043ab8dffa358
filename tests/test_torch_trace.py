"""The port's trace module: records with parents, read ids, thread CPU
time and counters; the aggregator's and the executor's spans."""

import threading
import time

import numpy as np
import pytest

from tests.conftest import random_dna
from vacmap_tpu_torch import trace


@pytest.fixture
def traced():
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.enable(False)
        trace.reset()


def by_name(evs, name):
    return [e for e in evs if e.name == name]


def test_parents_and_self_time(traced):
    with trace.span("outer"):
        with trace.span("inner"):
            time.sleep(0.01)
        with trace.span("inner"):
            time.sleep(0.01)
        time.sleep(0.01)
    evs = trace.events()
    (outer,) = by_name(evs, "outer")
    inner = by_name(evs, "inner")
    assert outer.parent == 0 and len(inner) == 2
    assert all(e.parent == outer.id for e in inner)
    assert len({outer.id, *(e.id for e in inner)}) == 3
    sc = trace.self_and_cpu(evs)
    children = sum(e.t1 - e.t0 for e in inner)
    assert sc["outer"][0] == pytest.approx(
        (outer.t1 - outer.t0 - children) / 1e9)
    assert sc["outer"][0] >= 0.009
    assert sc["inner"][0] == pytest.approx(children / 1e9)
    s = trace.summary()
    assert "self_s" in s and "on_cpu_s" in s


def test_read_id_is_inherited_by_nested_spans(traced):
    with trace.span("before"):
        pass
    with trace.read("r7"):
        with trace.span("a"):
            with trace.span("b"):
                pass
    with trace.span("after"):
        pass
    evs = {e.name: e for e in trace.events()}
    assert evs["a"].read == evs["b"].read == "r7"
    assert evs["before"].read is None and evs["after"].read is None


def test_thread_cpu_time_and_off_cpu_sleep(traced):
    with trace.span("sleep"):
        time.sleep(0.05)
    with trace.span("spin"):
        t = time.perf_counter()
        while time.perf_counter() - t < 0.03:
            pass
    evs = {e.name: e for e in trace.events()}
    for e in evs.values():
        assert 0 <= e.cpu <= e.t1 - e.t0
    sleep = evs["sleep"]
    assert sleep.t1 - sleep.t0 >= 0.05e9
    assert sleep.cpu < 0.2 * (sleep.t1 - sleep.t0)  # off the CPU
    # on the CPU while it spins, however busy the machine
    assert evs["spin"].cpu > max(sleep.cpu, 0.1 * (
        evs["spin"].t1 - evs["spin"].t0))


def test_shared_clock_is_the_epoch_clock(traced):
    assert abs(trace.now_ns() - time.time_ns()) < 50e6
    with trace.span("x"):
        pass
    (e,) = trace.events()
    assert abs(e.t0 - time.time_ns()) < 50e6


def test_reset_clears_a_live_thread_buffer(traced):
    recorded, go, done = (threading.Event() for _ in range(3))

    def worker():
        with trace.span("worker"):
            pass
        recorded.set()
        go.wait(10)
        with trace.span("worker_again"):
            pass
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert recorded.wait(10)
        assert [e.name for e in trace.events()] == ["worker"]
        trace.reset()
        assert trace.events() == []
        go.set()
        assert done.wait(10)
        assert [e.name for e in trace.events()] == ["worker_again"]
    finally:
        go.set()
        t.join(10)
    assert not t.is_alive()


def test_counters_in_counters_and_summary(traced):
    trace.count("jobs", 3)
    trace.count("jobs", 4)
    trace.count("once")
    assert trace.counters() == {"jobs": 7, "once": 1}
    s = trace.summary()
    assert "counter" in s
    assert any(line.split() == ["jobs", "7"] for line in s.splitlines())


def test_tracing_off_records_nothing():
    trace.reset()
    assert not trace.enabled()
    with trace.read("r"), trace.span("x") as sp:
        assert sp is None
    trace.count("c", 5)
    trace.add("y", 1.0)
    assert trace.current() == 0
    assert trace.events() == [] and trace.counters() == {}
    assert "no spans" in trace.summary()


def _run_threads(fns, timeout=20):
    ts = [threading.Thread(target=f) for f in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts)


def test_aggregator_gather_once_a_dispatch_others_wait(traced):
    from vacmap_tpu_torch.parallel.device_service import _Aggregator

    def run_group(key, payloads):
        time.sleep(0.05)
        return [p * 2 for p in payloads]

    agg = _Aggregator(run_group, max_wait_ms=200, max_jobs=10_000,
                      what="chain")
    barrier = threading.Barrier(3)
    got = {}

    def caller(i):
        def f():
            barrier.wait(10)
            got[i] = agg.submit("k", i)
        return f

    _run_threads([caller(i) for i in range(3)])
    assert got == {0: 0, 1: 2, 2: 4}
    evs = trace.events()
    c = trace.counters()
    assert c["chain_agg.dispatches"] == 1 and c["chain_agg.jobs"] == 3
    assert c["chain_agg.overlap"] == 0
    (gather,) = by_name(evs, "chain_agg.gather")
    (run,) = by_name(evs, "chain_agg.run")
    waits = by_name(evs, "chain_agg.wait")
    assert len(waits) == 2
    assert run.tid == gather.tid
    assert {w.tid for w in waits} | {gather.tid} == {e.tid for e in evs}
    assert gather.tid not in {w.tid for w in waits}
    # the waiters are off the CPU for the window and the group's run
    assert all(w.t1 - w.t0 >= 0.2e9 and w.cpu < 0.5 * (w.t1 - w.t0)
               for w in waits)


def test_aggregator_counts_overlapping_dispatches(traced):
    from vacmap_tpu_torch.parallel.device_service import _Aggregator

    first_running, release = threading.Event(), threading.Event()

    def run_group(key, payloads):
        if key == "slow":
            first_running.set()
            release.wait(10)
        return payloads

    agg = _Aggregator(run_group, max_wait_ms=5, max_jobs=10_000, what="align")

    def slow():
        agg.submit("slow", 1)

    def fast():
        assert first_running.wait(10)
        agg.submit("fast", 2)  # its own dispatch, while "slow" runs
        release.set()

    _run_threads([slow, fast])
    c = trace.counters()
    assert c["align_agg.dispatches"] == 2 and c["align_agg.overlap"] == 1
    runs = by_name(trace.events(), "align_agg.run")
    assert len(runs) == 2 and runs[0].t1 > runs[1].t0


def test_executor_spans_carry_read_ids(traced):
    from vacmap_tpu_torch.config import AlignerConfig
    from vacmap_tpu_torch.index import ReferenceIndex
    from vacmap_tpu_torch.pipeline.executor import TorchBatchExecutor
    from vacmap_tpu_torch.pipeline.mapper import Mapper

    rng = np.random.default_rng(77)
    genome = {"t1": random_dna(rng, 80_000)}
    reads = []
    for i in range(5):
        st = int(rng.integers(0, 80_000 - 5000))
        frag = genome["t1"][st : st + 5000]
        if i % 2:  # a deletion: two windows
            frag = frag[:2500] + genome["t1"][st + 3500 : st + 6000]
        reads.append((f"q{i}", frag))
    m = Mapper(ReferenceIndex.build(genome, k=15, w=10),
               AlignerConfig(mode="H"), device="cpu")
    ex = TorchBatchExecutor(m, device="cpu")
    try:
        assert m.global_aligner.ready.wait(120)
        trace.reset()
        got = ex.map_batch(reads, n_threads=2)
    finally:
        ex.close()
    evs = trace.events()
    by_id = {e.id: e for e in evs}
    finishes = by_name(evs, "ex.finish")
    mapped = [name for (name, _), lines in zip(reads, got) if lines]
    assert len(mapped) >= 4
    for name in mapped:
        (fin,) = [e for e in finishes if e.read == name]
        sams = [e for e in by_name(evs, "ex.sam") if e.read == name]
        assert len(sams) == 1 and sams[0].parent == fin.id
        assert sams[0].tid == fin.tid
        # every span of the read nests under its ex.finish
        for e in evs:
            if e.read == name and e.id != fin.id:
                p = e
                while p.parent and p.parent != fin.id:
                    p = by_id[p.parent]
                assert p.parent == fin.id, e.name
    (batch,) = by_name(evs, "ex.batch")
    (chain_dp,) = by_name(evs, "ex.chain_dp")
    assert chain_dp.parent == batch.id
    assert len(by_name(evs, "ex.prepare")) == 1
    assert len(by_name(evs, "seed")) == len(reads)
    # the service's dispatches name the finish-thread span that asked
    finish_tids = {e.tid for e in finishes}
    dispatches = by_name(evs, "fill_svc.dispatch")
    assert dispatches and trace.counters()["fill_svc.batches"] == len(
        dispatches)
    for d in dispatches:
        assert d.tid not in finish_tids
        assert by_id[d.cause].tid in finish_tids
    waits = by_name(evs, "fill_wait")
    assert waits and all(by_id[w.parent].name == "rf.fill" for w in waits)
