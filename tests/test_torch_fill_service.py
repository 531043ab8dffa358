"""vacmap_tpu_torch's fill service (parallel/fill_service.py) on the CPU:
the service pipeline around TorchFillAligner's plain kernel versions,
held to the host aligner and to the reference service's routing
(tests/test_fill_service.py's cases, in-process and cross-process)."""

import threading

import numpy as np
import pytest
import torch

from vacmap_tpu.ops.affine_ref import align2p
from vacmap_tpu.pipeline.extend import _host_global_batch
from vacmap_tpu_torch import DeviceKernelError
from vacmap_tpu_torch.ops.affine_fill import (
    BANDED, TorchFillAligner, fill_rowruns_banded_ref, make_qshift,
)
from vacmap_tpu_torch.parallel import fill_service as fs
from vacmap_tpu_torch.parallel.fill_service import (
    AsyncFillAligner, async_fill_aligner, start_fill_server, unpack_pairs,
)


def _rand_pair(rng, lo=3, hi=400, mut=0.1):
    lt = int(rng.integers(lo, hi))
    t = rng.integers(0, 4, lt).astype(np.uint8)
    q = t.copy()
    nmut = int(len(q) * mut)
    if nmut:
        pos = rng.integers(0, len(q), nmut)
        q[pos] = (q[pos] + rng.integers(1, 4, nmut)) % 4
    if rng.random() < 0.3 and len(q) > 10:
        cut = int(rng.integers(1, len(q) // 2))
        q = q[:-cut] if rng.random() < 0.5 else q[cut:]
    return t, q


def _cigars(pairs, eqx):
    return [
        align2p(t, q, match=2, mismatch=-4, gap_open_1=4, gap_extend_1=2,
                gap_open_2=24, gap_extend_2=1, bw=-1, zdrop=-1, eqx=eqx).cigar
        for t, q in pairs
    ]


def _svc(**kw):
    svc = async_fill_aligner("cpu", max_wait_ms=kw.pop("max_wait_ms", 1.0),
                             **kw)
    assert svc.ready.wait(60) and svc.core.error is None
    return svc


def _msg(svc, handle, timeout=60):
    """The service's raw response to an in-process submit."""
    box = handle[0]
    assert box["event"].wait(timeout)
    return box["msg"]


@pytest.mark.parametrize("eqx", [False, True])
def test_async_aligner_matches_host(rng, eqx):
    svc = _svc()
    try:
        pairs = [_rand_pair(rng) for _ in range(40)]
        # oversize (host inside decode) + empty-side jobs
        pairs.append((rng.integers(0, 4, 900).astype(np.uint8),
                      rng.integers(0, 4, 880).astype(np.uint8)))
        pairs.append((np.zeros(0, np.uint8), np.array([1, 2], np.uint8)))
        got = svc.align_batch(pairs, eqx=eqx)
        assert [g.cigar for g in got] == _cigars(pairs, eqx)
    finally:
        svc.stop()


def test_async_aligner_is_attached_with_window_jobs():
    svc = _svc()
    try:
        assert isinstance(svc, AsyncFillAligner)
        assert svc.wants_window_jobs and svc.accepting()
        assert isinstance(svc.core.aligner, TorchFillAligner)
        assert svc.core.aligner.device == torch.device("cpu")
        pairs = [(np.array([0, 1, 2], np.uint8), np.array([0, 1, 2], np.uint8))]
        # no device edit-distance kernel: all None, no round trip
        assert svc.edit_batch(pairs) == [None]
    finally:
        svc.stop()


def test_async_aligner_concurrent_requests():
    """Many threads with requests in flight: per-request routing stays
    correct when the service batches across them."""
    svc = _svc(max_wait_ms=5.0)
    errs = []

    def one(seed):
        r = np.random.default_rng(seed)
        pairs = [_rand_pair(r) for _ in range(int(r.integers(1, 12)))]
        got = svc.align_batch(pairs, eqx=True)
        if [g.cigar for g in got] != _cigars(pairs, True):
            errs.append(seed)

    try:
        threads = [threading.Thread(target=one, args=(s,)) for s in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errs
    finally:
        svc.stop()


def test_submit_wait_out_of_order(rng):
    svc = _svc()
    try:
        batches = [[_rand_pair(rng) for _ in range(5)] for _ in range(6)]
        handles = [svc.submit(b, eqx=False) for b in batches]
        for h, b in list(zip(handles, batches))[::-1]:  # reversed waits
            assert [g.cigar for g in svc.wait(h)] == _cigars(b, False)
        assert svc.wait(svc.submit([], False)) == []
    finally:
        svc.stop()


def test_ambiguous_code4_jobs_route_to_host(rng):
    """Jobs holding base code 4 take the host slot, as in the reference,
    and still return exact results."""
    svc = _svc()
    try:
        pairs = []
        for i in range(5):
            t = rng.integers(0, 4, 120 + i).astype(np.uint8)
            q = t.copy()
            q[::7] = (q[::7] + 1) % 4
            if i % 2:
                t[3] = 4  # ambiguous base
            pairs.append((t, q))
        h = svc.submit(pairs, eqx=False)
        host = [s for s in _msg(svc, h).values() if s[0] == "host"]
        assert len(host) == 1 and sorted(host[0][1]) == [1, 3]
        want = _host_global_batch(pairs, eqx=False)
        assert [g.cigar for g in svc.wait(h)] == [w.cigar for w in want]
    finally:
        svc.stop()


def _escalating_pairs(n, seed=7):
    """Unrelated pairs of 180-240 bp, with the jobs the banded kernel flags
    (its plain version on the same padded batch as the service's)."""
    rng = np.random.default_rng(seed)
    pairs = [(rng.integers(0, 4, int(rng.integers(180, 240))).astype(np.uint8),
              rng.integers(0, 4, int(rng.integers(180, 240))).astype(np.uint8))
             for _ in range(n)]
    tT = np.full((n, 256), 4, np.uint8)
    tQ = np.full((n, 256), 4, np.uint8)
    lens = np.zeros((n, 2), np.int32)
    for b, (t, q) in enumerate(pairs):
        tT[b, : len(t)] = t
        tQ[b, : len(q)] = q
        lens[b] = (len(t), len(q))
    qs = make_qshift(tQ, lens[:, 0], lens[:, 1], 256)
    planes = fill_rowruns_banded_ref(torch.from_numpy(tT), torch.from_numpy(qs),
                                     torch.from_numpy(lens)).numpy()
    return pairs, np.flatnonzero(planes[:, 256] & 0x80).tolist()


def test_banded_route_engages_and_escalations_go_to_host():
    pairs, flagged = _escalating_pairs(12)
    assert flagged  # the corpus does escalate
    svc = _svc()
    try:
        assert svc.core.band_ids == (256 | BANDED, 512 | BANDED)
        h = svc.submit(pairs, eqx=True)
        msg = _msg(svc, h)
        assert {k[0] for k in msg if k[0] != -1} == {256 | BANDED}
        assert sorted(msg[(-1, 0)][1]) == flagged
        got = svc.wait(h)
        want = _host_global_batch([pairs[i] for i in flagged], True)
        assert [got[i].cigar for i in flagged] == [w.cigar for w in want]
        with svc.core._stats_lock:
            assert svc.core._stats["escal"] == len(flagged)
    finally:
        svc.stop()


def test_no_banded_fill_env_turns_the_band_off(monkeypatch):
    monkeypatch.setenv("VACMAP_TPU_NO_BANDED_FILL", "1")
    svc = _svc()
    try:
        assert not svc.core.aligner.banded and svc.core.band_ids == ()
        pairs = [_rand_pair(np.random.default_rng(8)) for _ in range(6)]
        h = svc.submit(pairs, eqx=True)
        assert all(k[0] in (256, 512, -1) for k in _msg(svc, h))
        assert [g.cigar for g in svc.wait(h)] == _cigars(pairs, True)
    finally:
        svc.stop()


def test_scan_route_through_the_service(monkeypatch):
    """VACMAP_TPU_FILL_SCAN=1: full-width jobs come back as packed op
    columns (the scan kernel's stream) and decode to the host CIGARs."""
    monkeypatch.setenv("VACMAP_TPU_FILL_SCAN", "1")
    rng = np.random.default_rng(9)
    pairs = []
    for _ in range(4):  # |dq| > 95: not band-eligible
        t = rng.integers(0, 4, int(rng.integers(60, 200))).astype(np.uint8)
        p = int(rng.integers(0, len(t)))
        ins = rng.integers(0, 4, int(rng.integers(100, 160))).astype(np.uint8)
        pairs.append((t, np.concatenate([t[:p], ins, t[p:]])))
    svc = _svc()
    try:
        h = svc.submit(pairs, eqx=True)
        assert {s[0] for s in _msg(svc, h).values()} == {"packed"}
        assert [g.cigar for g in svc.wait(h)] == _cigars(pairs, True)
    finally:
        svc.stop()


class _RaisingAligner(TorchFillAligner):
    def dispatch_padded(self, *args, **kw):
        raise RuntimeError("injected launch failure")


def test_raising_aligner_surfaces_as_device_kernel_error(rng):
    """A failing device call reaches the waiting caller as
    DeviceKernelError, never as host CIGARs, and later submits raise."""
    svc = AsyncFillAligner(_RaisingAligner(device="cpu"), prewarm=False,
                           max_wait_ms=1.0)
    try:
        assert svc.ready.wait(60)
        h = svc.submit([_rand_pair(rng) for _ in range(3)], eqx=True)
        with pytest.raises(DeviceKernelError, match="injected launch failure"):
            svc.wait(h)
        with pytest.raises(DeviceKernelError):
            svc.submit([_rand_pair(rng)], eqx=True)
    finally:
        svc.stop()


def test_failing_prewarm_raises_on_submit(rng):
    svc = AsyncFillAligner(_RaisingAligner(device="cpu"), max_wait_ms=1.0)
    try:
        assert svc.ready.wait(60)
        assert svc.core.error is not None
        with pytest.raises(DeviceKernelError):
            svc.align_batch([_rand_pair(rng)], eqx=True)
    finally:
        svc.stop()


def test_calibrated_no_go_stays_on_host(rng, monkeypatch):
    """--device-fills auto: a device slower than the host fills stays
    unused (the reference's calibrated no-go)."""
    monkeypatch.setattr(fs._ServerCore, "_calibrate", lambda self: False)
    svc = async_fill_aligner("cpu", force=False, max_wait_ms=1.0)
    try:
        assert svc.ready.wait(60) and svc.failed and not svc.accepting()
        pairs = [_rand_pair(rng) for _ in range(4)]
        h = svc.submit(pairs, eqx=True)
        assert h[0] == "host"
        assert [g.cigar for g in svc.wait(h)] == _cigars(pairs, True)
    finally:
        svc.stop()


def test_backpressure_gate_in_process(rng, monkeypatch):
    monkeypatch.setattr(fs, "MAX_INFLIGHT_JOBS", 8)
    svc = _svc()
    try:
        batches = [[_rand_pair(rng) for _ in range(6)] for _ in range(5)]
        handles = [svc.submit(b, eqx=False) for b in batches]
        assert sum(1 for h in handles if h[0] == "host") >= 3
        for h, b in zip(handles, batches):
            assert [g.cigar for g in svc.wait(h)] == _cigars(b, False)
        assert svc._pending_n == 0
    finally:
        svc.stop()


def test_deferred_mapper_matches_sync(small_genome, rng):
    """map_read_deferred + finish == map_read, record for record, with the
    port's service as the global aligner."""
    from vacmap_tpu.config import AlignerConfig
    from vacmap_tpu.index import ReferenceIndex
    from vacmap_tpu.pipeline.mapper import Mapper
    from vacmap_tpu_torch.config import AlignerConfig as PortConfig
    from vacmap_tpu_torch.index import ReferenceIndex as PortIndex
    from vacmap_tpu_torch.pipeline.mapper import Mapper as PortMapper
    from vacmap_tpu_torch.pipeline.mapper import PendingLines

    # the JAX package's host mapper is the reference; the port's mapper
    # runs with the port's service
    sync_mapper = Mapper(ReferenceIndex.build(small_genome, k=15, w=10),
                         AlignerConfig(mode="H"))
    svc = _svc()
    async_mapper = PortMapper(PortIndex.build(small_genome, k=15, w=10),
                              PortConfig(mode="H"), global_aligner=svc)
    try:
        genome = small_genome["c1"]
        reads = []
        for i in range(6):
            st = int(rng.integers(0, len(genome) - 6000))
            frag = genome[st : st + 5000]
            if i % 2:  # deletion SV: two distant windows spliced
                frag = frag[:2000] + genome[st + 3200 : st + 6000]
            reads.append((f"r{i}", frag))
        pendings = [async_mapper.map_read_deferred(n, s) for n, s in reads]
        for (name, seq), r in zip(reads, pendings):
            got = r.finish() if isinstance(r, PendingLines) else r
            assert got == sync_mapper.map_read(name, seq), name
    finally:
        svc.stop()


def test_async_window_bound_stage_matches_sync(small_genome, rng):
    """The divergence window-bound batch defers to the service (the
    aligner sets wants_window_jobs); SAM lines, including the keep/drop
    decisions on junk segments, equal the synchronous host path."""
    from vacmap_tpu.config import AlignerConfig
    from vacmap_tpu.index import ReferenceIndex
    from vacmap_tpu.pipeline.mapper import Mapper
    from vacmap_tpu_torch import trace
    from vacmap_tpu_torch.config import AlignerConfig as PortConfig
    from vacmap_tpu_torch.index import ReferenceIndex as PortIndex
    from vacmap_tpu_torch.pipeline.mapper import Mapper as PortMapper
    from vacmap_tpu_torch.pipeline.mapper import PendingLines

    idx = ReferenceIndex.build(small_genome, k=15, w=10)
    cfg = AlignerConfig(mode="H")
    genome = small_genome["c1"]
    reads = []
    for i in range(6):
        st = int(rng.integers(0, len(genome) - 9000))
        frag = genome[st : st + 4000]
        mid = genome[st + 4000 : st + 6000]
        if i % 2:  # divergence-droppable middle
            junk = "".join("ACGT"[int(rng.integers(4))] for _ in range(1800))
            mid = mid[:100] + junk + mid[-100:]
        reads.append((f"w{i}", frag + mid + genome[st + 6000 : st + 9000]))
    want = [tuple(Mapper(idx, cfg).map_read(n, s)) for n, s in reads]
    svc = _svc()
    try:
        m = PortMapper(PortIndex.build(small_genome, k=15, w=10),
                       PortConfig(mode="H"), global_aligner=svc)
        trace.enable()
        trace.reset()
        try:
            pendings = [m.map_read_deferred(n, s) for n, s in reads]
            got = [tuple(r.finish() if isinstance(r, PendingLines) else r)
                   for r in pendings]
            s = trace.summary()
        finally:
            trace.enable(False)
            trace.reset()
        # the window stage engaged: rf.diverg ran in the continuation
        assert "rf.diverg" in s and "refine_cont" in s and "fill_wait" in s
    finally:
        svc.stop()
    assert got == want


# ---------------------------------------------------------------------------
# cross-process transport
# ---------------------------------------------------------------------------


def test_pack_roundtrip_of_the_transport(rng):
    pairs = [_rand_pair(rng) for _ in range(17)]
    out = unpack_pairs(*fs.pack_pairs(pairs))
    assert all(np.array_equal(t, t2) and np.array_equal(q, q2)
               for (t, q), (t2, q2) in zip(pairs, out))


def test_cross_process_server(rng):
    handle = start_fill_server(2, "cpu", prewarm=False, ready_timeout=60)
    assert handle is not None
    try:
        c0, c1 = handle.client(0), handle.client(1)
        p0 = [_rand_pair(rng) for _ in range(9)]
        p1 = [_rand_pair(rng) for _ in range(7)]
        h0 = c0.submit(p0, eqx=True)
        h1 = c1.submit(p1, eqx=False)
        assert h0[0] != "hostq" and h1[0] != "hostq"
        assert [g.cigar for g in c0.wait(h0, timeout=60)] == _cigars(p0, True)
        assert [g.cigar for g in c1.wait(h1, timeout=60)] == _cigars(p1, False)
        assert c0.edit_batch(p0) == [None] * len(p0)
        assert handle.error() is None
    finally:
        assert handle.stop() is None


def test_backpressure_gate_bounces_to_host(rng, monkeypatch):
    """With the in-flight cap tiny, overload submits host-fill instead of
    queueing; admitted requests still resolve and the shared counter
    drains back to zero; the shared route counters add up."""
    monkeypatch.setattr(fs, "MAX_INFLIGHT_JOBS", 8)
    handle = start_fill_server(1, "cpu", prewarm=False, ready_timeout=60)
    try:
        c = handle.client(0)
        batches = [[_rand_pair(rng) for _ in range(6)] for _ in range(5)]
        handles = [c.submit(b, eqx=True) for b in batches]
        # 8-job cap, 6-job batches: at most 2 admitted before any drain
        assert sum(1 for h in handles if h[0] == "hostq") >= 3
        for h, b in zip(handles, batches):
            assert [g.cigar for g in c.wait(h, timeout=60)] == _cigars(b, True)
        assert handle.pending_ctr.value == 0
        sub, off, capped, governed = handle.routes[:]
        n_host = sum(len(b) for h, b in zip(handles, batches) if h[0] == "hostq")
        assert (sub, off + capped, capped, governed) == (30, 30, n_host, 0)
    finally:
        handle.stop()


def test_round_trip_is_measured_at_the_service_send(rng):
    """The latency governor's round trip ends when the service sends the
    response, not when the worker drains it (a deferred window drains
    late without keeping anyone waiting)."""
    import time

    handle = start_fill_server(1, "cpu", prewarm=False, ready_timeout=60)
    try:
        c = handle.client(0)
        pairs = [_rand_pair(rng, hi=60) for _ in range(3)]
        h = c.submit(pairs, eqx=True)
        time.sleep(1.5)  # the worker maps other reads meanwhile
        assert [g.cigar for g in c.wait(h, timeout=60)] == _cigars(pairs, True)
        assert 0 <= handle.lat_sh.value < 1.0
    finally:
        handle.stop()


_GEN_CLIENTS: list = []  # fork-inherited (mp queues cannot be pickled)


def _gen_chunk(args):
    """Top-level pool fn (fork ctx) for the two-generation test."""
    idx, seed = args
    r = np.random.default_rng(seed)
    pairs = [_rand_pair(r) for _ in range(8)]
    got = _GEN_CLIENTS[idx].align_batch(pairs, eqx=True, timeout=60)
    return [g.cigar for g in got] == _cigars(pairs, True)


def test_two_pool_generations_share_clients():
    """Two sequential fork-pool generations reuse the same clients (a CLI
    re-run); the poll-then-recv drain leaves the queues' cross-process
    locks free at worker exit."""
    import multiprocessing as mp

    handle = start_fill_server(2, "cpu", prewarm=False, ready_timeout=60)
    try:
        _GEN_CLIENTS[:] = [handle.client(i) for i in range(2)]
        for gen in range(2):
            with mp.get_context("fork").Pool(2) as pool:
                res = pool.map_async(_gen_chunk,
                                     [(i, 100 * gen + i) for i in range(2)])
                assert all(res.get(timeout=120)), f"generation {gen}"
    finally:
        _GEN_CLIENTS.clear()
        handle.stop()


def _raising_make_aligner(buckets, device):
    return _RaisingAligner(buckets=buckets, device=device)


def test_cross_process_device_error_reaches_client_and_parent(rng, monkeypatch):
    monkeypatch.setattr(fs, "_make_aligner", _raising_make_aligner)
    handle = start_fill_server(1, "cpu", prewarm=False, ready_timeout=60)
    try:
        c = handle.client(0)
        h = c.submit([_rand_pair(rng) for _ in range(3)], eqx=True)
        with pytest.raises(DeviceKernelError, match="injected launch failure"):
            c.wait(h, timeout=60)
        assert "injected launch failure" in handle.error()
        with pytest.raises(DeviceKernelError):
            c.submit([_rand_pair(rng)], eqx=True)
    finally:
        assert "injected launch failure" in handle.stop()


def test_server_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(DeviceKernelError):
        start_fill_server(1, "cuda", ready_timeout=60)


def test_stats_line_counts_routes_and_launches_after_prewarm(rng, monkeypatch,
                                                             tmp_path):
    """The stats line reports the clients' routes beside the jobs the
    kernels served, and the fill kernels' launches since the service
    became ready (none on the CPU, where the plain versions run)."""
    stats = tmp_path / "stats.txt"
    monkeypatch.setenv("VACMAP_TPU_FILL_STATS", str(stats))
    svc = _svc()
    try:
        pairs = [_rand_pair(rng, lo=20, hi=200) for _ in range(10)]
        t = rng.integers(0, 4, 100).astype(np.uint8)
        pairs.append((t, t.copy()))
        pairs[-1][0][5] = 4  # code 4: the host slot
        got = svc.align_batch(pairs, eqx=True)
        assert [g.cigar for g in got] == _cigars(pairs, True)
    finally:
        assert svc.stop() is None
    st = dict(kv.split("=", 1) for kv in stats.read_text().split())
    assert (st["submitted"], st["offloaded"], st["capped"], st["governed"],
            st["not_ready"], st["host_slot"]) == ("11", "11", "0", "0", "0", "1")
    served = int(st["jobs"]) - int(st["escal"])
    assert int(st["jobs"]) == 10
    assert float(st["device_share"]) == pytest.approx(served / 11, abs=1e-4)
    launches = dict(kv.split(":") for kv in st["launches"].split(","))
    assert launches == {"fill_full": "0", "fill_banded": "0", "fill_scan": "0"}


def _silent_client(pending=None):
    """A client on queues no service reads, as of a service that is alive
    but stopped answering."""
    import multiprocessing as mp

    ctx = mp.get_context("fork")
    ready = ctx.Event()
    ready.set()
    return fs.FillClient(0, ctx.Queue(), ctx.Queue(), ready_evt=ready,
                         status=ctx.Value("i", fs.SERVING),
                         err_buf=ctx.Array("c", 64), pending_ctr=pending,
                         lat_sh=ctx.Value("d", -1.0))


def test_late_response_raises_instead_of_host_fill(rng):
    """A request sent to the service and not answered within the wait's
    bound raises DeviceKernelError; it is never quietly redone on the
    host, and its in-flight slots are released."""
    import multiprocessing as mp

    pending = mp.get_context("fork").Value("l", 0)
    c = _silent_client(pending)
    h = c.submit([_rand_pair(rng) for _ in range(3)], eqx=True)
    assert h[0] not in (None, "hostq") and pending.value == 3
    with pytest.raises(DeviceKernelError, match="no response"):
        c.wait(h, timeout=0.3)
    assert pending.value == 0


def _sleep_forever():
    import time

    time.sleep(120)


def test_stop_reports_a_service_that_does_not_exit():
    """stop() returns an error when the service process does not exit
    within its join (then terminates it)."""
    import multiprocessing as mp

    ctx = mp.get_context("fork")
    proc = ctx.Process(target=_sleep_forever, daemon=True)
    proc.start()
    ready = ctx.Event()
    ready.set()
    handle = fs.FillServerHandle(
        proc, ctx.Queue(), [ctx.Queue()], ready, ctx.Value("i", fs.SERVING),
        ctx.Array("c", 64), ctx.Value("l", 0), ctx.Value("d", -1.0),
        ctx.Array("q", 4))
    msg = handle.stop(timeout=0.5)
    assert msg is not None and "did not exit" in msg
    assert not proc.is_alive()


def test_gate_refusals_are_counted_by_cause(rng):
    """A closed latency governor and the in-flight cap each count their
    own bounced jobs."""
    import multiprocessing as mp

    pending = mp.get_context("fork").Value("l", fs.MAX_INFLIGHT_JOBS)
    c = _silent_client(pending)
    h = c.submit([_rand_pair(rng) for _ in range(2)], eqx=True)  # cap
    c._lat_sh.value = 10 * fs.MAX_LAT_S
    h2 = c.submit([_rand_pair(rng) for _ in range(3)], eqx=True)  # governor
    assert h[0] == h2[0] == "hostq"
    assert c._routes[:] == [5, 0, 2, 3]
    assert len(c.wait(h)) == 2 and len(c.wait(h2)) == 3


# ---------------------------------------------------------------------------
# the edit job kind (exact edit distances for the divergence filter)
# ---------------------------------------------------------------------------

EDIT_BUCKETS = ((256, 8), (512, 24))


def _edit_aligner(device="cpu"):
    from vacmap_tpu_torch.ops.myers import TorchMyersAligner

    return TorchMyersAligner(device, buckets=EDIT_BUCKETS)


def _edit_pairs(rng):
    """Routed pairs of both buckets, then the unroutable ones: oversized
    text, oversized pattern, an empty side, a code 4 on either side."""
    routed = [_rand_pair(rng, lo=3, hi=250) for _ in range(14)]
    routed += [_rand_pair(rng, lo=300, hi=500) for _ in range(5)]
    t = rng.integers(0, 4, 200).astype(np.uint8)
    tn = t.copy()
    tn[7] = 4
    unroutable = [
        (rng.integers(0, 4, 600).astype(np.uint8), t),
        (t, rng.integers(0, 4, 24 * 32 + 1).astype(np.uint8)),
        (np.zeros(0, np.uint8), t), (t, np.zeros(0, np.uint8)),
        (tn, t), (t, tn),
    ]
    return routed, unroutable


def _native_dists(pairs):
    from vacmap_tpu.native import edit_distance_native

    return [edit_distance_native(t, q) for t, q in pairs]


def test_edit_kind_in_process(rng, monkeypatch, tmp_path):
    """Routed distances are exact, exactly the unroutable jobs come back
    None, and the stats line counts the edit kind."""
    stats = tmp_path / "stats.txt"
    monkeypatch.setenv("VACMAP_TPU_FILL_STATS", str(stats))
    routed, unroutable = _edit_pairs(rng)
    pairs = routed[:10] + unroutable + routed[10:]
    svc = _svc(edit_aligner=_edit_aligner())
    try:
        assert svc.core.edit_ready == frozenset(EDIT_BUCKETS)
        got = svc.edit_batch(pairs)
        assert got[:10] + got[16:] == _native_dists(routed)
        assert got[10:16] == [None] * 6
        assert svc.edit_batch([]) == [] and svc._pending_n == 0
        # fills and edits in flight together
        fills = [_rand_pair(rng) for _ in range(6)]
        h = svc.submit(fills, eqx=True)
        assert svc.edit_batch(routed[:3]) == _native_dists(routed[:3])
        assert [g.cigar for g in svc.wait(h)] == _cigars(fills, True)
    finally:
        assert svc.stop() is None
    st = dict(kv.split("=", 1) for kv in stats.read_text().split())
    n = len(pairs) + 3
    assert (st["edit_submitted"], st["edit_sent"], st["edit_not_live"],
            st["edit_capped"], st["edit_governed"]) == (str(n), str(n), "0",
                                                        "0", "0")
    assert (st["edit_served"], st["edit_unrouted"]) == (str(n - 6), "6")
    assert int(st["edit_calls"]) >= 3 and st["edit_launches"] == "0"
    assert (st["submitted"], st["jobs"]) == ("6", "6")


def test_edit_batch_short_circuits_while_no_kernel_is_live(rng, monkeypatch):
    """No edit aligner (the default deployment, VACMAP_TPU_EDIT_DEVICE
    unset): all None at once, nothing queued, counted as not live."""
    monkeypatch.delenv("VACMAP_TPU_EDIT_DEVICE", raising=False)
    svc = _svc()
    try:
        assert svc.core.edit_aligner is None and not svc.core.edit_ready
        pairs = [_rand_pair(rng) for _ in range(4)]
        assert svc.edit_batch(pairs) == [None] * 4
        assert svc.req_q.empty() and svc._pending_n == 0
        assert svc.core.edit_routes[:] == [4, 0, 0, 0, 4]
    finally:
        svc.stop()


def test_make_edit_aligner_reads_the_switch(monkeypatch):
    from vacmap_tpu_torch.ops.myers import DEFAULT_BUCKETS, TorchMyersAligner

    monkeypatch.delenv("VACMAP_TPU_EDIT_DEVICE", raising=False)
    assert fs._make_edit_aligner(torch.device("cpu")) is None
    monkeypatch.setenv("VACMAP_TPU_EDIT_DEVICE", "1")
    ea = fs._make_edit_aligner(torch.device("cpu"))
    assert isinstance(ea, TorchMyersAligner)
    assert ea.device == torch.device("cpu") and ea.buckets == DEFAULT_BUCKETS
    svc = _svc()
    try:
        assert svc.core.edit_ready == frozenset(DEFAULT_BUCKETS)
        t = np.array([0, 1, 2, 3, 0, 1], np.uint8)
        assert svc.edit_batch([(t, t[:4]), (t, t)]) == [2, 0]
    finally:
        svc.stop()


def test_edit_cap_is_counted_in_process(rng, monkeypatch):
    monkeypatch.setattr(fs, "MAX_INFLIGHT_JOBS", 0)
    svc = _svc(edit_aligner=_edit_aligner())
    try:
        assert svc.edit_batch([_rand_pair(rng) for _ in range(3)]) == [None] * 3
        assert svc.core.edit_routes[:] == [3, 0, 3, 0, 0]
        assert svc.req_q.empty()
    finally:
        svc.stop()


class _RaisingEditAligner:
    buckets = EDIT_BUCKETS
    shape_b = {256: 8, 512: 8}

    def prewarm(self, buckets=None):
        pass

    def dispatch_jobs(self, jobs, T, Wd):
        raise RuntimeError("injected edit launch failure")


def test_raising_edit_aligner_surfaces_as_device_kernel_error(rng):
    svc = _svc(edit_aligner=_RaisingEditAligner())
    try:
        with pytest.raises(DeviceKernelError, match="injected edit launch"):
            svc.edit_batch([_rand_pair(rng, hi=100) for _ in range(3)])
        with pytest.raises(DeviceKernelError):
            svc.edit_batch([_rand_pair(rng)])
        with pytest.raises(DeviceKernelError):
            svc.submit([_rand_pair(rng)], eqx=True)
    finally:
        svc.stop()


def _small_make_edit_aligner(device):
    return _edit_aligner(device)


def _raising_make_edit_aligner(device):
    return _RaisingEditAligner()


def test_edit_kind_cross_process(rng, monkeypatch):
    monkeypatch.setattr(fs, "_make_edit_aligner", _small_make_edit_aligner)
    handle = start_fill_server(2, "cpu", prewarm=False, ready_timeout=60)
    try:
        assert handle.edit_val.value == 1
        c0, c1 = handle.client(0), handle.client(1)
        routed, unroutable = _edit_pairs(rng)
        pairs = unroutable[:3] + routed + unroutable[3:]
        got = c0.edit_batch(pairs)
        assert got[3:-3] == _native_dists(routed)
        assert got[:3] == [None] * 3 and got[-3:] == [None] * 3
        fills = [_rand_pair(rng) for _ in range(5)]
        # the plain version's round trip is slow here; keep the latency
        # governor open for the requests below
        handle.lat_sh.value = 0.0
        h = c1.submit(fills, eqx=True)
        handle.lat_sh.value = 0.0
        assert c1.edit_batch(routed[:4]) == _native_dists(routed[:4])
        assert [g.cigar for g in c1.wait(h, timeout=60)] == _cigars(fills, True)
        assert handle.pending_ctr.value == 0
        n = len(pairs) + 4
        assert handle.edit_routes[:] == [n, n, 0, 0, 0]
        assert handle.routes[:] == [5, 5, 0, 0]
        assert handle.error() is None
    finally:
        assert handle.stop() is None


def test_edit_kind_cross_process_not_live_by_default(rng, monkeypatch):
    monkeypatch.delenv("VACMAP_TPU_EDIT_DEVICE", raising=False)
    handle = start_fill_server(1, "cpu", prewarm=False, ready_timeout=60)
    try:
        assert handle.edit_val.value == 0
        c = handle.client(0)
        assert c.edit_batch([_rand_pair(rng) for _ in range(3)]) == [None] * 3
        assert handle.edit_routes[:] == [3, 0, 0, 0, 3]
        assert handle.pending_ctr.value == 0
    finally:
        assert handle.stop() is None


def test_cross_process_edit_error_reaches_client_and_parent(rng, monkeypatch):
    monkeypatch.setattr(fs, "_make_edit_aligner", _raising_make_edit_aligner)
    handle = start_fill_server(1, "cpu", prewarm=False, ready_timeout=60)
    try:
        c = handle.client(0)
        with pytest.raises(DeviceKernelError, match="injected edit launch"):
            c.edit_batch([_rand_pair(rng, hi=100) for _ in range(3)])
        assert "injected edit launch" in handle.error()
        with pytest.raises(DeviceKernelError):
            c.edit_batch([_rand_pair(rng)])
    finally:
        assert "injected edit launch" in handle.stop()


def _silent_edit_client(pending):
    import multiprocessing as mp

    c = _silent_client(pending)
    c._edit_val = mp.get_context("fork").Value("i", 1)
    return c


def test_late_edit_response_raises_instead_of_none(rng):
    """A sent edit request with no answer within the wait's bound raises;
    it is not handed back as None for the host ladder."""
    import multiprocessing as mp

    pending = mp.get_context("fork").Value("l", 0)
    c = _silent_edit_client(pending)
    with pytest.raises(DeviceKernelError, match="no edit response"):
        c.edit_batch([_rand_pair(rng) for _ in range(3)], timeout=0.3)
    assert pending.value == 0
    assert c._edit_routes[:] == [3, 3, 0, 0, 0]


def test_edit_gate_refusals_are_counted_by_cause(rng):
    import multiprocessing as mp

    pending = mp.get_context("fork").Value("l", fs.MAX_INFLIGHT_JOBS)
    c = _silent_edit_client(pending)
    assert c.edit_batch([_rand_pair(rng) for _ in range(2)]) == [None] * 2
    c._lat_sh.value = 10 * fs.MAX_LAT_S
    assert c.edit_batch([_rand_pair(rng) for _ in range(3)]) == [None] * 3
    c._edit_val.value = 0
    assert c.edit_batch([_rand_pair(rng) for _ in range(4)]) == [None] * 4
    assert c._edit_routes[:] == [9, 0, 2, 3, 4]
    assert c._routes[:] == [0, 0, 0, 0] and c.req_q.empty()


# ---------------------------------------------------------------------------
# the divergence filter's edit route
# ---------------------------------------------------------------------------


class _EditClient:
    """edit_batch through the plain-version aligner, None for pairs over
    its buckets (as the service answers)."""

    def __init__(self, raises=None):
        from vacmap_tpu_torch.ops.myers import TorchMyersAligner

        self.ta = TorchMyersAligner("cpu", buckets=((2048, 128),))
        self.calls = 0
        self.raises = raises

    def edit_batch(self, pairs):
        self.calls += 1
        if self.raises is not None:
            raise self.raises
        return [None if d < 0 or not len(t) or not len(q) else d
                for d, (t, q) in zip(self.ta.distance_batch(pairs), pairs)]


def _junk_read(genome, rng, st):
    """4 kb of the genome, 1.6 kb that matches nothing between two 100 bp
    matching ends, 3 kb more of the genome: the middle segment's span
    diverges beyond the filter's ratio."""
    junk = "".join("ACGT"[int(rng.integers(4))] for _ in range(1600))
    mid = genome[st + 4000 : st + 6000]
    return (genome[st : st + 4000] + mid[:100] + junk + mid[-100:]
            + genome[st + 6000 : st + 9000])


def _refine_inputs(small_genome, rng, n_reads=4):
    """The (args, kwargs) of every refine_chain call the port's mapper
    makes on a few reads, half of them with a junk middle."""
    from vacmap_tpu_torch.config import AlignerConfig as PortConfig
    from vacmap_tpu_torch.index import ReferenceIndex as PortIndex
    from vacmap_tpu_torch.pipeline import extend
    from vacmap_tpu_torch.pipeline import mapper as mapper_mod

    m = mapper_mod.Mapper(PortIndex.build(small_genome, k=15, w=10),
                   PortConfig(mode="H"))
    genome = small_genome["c1"]
    calls = []
    real = extend.refine_chain

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    mapper_mod.refine_chain = spy
    try:
        for i in range(n_reads):
            st = int(rng.integers(0, len(genome) - 9000))
            seq = (_junk_read(genome, rng, st) if i % 2
                   else genome[st : st + 7000])
            m.map_read(f"d{i}", seq)
    finally:
        mapper_mod.refine_chain = real
    assert calls
    return calls


def test_refine_chain_keeps_the_same_segments_with_the_edit_client(
        small_genome, rng):
    """The filter's decisions are exact either way: refine_chain with an
    edit client returns the segments and records it returns without."""
    from vacmap_tpu_torch.pipeline import extend

    seen = 0
    for a, kw in _refine_inputs(small_genome, rng):
        kw = {k: v for k, v in kw.items() if k != "global_aligner"}
        want = extend.refine_chain(*a, **kw)
        client = _EditClient()
        fill = extend._host_global_batch

        class Both:  # a global aligner that also answers edit_batch
            edit_batch = staticmethod(client.edit_batch)
            __call__ = staticmethod(lambda pairs, eqx=False: fill(pairs, eqx))

        got = extend.refine_chain(*a, **kw, global_aligner=Both())
        assert client.calls >= 1
        assert got == want
        seen += len(want[0])
    assert seen >= 4


def test_divergence_filter_decides_alike_with_the_edit_client(small_genome,
                                                              rng):
    """divergence_filter on a read's rebuilt segments: the same segments
    are kept with exact device distances as on the host ladder, a dropped
    junk segment included."""
    from vacmap_tpu_torch.pipeline import extend

    calls = []
    real = extend.divergence_filter

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    extend.divergence_filter = spy
    try:
        for a, kw in _refine_inputs(small_genome, rng, n_reads=6):
            kw = {k: v for k, v in kw.items() if k != "global_aligner"}
            real_refine = extend.refine_chain(*a, **kw)
            assert real_refine is not None
    finally:
        extend.divergence_filter = real
    assert calls
    kept = dropped = 0
    for a, kw in calls:
        kw = {k: v for k, v in kw.items()
              if k not in ("edit_client", "window_cache")}
        segs, codes, rc_codes, *rest = a
        # the read as it is, and with every other base replaced (about
        # 37% divergence, over the mode's 0.2): those spans are dropped
        noisy = codes.copy()
        noisy[::2] = rng.integers(0, 4, len(noisy[::2])).astype(codes.dtype)
        for rd, rc in ((codes, rc_codes), (noisy, (3 - noisy)[::-1])):
            args = (segs, rd, rc, *rest)
            want = real(*args, **kw, edit_client=None, window_cache={})
            client = _EditClient()
            got = real(*args, **kw, edit_client=client, window_cache={})
            assert client.calls == 1 and got == want
            kept += len(want)
            dropped += len(segs) - len(want)
    assert kept >= 1 and dropped >= 1


def test_device_error_in_edit_batch_ends_refine_chain(small_genome, rng):
    """A DeviceKernelError from edit_batch passes through the divergence
    filter (any other error there falls back to the host ladder)."""
    from vacmap_tpu_torch.pipeline import extend

    a, kw = _refine_inputs(small_genome, rng, n_reads=1)[0]
    kw = {k: v for k, v in kw.items() if k != "global_aligner"}
    want = extend.refine_chain(*a, **kw)
    fill = extend._host_global_batch

    def aligner(client):
        class Both:
            edit_batch = staticmethod(client.edit_batch)
            __call__ = staticmethod(lambda pairs, eqx=False: fill(pairs, eqx))
        return Both()

    with pytest.raises(DeviceKernelError, match="injected"):
        extend.refine_chain(*a, **kw, global_aligner=aligner(
            _EditClient(raises=DeviceKernelError("injected device fault"))))
    soft = _EditClient(raises=ValueError("a host-side error"))
    assert extend.refine_chain(*a, **kw, global_aligner=aligner(soft)) == want
    assert soft.calls >= 1
