"""vacmap_tpu_torch fills (plain PyTorch versions, CPU) against the Pallas
kernels of ``vacmap_tpu.ops.affine_pallas`` in interpret mode: the lo|ex
planes and the scan route's packed op streams must be byte-identical.
The aligner's CIGARs must equal the host aligner's."""

import numpy as np
import pytest
import torch

from vacmap_tpu import native
from vacmap_tpu.ops.affine_pallas import (
    PallasFillAligner, _fill_and_rowruns, _fill_and_rowruns_banded,
    _fill_and_traceback, pack_chars, pack_plane,
)
from vacmap_tpu.ops.affine_ref import align2p
from vacmap_tpu_torch.ops.affine_fill import (
    BANDED, TorchFillAligner, band_eligible, fill_rowruns, fill_rowruns_banded,
    fill_rowruns_banded_ref, fill_rowruns_ref, fill_traceback,
    fill_traceback_ref, make_qshift,
)

GLOBAL = dict(match=2, mismatch=-4, gap_open_1=4, gap_extend_1=2,
              gap_open_2=24, gap_extend_2=1, bw=-1, zdrop=-1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mut(rng, L, err=0.08, ins=0, dele=0):
    t = rng.integers(0, 4, L).astype(np.uint8)
    q = t.copy()
    m = rng.random(L) < err
    q[m] = rng.integers(0, 4, int(m.sum()))
    if ins:
        p = int(rng.integers(1, L - 1))
        q = np.concatenate([q[:p], rng.integers(0, 4, ins).astype(np.uint8), q[p:]])
    if dele:
        p = int(rng.integers(1, L - 1 - dele))
        q = np.concatenate([q[:p], q[p + dele:]])
    return t, q.astype(np.uint8)


def _full_planes(cases, N):
    B = len(cases)
    tT = np.full((B, N), 4, np.uint8)
    tQ = np.full((B, N), 4, np.uint8)
    lens = np.zeros((B, 2), np.int32)
    for i, (t, q) in enumerate(cases):
        tT[i, : len(t)] = t
        tQ[i, : len(q)] = q
        lens[i] = (len(t), len(q))
    want = np.asarray(_fill_and_rowruns(pack_chars(tT, tQ), lens, N=N,
                                        interpret=True))
    got = fill_rowruns_ref(_t(tT), _t(tQ), _t(lens)).numpy()
    return got, want


def _banded_planes(pairs, T, W=128, R=16, tb=8):
    B = tb * ((len(pairs) + tb - 1) // tb)
    tT = np.zeros((B, T), np.uint8)
    tQ = np.zeros((B, T), np.uint8)
    t_len = np.ones(B, np.int32)
    q_len = np.ones(B, np.int32)
    for b, (t, q) in enumerate(pairs):
        tT[b, : len(t)] = t
        tQ[b, : len(q)] = q
        t_len[b] = len(t)
        q_len[b] = len(q)
    qs = make_qshift(tQ, t_len, q_len, T, W=W, R=R)
    lens = np.stack([t_len, q_len], axis=1).astype(np.int32)
    want = np.asarray(_fill_and_rowruns_banded(
        pack_plane(np.concatenate([tT, qs], axis=1)), lens, T=T, W=W, R=R,
        tb=tb, interpret=True))
    got = fill_rowruns_banded_ref(_t(tT), _t(qs), _t(lens), W=W, R=R).numpy()
    return got, want


def test_full_fill_planes_match_pallas():
    """The cases of test_affine_pallas.test_rowrun_traceback_interpret_exact:
    140 bp insert, 150 bp delete, 1 bp, full bucket, I and D drains."""
    rng = np.random.default_rng(21)
    N = 256
    cases = []
    t = rng.integers(0, 4, 100).astype(np.uint8)
    cases.append((t, np.concatenate(
        [t[:50], rng.integers(0, 4, 140).astype(np.uint8), t[50:]])))
    q = rng.integers(0, 4, 80).astype(np.uint8)
    cases.append((np.concatenate(
        [q[:30], rng.integers(0, 4, 150).astype(np.uint8), q[30:]]), q))
    cases.append((np.array([1], np.uint8), np.array([1], np.uint8)))
    tf = rng.integers(0, 4, N).astype(np.uint8)
    qf = tf.copy()
    m = rng.random(N) < 0.12
    qf[m] = rng.integers(0, 4, int(m.sum()))
    cases.append((tf, qf))
    cases.append((np.array([0, 1], np.uint8),
                  rng.integers(0, 4, 230).astype(np.uint8)))  # I drain
    cases.append((rng.integers(0, 4, 230).astype(np.uint8),
                  np.array([3, 1], np.uint8)))  # D drain
    for _ in range(2):
        cases.append(_mut(rng, int(rng.integers(40, N - 10)), err=0.1))
    got, want = _full_planes(cases, N)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_banded_fill_planes_match_pallas():
    """The job classes of test_affine_pallas.test_banded_kernel_exact_interpret
    (mutated, single big INS/DEL, high error, tiny, dq at the eligibility
    edge) plus an adversarial near-random pair (staircase class)."""
    rng = np.random.default_rng(22)
    T = 128
    pairs = []
    for i in range(12):
        L = int(rng.integers(20, T - 40))
        kind = i % 4
        if kind == 0:
            pairs.append(_mut(rng, L))
        elif kind == 1:
            pairs.append(_mut(rng, L, ins=int(rng.integers(1, 38))))
        elif kind == 2:
            pairs.append(_mut(rng, L, dele=int(rng.integers(1, min(38, L // 2)))))
        else:
            pairs.append(_mut(rng, L, err=0.25))
    t1 = rng.integers(0, 4, 30).astype(np.uint8)
    pairs.append((t1, np.concatenate(
        [t1[:15], rng.integers(0, 4, 90).astype(np.uint8), t1[15:]]
    ).astype(np.uint8)))  # dq = 90 (eligibility edge is 95)
    pairs.append((t1[:1], t1[:1].copy()))  # 1 bp
    lt = [len(t) for t, _ in pairs]
    lq = [len(q) for _, q in pairs]
    assert band_eligible(lt, lq).all()
    got, want = _banded_planes(pairs, T)
    np.testing.assert_array_equal(got, want)


def test_banded_fill_adversarial_pair_matches_pallas():
    """A near-random pair (test_affine_pallas:217's class): the band's
    suboptimality and its ESCALATE decision are reproduced exactly."""
    rng = np.random.default_rng(23)
    pairs = [(rng.integers(0, 4, int(rng.integers(150, 240))).astype(np.uint8),
              rng.integers(0, 4, int(rng.integers(150, 240))).astype(np.uint8))
             for _ in range(3)]
    pairs.append(_mut(rng, 200, err=0.08))
    got, want = _banded_planes(pairs, 256)
    np.testing.assert_array_equal(got, want)


def test_banded_fill_edge_escalation_matches_pallas():
    """test_affine_pallas.test_banded_kernel_edge_escalation_flag: a 26 bp
    tandem duplication under a W=32/R=2 band fires ESCALATE (ex bit 7)."""
    lrng = np.random.default_rng(0)
    A = lrng.integers(0, 4, 40).astype(np.uint8)
    C = lrng.integers(0, 4, 40).astype(np.uint8)
    t = np.concatenate([A, C])
    q = np.concatenate([A, C[:26], C[:26], C[26:]]).astype(np.uint8)
    got, want = _banded_planes([(t, q)], 256, W=32, R=2)
    np.testing.assert_array_equal(got, want)
    assert got[0, 256] & 0x80


def _cigars_native(pairs):
    return [native.ops_to_cigar(o) for o in native.align2p_batch_native(pairs, eqx=True)]


def test_aligner_matches_host_aligner():
    """Every route of TorchFillAligner (banded, escalated, full-width,
    > 512 bp host, base code 4) gives the host aligner's CIGARs."""
    rng = np.random.default_rng(24)
    pairs = []
    for _ in range(14):
        pairs.append(_mut(rng, int(rng.integers(30, 240))))
    pairs.append(_mut(rng, 200, ins=120))  # |dq| > 95: full-width route
    pairs.append(_mut(rng, 300, dele=110))  # full-width, bucket 512
    pairs.append(_mut(rng, 420, err=0.06))  # banded, bucket 512
    pairs.append(_mut(rng, 600, err=0.06))  # > 512: host route
    for _ in range(3):  # ambiguous base code 4 in either sequence
        t, q = _mut(rng, int(rng.integers(50, 200)))
        q = q.copy()
        q[int(rng.integers(0, len(q)))] = 4
        t = t.copy()
        t[int(rng.integers(0, len(t)))] = 4
        pairs.append((t, q))
    pairs.append((np.array([2], np.uint8), np.array([2], np.uint8)))
    al = TorchFillAligner(device="cpu")
    got = al.align_batch(pairs, eqx=True)
    assert [g.cigar for g in got] == _cigars_native(pairs)
    got_m = al.align_batch(pairs, eqx=False)
    want_m = [align2p(t, q, eqx=False, **GLOBAL).cigar for t, q in pairs]
    assert [g.cigar for g in got_m] == want_m


def test_aligner_empty_side_goes_to_host():
    q = np.array([0, 1, 2, 3], np.uint8)
    e = np.zeros(0, np.uint8)
    got = TorchFillAligner(device="cpu").align_batch([(e, q), (q, e)], eqx=True)
    assert [g.cigar for g in got] == [
        align2p(e, q, eqx=True, **GLOBAL).cigar,
        align2p(q, e, eqx=True, **GLOBAL).cigar,
    ]


def test_aligner_from_pallas_constants():
    """The port's aligner takes the JAX aligner's constant dict unchanged
    and gives the Pallas aligner's (interpret mode) CIGARs."""
    rng = np.random.default_rng(25)
    pallas = PallasFillAligner(buckets=(256,), interpret=True)
    assert pallas.kw == dict(match=2, mismatch=-4, o1=4, e1=2, o2=24, e2=1)
    port = TorchFillAligner(buckets=(256,), device="cpu", **pallas.kw)
    pairs = [_mut(rng, int(rng.integers(30, 200))) for _ in range(10)]
    want = [r.cigar for r in pallas.align_batch(pairs, eqx=True)]
    got = [r.cigar for r in port.align_batch(pairs, eqx=True)]
    assert got == want


def test_fill_wrappers_take_plain_version_on_cpu():
    rng = np.random.default_rng(26)
    t, q = _mut(rng, 90)
    tT = np.full((1, 256), 4, np.uint8)
    tQ = np.full((1, 256), 4, np.uint8)
    tT[0, :90] = t
    tQ[0, : len(q)] = q
    lens = np.array([[90, len(q)]], np.int32)
    counts = (fill_rowruns.launches, fill_rowruns_banded.launches,
              fill_traceback.launches)
    assert torch.equal(fill_rowruns(_t(tT), _t(tQ), _t(lens)),
                       fill_rowruns_ref(_t(tT), _t(tQ), _t(lens)))
    qs = _t(make_qshift(tQ, lens[:, 0], lens[:, 1], 256))
    assert torch.equal(fill_rowruns_banded(_t(tT), qs, _t(lens)),
                       fill_rowruns_banded_ref(_t(tT), qs, _t(lens)))
    tl, ql = _t(lens[:, 0].copy()), _t(lens[:, 1].copy())
    assert torch.equal(fill_traceback(_t(tT), _t(tQ), tl, ql),
                       fill_traceback_ref(_t(tT), _t(tQ), tl, ql))
    assert (fill_rowruns.launches, fill_rowruns_banded.launches,
            fill_traceback.launches) == counts


def _scan_cases(rng, N):
    """test_affine_pallas.test_rowrun_traceback_interpret_exact's cases (140
    bp insert, 150 bp delete, 1 bp, full bucket, I and D drains, two
    mutated pairs); at N = 512 the I drain is 300 long, a run of more
    than 255 insertions in one row."""
    cases = []
    t = rng.integers(0, 4, 100).astype(np.uint8)
    cases.append((t, np.concatenate(
        [t[:50], rng.integers(0, 4, 140).astype(np.uint8), t[50:]])))
    q = rng.integers(0, 4, 80).astype(np.uint8)
    cases.append((np.concatenate(
        [q[:30], rng.integers(0, 4, 150).astype(np.uint8), q[30:]]), q))
    cases.append((np.array([1], np.uint8), np.array([1], np.uint8)))
    tf = rng.integers(0, 4, N).astype(np.uint8)
    qf = tf.copy()
    m = rng.random(N) < 0.12
    qf[m] = rng.integers(0, 4, int(m.sum()))
    cases.append((tf, qf))
    cases.append((np.array([0, 1], np.uint8),
                  rng.integers(0, 4, 230 if N == 256 else 300).astype(np.uint8)))
    cases.append((rng.integers(0, 4, 230).astype(np.uint8),
                  np.array([3, 1], np.uint8)))  # D drain
    for _ in range(2):
        cases.append(_mut(rng, int(rng.integers(40, N - 10)), err=0.1))
    return cases


@pytest.mark.parametrize("N", [256, 512])
def test_scan_fill_stream_matches_pallas(N):
    """``fill_traceback_ref`` against ``_fill_and_traceback`` (Pallas
    ``_fill_kernel`` in interpret mode plus its XLA walk) at B = 8: the
    packed streams are byte-identical, and decode to ``align2p``'s
    CIGARs."""
    rng = np.random.default_rng(27 + N)
    cases = _scan_cases(rng, N)
    B = len(cases)
    tT = np.full((B, N), 4, np.uint8)
    tQ = np.full((B, N), 4, np.uint8)
    t_len = np.ones(B, np.int32)
    q_len = np.ones(B, np.int32)
    for i, (t, q) in enumerate(cases):
        tT[i, : len(t)] = t
        tQ[i, : len(q)] = q
        t_len[i], q_len[i] = len(t), len(q)
    want = np.asarray(_fill_and_traceback(
        tT.astype(np.int32), tQ.astype(np.int32), t_len, q_len, N=N,
        interpret=True))
    got = fill_traceback_ref(_t(tT), _t(tQ), _t(t_len), _t(q_len)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (N // 2, B)
    np.testing.assert_array_equal(got, want)
    for eqx in (False, True):
        cig = [native.ops_to_cigar(o)
               for o in native.decode_tb_ops(got, cases, eqx=eqx)]
        assert cig == [align2p(t, q, eqx=eqx, **GLOBAL).cigar for t, q in cases]


def test_fetch_packed_gives_one_stream_on_every_route(monkeypatch):
    """fetch_packed of the row-run route, the banded route (jobs without
    escalation) and the scan route: the same op streams."""
    rng = np.random.default_rng(28)
    cases = [_mut(rng, int(rng.integers(20, 200)), err=0.08) for _ in range(6)]
    B = len(cases)
    tT = np.full((B, 256), 4, np.uint8)
    tQ = np.full((B, 256), 4, np.uint8)
    t_len = np.array([len(t) for t, _ in cases], np.int32)
    q_len = np.array([len(q) for _, q in cases], np.int32)
    for i, (t, q) in enumerate(cases):
        tT[i, : len(t)] = t
        tQ[i, : len(q)] = q
    al = TorchFillAligner(device="cpu")
    rr = al.fetch_packed(al.dispatch_padded(tT, tQ, t_len, q_len, 256))
    h = al.dispatch_padded(tT, tQ, t_len, q_len, 256 | BANDED)
    assert not al.fetch(h)[3].any()  # no escalation
    banded = al.fetch_packed(h)
    monkeypatch.setenv("VACMAP_TPU_FILL_SCAN", "1")
    h = al.dispatch_padded(tT, tQ, t_len, q_len, 256)
    assert h[0] == "scan" and al.fetch(h)[0] == "packed"
    np.testing.assert_array_equal(rr, al.fetch_packed(h))
    np.testing.assert_array_equal(rr, banded)
    al.prewarm(batch_sizes=(16,), buckets=(256, 256 | BANDED))


def test_aligner_scan_route_matches_host(monkeypatch):
    """VACMAP_TPU_FILL_SCAN=1 with the band off: every device job takes the
    scan route, and the CIGARs are the host aligner's."""
    monkeypatch.setenv("VACMAP_TPU_FILL_SCAN", "1")
    monkeypatch.setenv("VACMAP_TPU_NO_BANDED_FILL", "1")
    rng = np.random.default_rng(29)
    pairs = [_mut(rng, int(rng.integers(30, 240))) for _ in range(8)]
    pairs.append(_mut(rng, 200, ins=120))
    pairs.append(_mut(rng, 300, dele=110))
    al = TorchFillAligner(device="cpu")
    assert not al.banded
    got = al.align_batch(pairs, eqx=True)
    assert [g.cigar for g in got] == _cigars_native(pairs)
