"""vacmap_tpu_torch CUDA kernels against their plain PyTorch versions on
the card.  These need an NVIDIA Hopper card and nvcc, so they skip
elsewhere; run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest``: tests/conftest.py imports jax, which the port does not
need on the card's machine.  For the same reason this file imports no
other test module: its anchor generators mirror tests/test_chain.py's.)
"""

import zlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def random_anchors(rng, n, read_len=2000, ref_len=100_000):
    r = np.sort(rng.integers(0, read_len, n))
    y = rng.integers(0, ref_len, n)
    s = rng.choice([-1, 1], n)
    l = rng.integers(9, 21, n)
    return np.stack([r, y, s, l], axis=1).astype(np.int64)


def chainy_anchors(rng, read_len=3000, step=40, diag=5000, noise=10):
    """Mostly-colinear anchors with jitter plus some random noise anchors."""
    r = np.arange(0, read_len - 20, step)
    y = r + diag + rng.integers(-3, 4, len(r))
    a = np.stack([r, y, np.ones(len(r), np.int64), np.full(len(r), 15)], axis=1)
    out = np.concatenate([a, random_anchors(rng, noise, read_len)])
    return out[np.argsort(out[:, 0], kind="stable")]


def tied_anchors(rng, n, span=40):
    """n anchors on n / 8 read positions (up to 20 share one, as a
    repeat's seeds do), one length: groups of equal barrier lie across the
    kernels' tile edges.  Half lie on one diagonal, so that chains form."""
    pos = np.sort(rng.choice(np.arange(0, span * n, 7), max(n // 8, 2), replace=False))
    r = np.sort(rng.choice(pos, n))
    y = np.where(rng.random(n) < 0.5, r + 5000 + rng.integers(-2, 3, n),
                 rng.integers(0, 100_000, n))
    return np.stack([r, y, rng.choice([-1, 1], n, p=[0.2, 0.8]),
                     np.full(n, 15)], axis=1).astype(np.int64)


def by_barrier(a, variant):
    key = a[:, 0] + (a[:, 3] if variant in ("fine", "mismatch") else 0)
    return a[np.argsort(key, kind="stable")]


VARIANTS = ["global", "global_nocov", "refund", "fine", "mismatch"]
CHAIN_KW = dict(kmersize=15, maxdiff=50, maxgap=1000, skipcost=40.0)


def _chain_on_card_against_plain(dev, alist, variant, clusters):
    """chain_scores_batch on the card at every cluster size of
    ``clusters`` (0: the launch's own choice): each one launch, all equal
    bit for bit, and within the stated tolerance of the plain version
    (S atol 1e-3, P agreement >= 0.999; rows past n_valid exact)."""
    from vacmap_tpu_torch.ops.chain import (
        chain_scores_batch, chain_scores_batch_ref, prepare_batch, to_device,
    )

    arrays = prepare_batch(alist, variant, 40.0, 50)
    x = to_device(dev, *arrays)
    kw = dict(CHAIN_KW, variant=variant)
    got = []
    for c in clusters:
        before = chain_scores_batch.launches
        S, P = chain_scores_batch(*x, **kw, cluster=c)
        torch.cuda.synchronize()
        assert chain_scores_batch.launches == before + 1
        got.append((S.cpu().numpy(), P.cpu().numpy()))
    S, P = got[0]
    for S_c, P_c in got[1:]:
        assert np.array_equal(S_c.view(np.int32), S.view(np.int32))
        assert np.array_equal(P_c, P)
    S0, P0 = (t.cpu().numpy() for t in chain_scores_batch_ref(*x, **kw))
    valid = np.arange(arrays[0].shape[1])[None, :] < arrays[1][:, None]
    np.testing.assert_allclose(S[valid], S0[valid], atol=1e-3, rtol=1e-6)
    assert (S[~valid] == 0).all() and (P[~valid] == -1).all()
    agree = float(np.mean(P[valid] == P0[valid])) if valid.any() else 1.0
    print(f"chain_dp {variant} B={len(alist)} N={arrays[0].shape[1]} clusters "
          f"{clusters}: max|dS|={float(np.abs(S - S0)[valid].max()):.3g} "
          f"P agreement={agree:.6f}")
    assert agree >= 0.999


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc for sm_90a)")
    return torch.device("cuda:0")


def _pairs(rng, n, lo, hi, err=0.06, random_frac=0.1):
    out = []
    while len(out) < n:
        L = int(rng.integers(lo, hi + 1))
        t = rng.integers(0, 4, L).astype(np.uint8)
        q = t.copy()
        m = rng.random(L) < err
        q[m] = rng.integers(0, 4, int(m.sum()))
        if rng.random() < 0.3:
            p = int(rng.integers(0, L))
            q = np.concatenate([q[:p], rng.integers(0, 4, int(rng.integers(1, 80))).astype(np.uint8), q[p:]])
        if rng.random() < random_frac:  # unrelated pair: band escalations
            q = rng.integers(0, 4, max(1, L + int(rng.integers(-40, 40)))).astype(np.uint8)
        if len(q) <= hi:
            out.append((t, q))
    return out


def _planes(pairs, N):
    B = len(pairs)
    tT = np.full((B, N), 4, np.uint8)
    tQ = np.full((B, N), 4, np.uint8)
    lens = np.zeros((B, 2), np.int32)
    for b, (t, q) in enumerate(pairs):
        tT[b, : len(t)] = t
        tQ[b, : len(q)] = q
        lens[b] = (len(t), len(q))
    return tT, tQ, lens


@pytest.mark.parametrize("variant", VARIANTS)
def test_chain_kernel_matches_plain(dev, variant):
    from vacmap_tpu_torch.ops.chain import (
        chain_scores_batch, chain_scores_batch_ref, prepare_batch, to_device,
    )

    rng = np.random.default_rng(31)
    alist = [random_anchors(rng, int(rng.integers(200, 900))) if k % 2
             else chainy_anchors(rng, read_len=20000, noise=40) for k in range(6)]
    if variant in ("fine", "mismatch"):
        alist = [a[np.argsort(a[:, 0] + a[:, 3], kind="stable")] for a in alist]
    arrays = prepare_batch(alist, variant, 40.0, 50)
    x = to_device(dev, *arrays)
    kw = dict(kmersize=15, maxdiff=50, maxgap=1000, skipcost=40.0, variant=variant)
    before = chain_scores_batch.launches
    S, P = chain_scores_batch(*x, **kw)
    torch.cuda.synchronize()
    assert chain_scores_batch.launches == before + 1
    S0, P0 = chain_scores_batch_ref(*x, **kw)
    valid = np.arange(arrays[0].shape[1])[None, :] < arrays[1][:, None]
    S, P, S0, P0 = (t.cpu().numpy() for t in (S, P, S0, P0))
    np.testing.assert_allclose(S[valid], S0[valid], atol=1e-3, rtol=1e-6)
    assert (S[~valid] == 0).all() and (P[~valid] == -1).all()
    assert np.mean(P[valid] == P0[valid]) >= 0.999


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("variant", VARIANTS)
def test_chain_kernel_small_batch_large_n_every_cluster_size(dev, variant, B):
    """The executor's local launches: a few reads of up to 8192 anchors,
    each spread over a thread block cluster.  Every cluster size the
    launch can choose gives the same bits."""
    rng = np.random.default_rng(51 + B)
    alist = []
    for _ in range(B):
        n = int(rng.integers(5000, 8193))
        a = chainy_anchors(rng, read_len=36 * n, noise=n // 10)
        alist.append(by_barrier(a[rng.permutation(len(a))[:n]], variant))
    assert max(len(a) for a in alist) > 4096
    _chain_on_card_against_plain(dev, alist, variant, (0, 1, 2, 4, 8))


@pytest.mark.parametrize("variant", VARIANTS)
def test_chain_kernel_ties_ragged_and_unsorted_reads(dev, variant):
    """Groups of equal barrier across tile edges, n_valid around and below
    one tile of 64 rows, an empty read, a chain with jumps (the refund
    ledger across tile edges), and reads that are not sorted beside sorted
    ones: the unsorted reads take the kernel's row-at-a-time route and get
    the plain version's result too."""
    rng = np.random.default_rng(52)
    jumps = chainy_anchors(rng, read_len=20000, noise=40)
    for lo, shift in ((4000, 4000), (9000, 9000), (15000, 2500)):
        jumps[jumps[:, 0] >= lo, 1] += shift
    alist = [tied_anchors(rng, 1000), tied_anchors(rng, 65), jumps,
             chainy_anchors(rng, read_len=2400, noise=3)[:63],
             np.zeros((0, 4), np.int64), random_anchors(rng, 1),
             chainy_anchors(rng, read_len=20000, noise=40),
             random_anchors(rng, 700)]
    alist = [by_barrier(a, variant) for a in alist]
    for k in (6, 7):  # two reads out of order
        a = alist[k]
        a[[len(a) // 5, len(a) // 2]] = a[[len(a) // 2, len(a) // 5]]
    for k, a in enumerate(alist):  # the unsorted reads are what they claim
        bar = a[:, 0] + (a[:, 3] if variant in ("fine", "mismatch") else 0)
        assert bool((np.diff(bar) < 0).any()) == (k in (6, 7))
    _chain_on_card_against_plain(dev, alist, variant, (0, 1, 4))


FULL_CASES = ["256", "512", "64", "160", "1024", "t_len_1", "q_len_1",
              "full_512", "ins_gt_255", "mixed_20_500", "B1", "B16", "B300"]


def _full_case(case, seed):
    """(pairs, N) of one card case of the full-width kernels: N = 64 to
    1024 (one to four warps a job), one-base sides, t_len = q_len = N,
    insertion runs of 256 to 460 bases in one row (ex bit 1), jobs of 20
    and 500 rows in one launch, and B = 1, 16, 300."""
    rng = np.random.default_rng(list(case.encode()) + [seed])
    if case.isdigit():
        N = int(case)
        return _pairs(rng, 48 if N > 512 else 96, 1, N), N
    if case == "t_len_1":
        return [(rng.integers(0, 4, 1).astype(np.uint8),
                 rng.integers(0, 4, int(rng.integers(1, 257))).astype(np.uint8))
                for _ in range(64)], 256
    if case == "q_len_1":
        return [(b, a) for a, b in _full_case("t_len_1", seed)[0]], 256
    if case == "full_512":
        pairs = []
        for _ in range(32):
            t = rng.integers(0, 4, 512).astype(np.uint8)
            q = t.copy()
            m = rng.random(512) < 0.08
            q[m] = rng.integers(0, 4, int(m.sum()))
            pairs.append((t, q))
        return pairs, 512
    if case == "ins_gt_255":  # the target matches the query's head; the
        # rest of the query (no base of the target) is one run in its last row
        pairs = []
        for _ in range(32):
            t = rng.integers(0, 2, int(rng.integers(1, 40))).astype(np.uint8)
            run = 2 + rng.integers(0, 2, int(rng.integers(256, 512 - len(t) + 1)))
            pairs.append((t, np.concatenate([t, run]).astype(np.uint8)))
        return pairs, 512
    if case == "mixed_20_500":  # jobs of one launch that end apart
        return [(t, q) for k in range(48) for t, q in _pairs(
            rng, 1, 20 if k % 2 else 500, 20 if k % 2 else 500, random_frac=0.0)], 512
    B = int(case[1:])  # "B1", "B16", "B300"
    return _pairs(rng, B, 1, 256), 256


@pytest.mark.parametrize("case", FULL_CASES)
def test_full_fill_kernel_matches_plain(dev, case):
    """csrc/fill_full.cu: planes equal to the plain version's, byte for
    byte, in one launch counted under its (B, N)."""
    from vacmap_tpu_torch.ops.affine_fill import fill_rowruns, fill_rowruns_ref

    pairs, N = _full_case(case, 32)
    B = len(pairs)
    x = [torch.from_numpy(a).to(dev) for a in _planes(pairs, N)]
    want = fill_rowruns_ref(*x).cpu()
    before = fill_rowruns.launches
    shape_before = fill_rowruns.shapes.get((B, N), 0)
    got = fill_rowruns(*x)
    torch.cuda.synchronize()
    assert fill_rowruns.launches == before + 1
    assert fill_rowruns.shapes[(B, N)] == shape_before + 1
    assert torch.equal(got.cpu(), want)
    if case == "ins_gt_255":
        assert ((want[:, N:].numpy() >> 1) & 1).any(axis=1).all()


def _banded_inputs(pairs, T):
    from vacmap_tpu_torch.ops.affine_fill import make_qshift

    tT, tQ, lens = _planes(pairs, T)
    return tT, make_qshift(tQ, lens[:, 0], lens[:, 1], T), lens


def _band_ok(pairs):
    return [(t, q) for t, q in pairs if abs(len(t) - len(q)) <= 95]


def _escalating_pairs(rng, n, T):
    """Unrelated pairs (about one in five sets ESCALATE at W = 128: the
    walk touches a band edge or an edge cell is its row's maximum), kept
    where the plain version flags them."""
    from vacmap_tpu_torch.ops.affine_fill import fill_rowruns_banded_ref

    cand = []
    for _ in range(8 * n):
        L = int(rng.integers(100, T - 40))
        cand.append((rng.integers(0, 4, L).astype(np.uint8),
                     rng.integers(0, 4, L + int(rng.integers(-20, 21))).astype(np.uint8)))
    planes = fill_rowruns_banded_ref(
        *(torch.from_numpy(a) for a in _banded_inputs(cand, T))).numpy()
    flagged = [p for p, ex in zip(cand, planes[:, T]) if ex & 0x80]
    assert len(flagged) >= n
    return flagged[:n]


def _banded_case(case):
    """(pairs, T) of one card case of the banded kernel."""
    rng = np.random.default_rng(33 + int(case) if case.isdigit()
                                else list(case.encode()))
    if case.isdigit():  # T = 100 (not a multiple of 32), 256, 512, 1024
        T = int(case)
        return _band_ok(_pairs(rng, 160 if T <= 512 else 48, 1,
                               T - 100 if T > 200 else T)), T
    if case == "dq_pm95":  # the band's extreme offsets
        pairs = []
        for k in range(48):
            L = int(rng.integers(100, 150))
            t = rng.integers(0, 4, L).astype(np.uint8)
            d = (95, -95, 94, -94)[k % 4]
            if d > 0:
                p = int(rng.integers(0, L))
                q = np.concatenate([t[:p], rng.integers(0, 4, d).astype(np.uint8), t[p:]])
            else:
                p = int(rng.integers(0, L + d))
                q = np.concatenate([t[:p], t[p - d:]])
            pairs.append((t, q.astype(np.uint8)))
        assert {len(q) - len(t) for t, q in pairs} == {95, -95, 94, -94}
        return pairs, 256
    if case == "t_len_1":
        return [(rng.integers(0, 4, 1).astype(np.uint8),
                 rng.integers(0, 4, int(rng.integers(1, 97))).astype(np.uint8))
                for _ in range(64)], 256
    if case == "escalate":
        return _escalating_pairs(rng, 40, 256), 256
    if case == "mixed_20_400":  # jobs of one launch that end apart
        return [(t, q) for k in range(48) for t, q in _band_ok(
            _pairs(rng, 1, 20 if k % 2 else 400, 20 if k % 2 else 400, random_frac=0.0))], 512
    B = int(case[1:])  # "B1", "B16", "B300"
    pairs = []
    while len(pairs) < B:
        pairs += _band_ok(_pairs(rng, B, 1, 156))
    return pairs[:B], 256


@pytest.mark.parametrize("case", ["256", "512", "100", "1024", "dq_pm95",
                                  "t_len_1", "escalate", "mixed_20_400",
                                  "B1", "B16", "B300"])
def test_banded_fill_kernel_matches_plain(dev, case):
    """csrc/fill_banded.cu: planes equal to the plain version's, byte for
    byte, ESCALATE included."""
    from vacmap_tpu_torch.ops.affine_fill import (
        fill_rowruns_banded, fill_rowruns_banded_ref,
    )

    pairs, T = _banded_case(case)
    x = [torch.from_numpy(a).to(dev) for a in _banded_inputs(pairs, T)]
    B = len(pairs)
    want = fill_rowruns_banded_ref(*x).cpu()
    before = fill_rowruns_banded.launches
    shape_before = fill_rowruns_banded.shapes.get((B, T), 0)
    got = fill_rowruns_banded(*x)
    torch.cuda.synchronize()
    assert fill_rowruns_banded.launches == before + 1
    assert fill_rowruns_banded.shapes[(B, T)] == shape_before + 1
    assert torch.equal(got.cpu(), want)
    flagged = int(((want[:, T] & 0x80) != 0).sum())
    if case == "escalate":
        assert flagged == B
    print(f"fill_banded {case} B={B} T={T}: equal, {flagged} escalated")


def test_aligner_on_card_matches_host(dev):
    from vacmap_tpu_torch import native
    from vacmap_tpu_torch.ops.affine_fill import TorchFillAligner

    rng = np.random.default_rng(34)
    pairs = _pairs(rng, 400, 1, 700, err=0.05, random_frac=0.0)
    got = TorchFillAligner(device=dev).align_batch(pairs, eqx=True)
    want = native.align2p_batch_native(pairs, eqx=True)
    assert [g.cigar for g in got] == [native.ops_to_cigar(w) for w in want]


@pytest.mark.parametrize("case", FULL_CASES)
def test_scan_fill_kernel_matches_plain(dev, case):
    """csrc/fill_scan.cu: op streams equal to the plain version's, byte
    for byte, in one launch counted under its (B, N)."""
    from vacmap_tpu_torch.ops.affine_fill import fill_traceback, fill_traceback_ref

    pairs, N = _full_case(case, 35)
    B = len(pairs)
    tT, tQ, lens = _planes(pairs, N)
    x = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in (tT, tQ, lens[:, 0], lens[:, 1])]
    want = fill_traceback_ref(*x).cpu()
    before = fill_traceback.launches
    shape_before = fill_traceback.shapes.get((B, N), 0)
    got = fill_traceback(*x)
    torch.cuda.synchronize()
    assert fill_traceback.launches == before + 1
    assert fill_traceback.shapes[(B, N)] == shape_before + 1
    assert got.shape == (N // 2, B)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("scan", [False, True])
def test_fill_service_on_card_matches_host(dev, scan, monkeypatch):
    """The in-process service on the card, default route (banded and
    row-run kernels) and scan route: the host aligner's CIGARs."""
    from vacmap_tpu_torch import native
    from vacmap_tpu_torch.ops.affine_fill import fill_traceback
    from vacmap_tpu_torch.parallel.fill_service import async_fill_aligner

    if scan:
        monkeypatch.setenv("VACMAP_TPU_FILL_SCAN", "1")
    rng = np.random.default_rng(36)
    pairs = _pairs(rng, 600, 1, 500, err=0.05, random_frac=0.0)
    for _ in range(24):  # |dq| > 95: the full-width (or scan) route
        t = rng.integers(0, 4, int(rng.integers(100, 300))).astype(np.uint8)
        p = int(rng.integers(0, len(t)))
        ins = rng.integers(0, 4, int(rng.integers(100, 200))).astype(np.uint8)
        pairs.append((t, np.concatenate([t[:p], ins, t[p:]])))
    svc = async_fill_aligner(dev, max_wait_ms=2.0)
    try:
        assert svc.ready.wait(120) and svc.core.error is None
        before = fill_traceback.launches
        got = svc.align_batch(pairs, eqx=True)
        assert (fill_traceback.launches > before) == scan
    finally:
        svc.stop()
    want = native.align2p_batch_native(pairs, eqx=True)
    assert [g.cigar for g in got] == [native.ops_to_cigar(w) for w in want]


def _warm_inputs(rng, n, n_warm, variant):
    """One problem: n anchors sorted by the variant's barrier behind a
    frontier of n_warm anchors in score order (rebased scores, predecessor
    codes <= -2); rows past n_valid hold what the caller left there."""
    from vacmap_tpu_torch.ops.chain import prepare_batch

    local = variant in ("fine", "mismatch")
    a = chainy_anchors(rng, read_len=40 * n, noise=n // 10)[:n]
    a = a[np.argsort(a[:, 0] + (a[:, 3] if local else 0), kind="stable")]
    a[:, 0] += 5000
    f = a[rng.permutation(len(a))[:n_warm]].copy()
    f[:, 0] -= rng.integers(100, 4000, n_warm)
    linked = np.concatenate([f, a]) if n_warm else a
    arrays = prepare_batch([linked], variant, 40.0, 50)
    N = arrays[0].shape[1]
    w_S = np.full((1, N), 7.5, np.float32)
    w_P = np.full((1, N), -3, np.int32)
    w_S[0, :n_warm] = np.sort(1000.0 - rng.random(n_warm) * 96.0)
    w_P[0, :n_warm] = -rng.integers(0, 30000, n_warm) - 2
    w_S[0, n_warm : len(linked)] = 0.0
    return arrays, w_S, w_P, np.array([n_warm], np.int32), len(linked)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,n_warm", [(9000, 300), (700, 40), (3000, 0), (50, 3)])
def test_warm_chain_kernel_matches_plain(dev, variant, n, n_warm):
    """The tiled warm-start kernel against its plain version: scored rows
    within the stated tolerance, frozen rows and rows past n_valid exact."""
    from vacmap_tpu_torch.ops.chain import (
        chain_scores_batch_warm, chain_scores_batch_warm_ref, to_device,
    )

    rng = np.random.default_rng(41 + n)
    arrays, w_S, w_P, nw, nv = _warm_inputs(rng, n, n_warm, variant)
    x = to_device(dev, *arrays, w_S, w_P, nw)
    kw = dict(kmersize=15, maxdiff=50, maxgap=1000, skipcost=40.0, variant=variant)
    before = chain_scores_batch_warm.launches
    S, P = chain_scores_batch_warm(*x, **kw)
    torch.cuda.synchronize()
    assert chain_scores_batch_warm.launches == before + 1
    S0, P0 = chain_scores_batch_warm_ref(*x, **kw)
    S, P, S0, P0 = (t.cpu().numpy()[0] for t in (S, P, S0, P0))
    np.testing.assert_allclose(S[n_warm:nv], S0[n_warm:nv], atol=1e-3, rtol=1e-6)
    assert np.mean(P[n_warm:nv] == P0[n_warm:nv]) >= 0.999
    assert np.array_equal(S[:n_warm], w_S[0, :n_warm])
    assert np.array_equal(P[:n_warm], w_P[0, :n_warm])
    assert np.array_equal(S[nv:], w_S[0, nv:]) and (P[nv:] == -1).all()
    if n_warm:
        assert ((P[n_warm:nv] >= 0) & (P[n_warm:nv] < n_warm)).any()


@pytest.mark.parametrize("variant", VARIANTS)
def test_warm_chain_kernel_ties_and_ragged_frontiers(dev, variant):
    """Two problems in one call: frontiers of 200 and 7 rows (tiles start
    at row 7, so the first problem has tiles of frozen rows only and a
    last frozen tile that is ragged), blocks with groups of equal barrier
    across tile edges, n_valid no multiple of the tile."""
    from vacmap_tpu_torch.ops.chain import (
        chain_scores_batch_warm, chain_scores_batch_warm_ref, prepare_batch,
        to_device,
    )

    rng = np.random.default_rng(46)
    n_warm = np.array([200, 7], np.int32)
    alist = []
    for nw, n in zip(n_warm, (1501, 900)):
        a = by_barrier(tied_anchors(rng, n), variant)
        a[:, 0] += 5000
        f = a[rng.permutation(n)[:nw]].copy()
        f[:, 0] -= rng.integers(100, 4000, nw)
        alist.append(np.concatenate([f, a]))
    arrays = prepare_batch(alist, variant, 40.0, 50)
    N = arrays[0].shape[1]
    w_S = np.full((2, N), 7.5, np.float32)
    w_P = np.full((2, N), -3, np.int32)
    for b, nw in enumerate(n_warm):
        w_S[b, :nw] = np.sort(1000.0 - rng.random(nw) * 96.0)
        w_P[b, :nw] = -rng.integers(0, 30000, nw) - 2
    x = to_device(dev, *arrays, w_S, w_P, n_warm)
    kw = dict(CHAIN_KW, variant=variant)
    before = chain_scores_batch_warm.launches
    S, P = chain_scores_batch_warm(*x, **kw)
    torch.cuda.synchronize()
    assert chain_scores_batch_warm.launches == before + 1
    S0, P0 = chain_scores_batch_warm_ref(*x, **kw)
    S, P, S0, P0 = (t.cpu().numpy() for t in (S, P, S0, P0))
    idx = np.arange(N)[None, :]
    frozen, past = idx < n_warm[:, None], idx >= arrays[1][:, None]
    scored = ~frozen & ~past
    np.testing.assert_allclose(S[scored], S0[scored], atol=1e-3, rtol=1e-6)
    assert np.mean(P[scored] == P0[scored]) >= 0.999
    assert np.array_equal(S[~scored], S0[~scored])
    assert np.array_equal(P[~scored], P0[~scored])
    assert np.array_equal(S[frozen], w_S[frozen])
    assert ((P >= 0) & (P < n_warm[:, None]) & scored).any()


def test_cold_chain_above_shared_memory_limit_takes_the_tiled_kernel(dev):
    """chain_scores_batch above MAX_N anchors launches the tiled kernel
    with no frozen rows and agrees with chain_scores_batch_ref."""
    from vacmap_tpu_torch.ops.chain import (
        MAX_N, chain_scores_batch, chain_scores_batch_ref,
        chain_scores_batch_warm, prepare_batch, to_device,
    )

    rng = np.random.default_rng(43)
    a = chainy_anchors(rng, read_len=40 * 9000, noise=900)
    assert len(a) > MAX_N
    arrays = prepare_batch([a], "global_nocov", 40.0, 50)
    x = to_device(dev, *arrays)
    kw = dict(kmersize=15, maxdiff=50, maxgap=1000, skipcost=40.0,
              variant="global_nocov")
    before = chain_scores_batch_warm.launches
    S, P = chain_scores_batch(*x, **kw)
    torch.cuda.synchronize()
    assert chain_scores_batch_warm.launches == before + 1
    S0, P0 = chain_scores_batch_ref(*x, **kw)
    n = len(a)
    S, P, S0, P0 = (t.cpu().numpy()[0] for t in (S, P, S0, P0))
    np.testing.assert_allclose(S[:n], S0[:n], atol=1e-3, rtol=1e-6)
    assert np.mean(P[:n] == P0[:n]) >= 0.999
    assert (S[n:] == 0).all() and (P[n:] == -1).all()


def _swap_past_warm(arrays, b, nw, rows):
    """Swap two rows of problem b past its frontier: not sorted by
    barrier any more."""
    i, j = nw + rows[0], nw + rows[1]
    arrays[0][b, [i, j]] = arrays[0][b, [j, i]]


def _ragged_warm_batch(rng, variant):
    """B = 3 behind frontiers of 40, 7 and 0 rows, n_valid ragged (no
    multiple of the tile), the middle problem with two rows swapped past
    its frontier; the rows to score hold 2000.0 (what the caller left
    there), which the unsorted problem's rows see for candidates not yet
    scored, as in the reference's scan."""
    from vacmap_tpu_torch.ops.chain import prepare_batch

    n_warm = np.array([40, 7, 0], np.int32)
    alist = []
    for nw, n in zip(n_warm, (1501, 900, 333)):
        a = by_barrier(chainy_anchors(rng, read_len=40 * n, noise=n // 10)[:n],
                       variant)
        a[:, 0] += 5000
        f = a[rng.permutation(n)[:nw]].copy()
        f[:, 0] -= rng.integers(100, 4000, nw)
        alist.append(np.concatenate([f, a]) if nw else a)
    arrays = prepare_batch(alist, variant, 40.0, 50)
    _swap_past_warm(arrays, 1, 7, (30, 600))
    N = arrays[0].shape[1]
    w_S = np.full((3, N), 7.5, np.float32)
    w_P = np.full((3, N), -3, np.int32)
    for b, nw in enumerate(n_warm):
        w_S[b, :nw] = np.sort(1000.0 - rng.random(nw) * 96.0)
        w_P[b, :nw] = -rng.integers(0, 30000, nw) - 2
        w_S[b, nw : arrays[1][b]] = 2000.0
    return arrays, w_S, w_P, n_warm


@pytest.mark.parametrize("variant", VARIANTS)
def test_warm_chain_kernel_launches_without_sync_on_any_row_order(dev, variant):
    """chain_scores_batch_warm under torch.cuda.set_sync_debug_mode("error")
    (any host synchronisation raises): at B = 1 N = 4096 (the asm block
    shape: 2,800 rows behind a frontier of 4) sorted and with two rows
    swapped past the frontier, and at B = 3 with ragged frontiers and
    n_valid, one problem unsorted; and chain_scores_batch above MAX_N with
    an unsorted read beside a sorted one.  Every result equals the plain
    version's on the card (S error 0, P agreement 1.000000)."""
    from vacmap_tpu_torch.ops.chain import (
        MAX_N, chain_scores_batch, chain_scores_batch_ref,
        chain_scores_batch_warm, chain_scores_batch_warm_ref, prepare_batch,
        to_device,
    )

    rng = np.random.default_rng(44)
    kw = dict(CHAIN_KW, variant=variant)
    sorted_1 = _warm_inputs(rng, 2800, 4, variant)[:4]
    unsorted_1 = tuple(np.copy(a) for a in sorted_1[0]), *sorted_1[1:]
    _swap_past_warm(unsorted_1[0], 0, 4, (100, 2000))
    cases = {"B=1 sorted": sorted_1, "B=1 unsorted": unsorted_1,
             "B=3 ragged, one unsorted": _ragged_warm_batch(rng, variant)}
    for name, (arrays, w_S, w_P, nw) in cases.items():
        x = to_device(dev, *arrays, w_S, w_P, nw)
        torch.cuda.synchronize()
        before = chain_scores_batch_warm.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            S, P = chain_scores_batch_warm(*x, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert chain_scores_batch_warm.launches == before + 1
        S0, P0 = chain_scores_batch_warm_ref(*x, **kw)
        S, P, S0, P0 = (t.cpu().numpy() for t in (S, P, S0, P0))
        print(f"warm {variant} {name} N={S.shape[1]}: "
              f"max|dS|={float(np.abs(S - S0).max()):.3g} "
              f"P agreement={float(np.mean(P == P0)):.6f}")
        assert np.array_equal(S, S0) and np.array_equal(P, P0), name
    # the cold route above MAX_N (no refund: its ledger is chain_dp.cu's)
    if variant == "refund":
        return
    bad = by_barrier(chainy_anchors(rng, read_len=12000, noise=30), variant)
    bad[[40, 250]] = bad[[250, 40]]
    big = by_barrier(chainy_anchors(rng, read_len=40 * 9000, noise=900), variant)
    arrays = prepare_batch([big, bad], variant, 40.0, 50)
    assert arrays[0].shape[1] > MAX_N
    x = to_device(dev, *arrays)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        S, P = chain_scores_batch(*x, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    S0, P0 = chain_scores_batch_ref(*x, **kw)
    S, P, S0, P0 = (t.cpu().numpy() for t in (S, P, S0, P0))
    print(f"cold {variant} B=2 N={S.shape[1]} one unsorted: "
          f"max|dS|={float(np.abs(S - S0).max()):.3g} "
          f"P agreement={float(np.mean(P == P0)):.6f}")
    assert np.array_equal(S, S0) and np.array_equal(P, P0)


def test_asm_cli_on_card_matches_host_path(dev, tmp_path):
    """`-mode asm --backend jax --device cuda` writes the records of the
    port's host path; a 600 kb contig with a deletion streams through the
    warm kernel, a 60 kb one takes the per-call chain kernel."""
    from vacmap_tpu_torch import cli
    from vacmap_tpu_torch.ops.chain import chain_scores_batch_warm

    rng = np.random.default_rng(45)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 800_000))
    big = g[50_000:350_000] + g[352_000:650_000]
    ref = tmp_path / "ref.fa"
    ref.write_text(f">g\n{g}\n")
    rd = tmp_path / "contigs.fa"
    rd.write_text(f">big\n{big}\n>small\n{g[700_000:760_000]}\n")
    common = ["-ref", str(ref), "-read", str(rd), "-mode", "asm",
              "--nowriteindex"]
    host, card = tmp_path / "host.sam", tmp_path / "card.sam"
    assert cli.main(common + ["--backend", "numpy", "-o", str(host)]) == 0
    before = chain_scores_batch_warm.launches
    assert cli.main(common + ["--backend", "jax", "--device", "cuda",
                              "-o", str(card)]) == 0
    assert chain_scores_batch_warm.launches >= before + 6

    def body(p):
        return [l for l in p.read_text().splitlines() if not l.startswith("@PG")]

    assert body(card) == body(host)
    assert sum(not l.startswith("@") for l in body(host)) >= 2


def _myers_pairs(rng, T, Wd, B):
    """Texts up to T bases with copies at 5% or 30% substitutions and
    indels, some patterns grown to 1.4 n, one of exactly 32 Wd bases, one
    of one base, a one-base text, and every seventh pair with an N."""
    pairs = []
    for i in range(B):
        n = int(rng.integers(T // 4, T + 1)) if i else T
        t = rng.integers(0, 4, n).astype(np.uint8)
        keep = rng.random(n) >= (0.02 if i % 2 else 0.1)
        q = t[keep].copy()
        m = rng.random(len(q)) < (0.03 if i % 2 else 0.2)
        q[m] = rng.integers(0, 4, int(m.sum()))
        if i % 5 == 0:
            grow = max(min(int(0.4 * n), Wd * 32 - len(q)), 0)
            q = np.concatenate([q, rng.integers(0, 4, grow).astype(np.uint8)])
        if i % 7 == 3:
            q[len(q) // 2] = 4
        if i == 1:
            q = np.resize(q, Wd * 32)
        if i == 2:
            q = q[:1]
        if i == 3:
            t = t[:1]
        pairs.append((t, q[: Wd * 32]))
    return pairs


@pytest.mark.parametrize("T,Wd,B,n_plain", [(2048, 128, 96, 96),
                                            (8192, 384, 48, 12),
                                            (20480, 896, 24, 3)])
def test_myers_kernel_matches_plain_and_native(dev, T, Wd, B, n_plain):
    """csrc/myers.cu at the three buckets' full widths: equal to its plain
    version (on the first n_plain pairs: the plain version is one step a
    text column) and, on the pairs without N, to the native Myers."""
    from vacmap_tpu_torch import native
    from vacmap_tpu_torch.ops import myers

    rng = np.random.default_rng(T)
    pairs = _myers_pairs(rng, T, Wd, B)
    x = [torch.from_numpy(a).to(dev) for a in myers.pack_jobs(pairs, T, Wd)]
    before = myers.myers_distances.launches
    got = myers.myers_distances(*x)
    torch.cuda.synchronize()
    assert myers.myers_distances.launches == before + 1
    got = got.cpu().numpy()
    want = myers.myers_distances_ref(*(a[:n_plain] for a in x)).cpu().numpy()
    assert np.array_equal(got[:n_plain], want)
    clean = [i for i, (t, q) in enumerate(pairs)
             if not ((t == 4).any() or (q == 4).any())]
    assert len(clean) < B
    assert [int(got[i]) for i in clean] == [
        native.edit_distance_native(*pairs[i]) for i in clean]
    ta = myers.TorchMyersAligner(dev)
    assert ta.distance_batch(pairs) == got.tolist()


def _edit_pair(rng, n, m, err=0.05):
    """A random text of n bases and a pattern of m bases copied from it
    (repeated as needed) with substitutions at rate ``err``."""
    t = rng.integers(0, 4, n).astype(np.uint8)
    q = np.resize(t, m).copy()
    hit = rng.random(m) < err
    q[hit] = rng.integers(0, 4, int(hit.sum()))
    return t, q


def _wavefront_case(case):
    """(bucket T, Wd, pairs) of one boundary case of csrc/myers.cu: a block
    of ceil(Wd / 64) warps, one 64-bit pattern word a thread."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case.startswith("m"):  # top word at a warp or block edge
        m = int(case[1:])
        T, Wd = {2047: (2048, 128), 2048: (2048, 128), 2049: (2048, 128),
                 4097: (8192, 384), 28672: (20480, 896)}[m]
        return T, Wd, [_edit_pair(rng, n, m) for n in (1, T // 4, 2000)]
    if case == "n1":
        return 8192, 384, [_edit_pair(rng, 1, m) for m in (1, 64, 65, 5000)]
    if case.startswith("nT"):  # texts of exactly T columns
        T = int(case[2:])
        Wd = {2048: 128, 8192: 384, 20480: 896}[T]
        return T, Wd, [_edit_pair(rng, T, m) for m in (
            (T, int(1.4 * T), 1) if T < 20480 else (64, 1500, 1))]
    if case.startswith("B"):  # the divergence filter's launch size
        return 2048, 128, [_edit_pair(rng, int(rng.integers(1800, 2049)),
                                      int(rng.integers(1400, 2800)), 0.2)
                           for _ in range(int(case[1:]))]
    if case == "tops_apart":  # one launch, top words in seven of 14 warps
        return 20480, 896, [_edit_pair(rng, int(rng.integers(2000, 4000)), m)
                            for m in (1, 100, 2049, 6000, 9000, 20000, 28672)]
    assert case == "with_n"
    pairs = [_edit_pair(rng, 3000, 3100) for _ in range(3)]
    pairs[0][0][[0, 1000, 2999]] = 4
    pairs[1][1][[5, 2047, 3099]] = 4
    pairs[2][0][77] = pairs[2][1][77] = 4  # N against N: no match here
    return 8192, 384, pairs


@pytest.mark.parametrize("case", ["m2047", "m2048", "m2049", "m4097",
                                  "m28672", "n1", "nT2048", "nT8192",
                                  "nT20480", "B1", "B2", "B3", "tops_apart",
                                  "with_n"])
def test_myers_wavefront_kernel_boundaries(dev, case):
    """csrc/myers.cu where its wavefront hands over: top words 31 / 32
    (a warp edge), 64 (a third warp) and 447 (all 14 warps), texts of one
    column and of T columns, launches of 1-3 pairs, top words in
    different warps of one launch, and N pairs; equal to the plain
    version (run on the batch's own words: words above a pair's top never
    reach it) and, without N, to the native Myers."""
    from vacmap_tpu_torch import native
    from vacmap_tpu_torch.ops import myers

    T, Wd, pairs = _wavefront_case(case)
    x = [torch.from_numpy(a).to(dev) for a in myers.pack_jobs(pairs, T, Wd)]
    before = myers.myers_distances.launches
    got = myers.myers_distances(*x)
    torch.cuda.synchronize()
    assert myers.myers_distances.launches == before + 1
    got = got.cpu().numpy()
    words = max((len(q) + 63) // 64 for _, q in pairs)
    text, peq, n, m = x
    want = myers.myers_distances_ref(text, peq[:, :, :words].contiguous(),
                                     n, m).cpu().numpy()
    assert got.tolist() == want.tolist()
    clean = [i for i, (t, q) in enumerate(pairs)
             if not ((t == 4).any() or (q == 4).any())]
    assert (case == "with_n") == (not clean)
    assert [int(got[i]) for i in clean] == [
        native.edit_distance_native(*pairs[i]) for i in clean]
    if case == "with_n":  # the native Myers matches N to N; one more here
        nat = native.edit_distance_native(*pairs[2])
        assert nat <= int(got[2]) <= nat + 1


def test_prewarm_entry_on_card(dev, capsys):
    from vacmap_tpu_torch import prewarm

    assert prewarm.main(["--all"]) == 0
    out = capsys.readouterr().out
    assert "kernel library" in out and "myers kernel (T=20480" in out
    assert "asm stream chain kernel (N=32768)" in out


@pytest.mark.parametrize("variant,B", [("global", 64), ("fine", 16),
                                       ("refund", 5)])
def test_split_over_two_streams_of_one_card_is_bit_equal(dev, variant, B):
    """ShardedChainStep over [cuda:0, cuda:0]: two parts, each copied and
    launched on a stream of its own, give the unsplit launch's bits; a
    ragged batch (B = 5) is padded to 6 and cut back."""
    from vacmap_tpu_torch.ops.chain import (
        chain_scores_batch, prepare_batch, to_device,
    )
    from vacmap_tpu_torch.parallel.mesh import ShardedChainStep

    rng = np.random.default_rng(31 + B)
    alist = [by_barrier(chainy_anchors(rng, read_len=int(rng.integers(
        2000, 40_000)), noise=40), variant) for _ in range(B)]
    arrays = prepare_batch(alist, variant, 40.0, 50)
    kw = dict(CHAIN_KW, variant=variant)
    S0, P0 = (t.cpu().numpy() for t in
              chain_scores_batch(*to_device(dev, *arrays), **kw))
    step = ShardedChainStep([dev, dev], **kw)
    before = chain_scores_batch.launches
    S, P, best, n_acc = step(*arrays)
    assert chain_scores_batch.launches == before + 2
    assert S.shape == S0.shape
    assert np.array_equal(S.view(np.int32), S0.view(np.int32))
    assert np.array_equal(P, P0)
    assert np.array_equal(best, S0.max(axis=1))
    assert n_acc == int((S0.max(axis=1) > 60.0).sum())


def test_dryrun_multichip_on_one_card(dev):
    from vacmap_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(1)


def _band_batch(rng, B, T, W, tail):
    """B ragged pairs padded to T: mutated copies, every third query
    unrelated, every fourth |q - t| >= W, every other with ``tail``
    unrelated bases after the copy (a z-drop)."""
    tg = np.full((B, T), 4, np.uint8)
    qr = np.full((B, T), 4, np.uint8)
    tl = np.zeros(B, np.int32)
    ql = np.zeros(B, np.int32)
    for b in range(B):
        L = int(rng.integers(T // 3, T - tail + 1))
        t = rng.integers(0, 4, L).astype(np.uint8)
        q = t.copy()
        m = rng.random(L) < 0.06
        q[m] = rng.integers(0, 4, int(m.sum()))
        if b % 3 == 2:
            q = rng.integers(0, 4, int(rng.integers(T // 4, T))).astype(np.uint8)
        if b % 4 == 1:
            q = q[: max(1, L - W - int(rng.integers(0, 21)))]
        if tail and b % 2 == 0:
            t = np.concatenate([t, rng.integers(0, 4, tail).astype(np.uint8)])
            q = np.concatenate([q, rng.integers(0, 4, tail).astype(np.uint8)])
        t, q = t[:T], q[:T]
        tg[b, : len(t)], qr[b, : len(q)] = t, q
        tl[b], ql[b] = len(t), len(q)
    return tg, qr, tl, ql


@pytest.mark.parametrize("W", [32, 128, 256, 512])
@pytest.mark.parametrize("glob", [True, False])
def test_affine_band_kernel_matches_plain(dev, W, glob):
    """csrc/affine_band.cu against affine_batch_ref on the card: every
    output equal, the plane byte for byte, in one launch; then on the CPU
    twin's edge batches at this W (chip_smoke.band_edge_batches: global
    and zero-gap ties, or the extension)."""
    from chip_smoke import band_edge_batches
    from vacmap_tpu_torch.ops.affine_batch import affine_batch, affine_batch_ref

    T = 4 * W if glob else 8 * W
    x = [torch.from_numpy(a).to(dev) for a in _band_batch(
        np.random.default_rng(W + glob), 12, T, W, 0 if glob else W)]
    kw = dict(W=W, glob=glob, zdrop=-1 if glob else 60)
    before = affine_batch.launches
    got = affine_batch(*x, **kw)
    torch.cuda.synchronize()
    assert affine_batch.launches == before + 1
    want = affine_batch_ref(*x, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())
    if not glob:
        assert bool(want[4].any()) and not bool(want[4].all())
    edge = band_edge_batches(W)
    for mode in (("global", "ties") if glob else ("extension",)):
        xn, kw, _ = edge[mode]
        x = [torch.from_numpy(a).to(dev) for a in xn]
        got = affine_batch(*x, **kw)
        torch.cuda.synchronize()
        want = affine_batch_ref(*x, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, mode
            assert torch.equal(g.cpu(), w.cpu()), mode


def test_affine_band_kernel_takes_no_plain_route_and_checks_inputs(
        dev, monkeypatch):
    """A CUDA tensor launches the kernel even with the plain version made
    to fail; a bad dtype, shape, band or device raises DeviceKernelError."""
    from vacmap_tpu_torch.device import DeviceKernelError
    from vacmap_tpu_torch.ops import affine_batch as ab

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(ab, "affine_batch_ref", no_plain)
    tg, qr, tl, ql = (torch.from_numpy(a).to(dev) for a in _band_batch(
        np.random.default_rng(3), 4, 128, 32, 0))
    before = ab.affine_batch.launches
    ab.affine_batch(tg, qr, tl, ql, W=32)
    torch.cuda.synchronize()
    assert ab.affine_batch.launches == before + 1
    for bad in (dict(t_len=tl.long()), dict(queries=qr[:, :0]),
                dict(targets=tg.float()), dict(q_len=ql[:2]),
                dict(W=64), dict(queries=qr.cpu())):
        args = dict(targets=tg, queries=qr, t_len=tl, q_len=ql, W=32)
        args.update(bad)
        W = args.pop("W")
        with pytest.raises(DeviceKernelError):
            ab.affine_batch(*args.values(), W=W)
    assert ab.affine_batch.launches == before + 1


@pytest.mark.parametrize("glob", [True, False])
def test_batch_aligner_on_card_matches_plain_groups(dev, glob):
    """BatchAligner on the card against the same groups through the plain
    version on the card: equal results; the global CIGARs walk to the
    host align2p score."""
    from chip_smoke import cigar_score
    from vacmap_tpu_torch.ops.affine_batch import BatchAligner, affine_batch_ref
    from vacmap_tpu_torch.ops.affine_ref import align2p

    class Plain(BatchAligner):
        _affine = staticmethod(affine_batch_ref)

    rng = np.random.default_rng(40 + glob)
    pairs = _pairs(rng, 40, 50, 1500, random_frac=0.0)
    kw = dict(glob=glob) if glob else dict(glob=False, zdrop=50)
    got = BatchAligner(**kw, device=dev).align_batch(pairs, eqx=glob)
    want = Plain(**kw, device=dev).align_batch(pairs, eqx=glob)
    assert got == want
    if glob:  # the walked score; result.score is the best cell
        for (t, q), r in zip(pairs[:10], got):
            assert cigar_score(r.cigar, t, q) == align2p(
                t, q, bw=-1, zdrop=-1).score

