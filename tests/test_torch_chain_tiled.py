"""The tiled decomposition of the chain DP (csrc/chain_tile.cuh), in its
plain PyTorch form, against the plain row-at-a-time versions and the JAX
scans.

``chain_scores_batch_tiled_ref`` and ``chain_scores_batch_warm_tiled_ref``
compute the DP the way the CUDA kernels do: S-free pair terms and apply,
partial bests over a split of the candidates below a tile, the in-tile
walk, no candidate at or past the row on a sorted read, and the
row-at-a-time route for an unsorted read.  They are held to
``chain_scores_batch_ref`` / ``chain_scores_batch_warm_ref`` exactly (S
bit for bit, P equal), and to the JAX scans at the tolerance of
tests/test_torch_chain.py and tests/test_torch_asm.py: S within atol 1e-3
(rtol 1e-6; XLA-CPU's and torch's log/log2 may differ by an ulp) and P
agreement >= 0.99 (cold) and >= 0.999 (warm)."""

import numpy as np
import pytest
import torch

from vacmap_tpu.ops.chain_jax import chain_scores_batch as jax_chain_scores_batch
from vacmap_tpu.ops.chain_jax import (
    chain_scores_batch_warm as jax_chain_scores_batch_warm,
)
from vacmap_tpu_torch.ops import chain
from vacmap_tpu_torch.ops.chain import (
    chain_scores_batch_ref, chain_scores_batch_tiled_ref,
    chain_scores_batch_warm_ref, chain_scores_batch_warm_tiled_ref,
    prepare_batch, to_device,
)
from tests.test_chain import chainy_anchors, random_anchors

VARIANTS = ["global", "global_nocov", "refund", "fine", "mismatch"]
KW = dict(kmersize=15, maxdiff=50, maxgap=1000, skipcost=40.0)
N = 256  # one width, so one XLA compile a variant


def _local(variant):
    return variant in ("fine", "mismatch")


def _sorted(a, variant):
    key = a[:, 0] + (a[:, 3] if _local(variant) else 0)
    return a[np.argsort(key, kind="stable")]


def _tied(rng, n, variant):
    """n anchors on few read positions (up to 20 share one, as a repeat's
    seeds do), one length, so that groups of equal barrier straddle every
    tile edge; half of them on one diagonal, so that chains form."""
    pos = np.sort(rng.choice(np.arange(0, 3000, 7), max(n // 8, 2), replace=False))
    r = np.sort(rng.choice(pos, n))
    y = np.where(rng.random(n) < 0.5, r + 5000 + rng.integers(-2, 3, n),
                 rng.integers(0, 100_000, n))
    a = np.stack([r, y, rng.choice([-1, 1], n, p=[0.2, 0.8]),
                  np.full(n, 15)], axis=1).astype(np.int64)
    return _sorted(a, variant)


def _overlapping(rng, n, variant):
    """Anchors of mixed length packed so closely that most neighbours
    overlap on the read (negative read gap: the bonus is cut, and the
    local variants' no-progress rule applies to pairs of equal end)."""
    r = np.sort(rng.integers(0, 6 * n, n))
    ln = rng.integers(9, 60, n)
    y = r + 7000 + rng.integers(-4, 5, n)
    a = np.stack([r, y, np.ones(n, np.int64), ln], axis=1).astype(np.int64)
    return _sorted(a, variant)


def _cold_case(rng, case, variant):
    """(anchor list, tile) of one cold case."""
    if case == "ties":
        return [_tied(rng, int(rng.integers(150, 250)), variant)
                for _ in range(3)], 16
    if case == "ragged":
        # n_valid not a multiple of the tile, below one tile, and zero
        alist = [_sorted(chainy_anchors(rng, read_len=4000, noise=20), variant)[:n]
                 for n in (117, 9, 0, 64)]
        return alist, 16
    if case == "unsorted":
        alist = [_sorted(random_anchors(rng, 150), variant) for _ in range(3)]
        bad = _sorted(chainy_anchors(rng, read_len=4000, noise=20), variant)
        bad[[20, 90]] = bad[[90, 20]]
        alist.insert(1, bad)
        return alist, 16
    if case == "overlap":
        return [_overlapping(rng, int(rng.integers(120, 240)), variant)
                for _ in range(3)], 32
    assert case == "tile64"
    return [_sorted(chainy_anchors(rng, read_len=9000, noise=25), variant),
            _sorted(random_anchors(rng, 200), variant)], 64


def _padded(alist, variant):
    arrays = prepare_batch(alist, variant, KW["skipcost"], KW["maxdiff"])
    pad = N - arrays[0].shape[1]
    assert pad >= 0
    return (np.pad(arrays[0], ((0, 0), (0, pad), (0, 0))), arrays[1],
            np.pad(arrays[2], ((0, 0), (0, pad))),
            np.pad(arrays[3], ((0, 0), (0, pad))))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_exact(got, want):
    (S, P), (S0, P0) = got, want
    assert torch.equal(_bits(S), _bits(S0))
    assert torch.equal(P, P0)


@pytest.mark.parametrize("case", ["ties", "ragged", "unsorted", "overlap", "tile64"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_tiled_matches_plain_bit_for_bit(variant, case):
    rng = np.random.default_rng(
        500 + 10 * VARIANTS.index(variant) + len(case) + ord(case[0]))
    alist, tile = _cold_case(rng, case, variant)
    x = to_device("cpu", *_padded(alist, variant))
    kw = {**KW, "variant": variant}
    want = chain_scores_batch_ref(*x, **kw)
    _assert_exact(chain_scores_batch_tiled_ref(*x, **kw, tile=tile), want)
    if case == "ties":
        # the case is what it says: a group of equal barrier lies across
        # a tile edge in every read
        a = x[0].numpy()
        bar = a[:, :, 0] + (a[:, :, 3] if _local(variant) else 0)
        for b, n in enumerate(x[1].tolist()):
            edges = np.arange(tile, n, tile)
            assert (bar[b, edges] == bar[b, edges - 1]).any()
        assert (want[1] >= 0).any()
    if case == "unsorted":
        assert chain._unsorted_reads(
            x[0], x[1], torch.zeros_like(x[1]), _local(variant)).tolist() \
            == [False, True, False, False]
    if case == "overlap":
        a = x[0].numpy()[0, : x[1][0]]
        assert (a[1:, 0] < a[:-1, 0] + a[:-1, 3]).mean() > 0.5


@pytest.mark.parametrize("n_split", [1, 2, 7])
@pytest.mark.parametrize("tile", [8, 64])
def test_any_split_of_the_reduction_gives_the_same_winner(tile, n_split):
    rng = np.random.default_rng(600 + tile + n_split)
    alist = [_tied(rng, 200, "global"), _sorted(random_anchors(rng, 180), "global")]
    x = to_device("cpu", *_padded(alist, "global"))
    want = chain_scores_batch_ref(*x, **KW, variant="global")
    _assert_exact(chain_scores_batch_tiled_ref(
        *x, **KW, variant="global", tile=tile, n_split=n_split), want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_tiled_matches_jax_scan(variant):
    rng = np.random.default_rng(700 + VARIANTS.index(variant))
    alist = [_sorted(chainy_anchors(rng, read_len=5000, noise=20), variant),
             _tied(rng, 180, variant), _overlapping(rng, 150, variant)]
    arrays = _padded(alist, variant)
    kw = {**KW, "variant": variant}
    S_j, P_j = (np.asarray(t) for t in jax_chain_scores_batch(*arrays, **kw))
    S_t, P_t = (t.numpy() for t in chain_scores_batch_tiled_ref(
        *to_device("cpu", *arrays), **kw, tile=32))
    valid = np.arange(N)[None, :] < arrays[1][:, None]
    np.testing.assert_allclose(S_t[valid], S_j[valid], atol=1e-3, rtol=1e-6)
    assert (S_t[~valid] == 0).all() and (P_t[~valid] == -1).all()
    agree = float(np.mean(P_t[valid] == P_j[valid]))
    print(f"tiled chain {variant}: P agreement {agree:.6f}, S max abs err "
          f"{float(np.abs(S_t - S_j)[valid].max()):.3g}")
    assert agree >= 0.99, agree


@pytest.mark.parametrize("variant", VARIANTS)
def test_terms_then_apply_is_the_pair_score(variant):
    """chain_pair.cuh's split: apply(S[j], terms(i, j)) equals the plain
    version's test(i, j) bit for bit, with colinear and bonus."""
    rng = np.random.default_rng(800 + VARIANTS.index(variant))
    a = np.concatenate([random_anchors(rng, 120), _overlapping(rng, 120, variant)])
    A = torch.from_numpy(a.astype(np.int32))
    ai = tuple(A[:, k : k + 1] for k in range(4))
    Aj = tuple(A[None, :, k] for k in range(4))
    Sj = torch.from_numpy((rng.random((1, len(a))) * 500).astype(np.float32))
    skip = torch.from_numpy((40 + rng.integers(0, 21, (len(a), 1))).astype(np.float32))
    md = torch.from_numpy(rng.integers(10, 51, (len(a), 1)).astype(np.int32))
    asm_geo = variant == "global_nocov"
    v = "global" if asm_geo else variant
    args = (skip, md, chain._f32(0.15), 1000, 40.0, v, asm_geo)
    test, colinear, bonus = chain._pair_scores(ai, Aj, Sj, *args)
    terms = chain._pair_terms(ai, Aj, *args)
    assert torch.equal(_bits(chain._apply_terms(Sj, terms)), _bits(test))
    assert torch.equal(terms[5], colinear)
    assert torch.equal(terms[3], bonus.float())
    assert colinear.any() and (~colinear).any()


def test_refund_ledger_across_a_tile_edge():
    """A chain that pays an SV penalty and earns it back further on, with
    the refund's rows on both sides of tile edges: the tiled walk keeps
    the ledger as the plain version does, and the ledger matters (the
    warm DP, which has none, scores the same anchors differently)."""
    rng = np.random.default_rng(77)
    a = chainy_anchors(rng, read_len=6000, noise=25)
    for lo, shift in ((1500, 4000), (3100, 9000), (4700, 2500)):
        a[a[:, 0] >= lo, 1] += shift  # three jumps, colinear runs between
    a = _sorted(a, "refund")
    x = to_device("cpu", *_padded([a], "refund"))
    kw = {**KW, "variant": "refund"}
    want = chain_scores_batch_ref(*x, **kw)
    for tile in (8, 16, 64):
        _assert_exact(chain_scores_batch_tiled_ref(*x, **kw, tile=tile), want)
    zeros = torch.zeros((1, N))
    S_w, _ = chain_scores_batch_warm_ref(
        *x, zeros, zeros.int(), torch.zeros(1, dtype=torch.int32), **kw)
    changed = np.flatnonzero((S_w != want[0]).numpy()[0])
    assert len(changed) and changed.min() // 8 != changed.max() // 8


def _warm_case(rng, case, variant):
    """Two problems behind frontiers in score order: (arrays, warm_S,
    warm_P, n_warm, tile)."""
    n_warm, tile, n = {"ragged": ((17, 12), 16, 150),
                       "frozen_tile": ((70, 3), 16, 150),
                       "cold": ((0, 0), 16, 150),
                       "ties": ((21, 40), 32, 180)}[case]
    alist, w_S, w_P = [], np.zeros((2, N), np.float32), np.zeros((2, N), np.int32)
    for b, nw in enumerate(n_warm):
        if case == "ties":
            a = _tied(rng, n, variant)
        else:
            a = _sorted(chainy_anchors(rng, read_len=6000, noise=15)[:n], variant)
        a[:, 0] += 500
        f = a[rng.permutation(len(a))[:nw]].copy()
        f[:, 0] -= rng.integers(50, 400, nw)
        alist.append(np.concatenate([f, a]) if nw else a)
        w_S[b, :nw] = np.sort(1000.0 - rng.random(nw) * 96.0)
        w_P[b, :nw] = -rng.integers(0, 20000, nw) - 2
    arrays = _padded(alist, variant)
    for b in range(2):  # rows past n_valid hold what the caller left there
        w_S[b, arrays[1][b] :] = 7.5
        w_P[b, arrays[1][b] :] = -3
    return arrays, w_S, w_P, np.array(n_warm, np.int32), tile


@pytest.mark.parametrize("case", ["ragged", "frozen_tile", "cold", "ties"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_warm_tiled_matches_plain_bit_for_bit(variant, case):
    rng = np.random.default_rng(
        900 + 10 * VARIANTS.index(variant) + len(case) + ord(case[0]))
    arrays, w_S, w_P, nw, tile = _warm_case(rng, case, variant)
    x = to_device("cpu", *arrays, w_S, w_P, nw)
    kw = {**KW, "variant": variant}
    want = chain_scores_batch_warm_ref(*x, **kw)
    got = chain_scores_batch_warm_tiled_ref(*x, **kw, tile=tile)
    _assert_exact(got, want)
    S, P = got[0].numpy(), got[1].numpy()
    idx = np.arange(N)[None, :]
    frozen, past = idx < nw[:, None], idx >= arrays[1][:, None]
    assert np.array_equal(S[frozen], w_S[frozen])
    assert np.array_equal(P[frozen], w_P[frozen])
    assert np.array_equal(S[past], w_S[past]) and (P[past & ~frozen] == -1).all()
    if case != "cold":
        # the frontier was used: some scored row links into it
        assert ((P >= 0) & (P < nw[:, None]) & ~frozen & ~past).any()
    if case == "frozen_tile":
        # tiles start at the smaller n_warm: the first problem's next
        # tiles hold frozen rows only, and its last frozen tile is ragged
        assert nw.min() + 2 * tile <= nw.max() and (nw.max() - nw.min()) % tile


@pytest.mark.parametrize("variant", VARIANTS)
def test_warm_tiled_matches_jax_scan(variant):
    rng = np.random.default_rng(1000 + VARIANTS.index(variant))
    arrays, w_S, w_P, nw, _ = _warm_case(rng, "ragged", variant)
    kw = {**KW, "variant": variant}
    S_j, P_j = (np.asarray(t) for t in jax_chain_scores_batch_warm(
        *arrays, w_S, w_P, nw, **kw))
    S_t, P_t = (t.numpy() for t in chain_scores_batch_warm_tiled_ref(
        *to_device("cpu", *arrays, w_S, w_P, nw), **kw, tile=32))
    idx = np.arange(N)[None, :]
    frozen, past = idx < nw[:, None], idx >= arrays[1][:, None]
    scored = ~frozen & ~past
    np.testing.assert_allclose(S_t[scored], S_j[scored], atol=1e-3, rtol=1e-6)
    agree = float(np.mean(P_t[scored] == P_j[scored]))
    print(f"tiled warm chain {variant}: P agreement {agree:.6f}")
    assert agree >= 0.999
    assert np.array_equal(S_t[~scored], S_j[~scored])
    assert np.array_equal(P_t[~scored], P_j[~scored])


def _unsorted_warm_case(rng, variant):
    """Three problems behind ragged frontiers, with ragged n_valid; in the
    middle one two rows past n_warm are swapped, so it is not sorted by
    barrier while the others are.  The rows to score hold what the caller
    left there (2000.0): a row of the unsorted problem sees a candidate
    after it with that S, as in the reference's scan, and the frontier's
    scores (about 1000) do not hide it."""
    n_warm, sizes = (17, 40, 0), (150, 90, 181)
    alist = []
    w_S, w_P = np.zeros((3, N), np.float32), np.zeros((3, N), np.int32)
    for b, (nw, n) in enumerate(zip(n_warm, sizes)):
        a = _sorted(chainy_anchors(rng, read_len=6000, noise=15)[:n], variant)
        a[:, 0] += 500
        f = a[rng.permutation(len(a))[:nw]].copy()
        f[:, 0] -= rng.integers(50, 400, nw)
        if b == 1:
            a[[10, 60]] = a[[60, 10]]
        alist.append(np.concatenate([f, a]) if nw else a)
        w_S[b, :nw] = np.sort(1000.0 - rng.random(nw) * 96.0)
        w_P[b, :nw] = -rng.integers(0, 20000, nw) - 2
    arrays = _padded(alist, variant)
    for b in range(3):
        w_S[b, n_warm[b] :] = 2000.0
        w_S[b, arrays[1][b] :] = 7.5
        w_P[b, arrays[1][b] :] = -3
    return arrays, w_S, w_P, np.array(n_warm, np.int32)


@pytest.mark.parametrize("variant", VARIANTS)
def test_warm_tiled_unsorted_rows_match_plain_and_jax(variant):
    """Rows past n_warm out of barrier order, in one problem of a batch of
    three: the tiled twin sends that problem row by row over every
    candidate, as the kernel does, and gives the plain version's result
    bit for bit, and the JAX warm scan's within the stated tolerance."""
    rng = np.random.default_rng(1100 + VARIANTS.index(variant))
    arrays, w_S, w_P, nw = _unsorted_warm_case(rng, variant)
    x = to_device("cpu", *arrays, w_S, w_P, nw)
    assert chain._unsorted_reads(x[0], x[1], x[6], _local(variant)).tolist() \
        == [False, True, False]
    kw = {**KW, "variant": variant}
    want = chain_scores_batch_warm_ref(*x, **kw)
    _assert_exact(chain_scores_batch_warm_tiled_ref(*x, **kw, tile=16), want)
    S_j, P_j = (np.asarray(t) for t in jax_chain_scores_batch_warm(
        *arrays, w_S, w_P, nw, **kw))
    S_t, P_t = (t.numpy() for t in want)
    idx = np.arange(N)[None, :]
    frozen, past = idx < nw[:, None], idx >= arrays[1][:, None]
    scored = ~frozen & ~past
    np.testing.assert_allclose(S_t[scored], S_j[scored], atol=1e-3, rtol=1e-6)
    agree = float(np.mean(P_t[scored] == P_j[scored]))
    print(f"unsorted warm chain {variant}: P agreement {agree:.6f}")
    assert np.array_equal(P_t, P_j)
    assert np.array_equal(S_t[~scored], S_j[~scored])
    # the case is what it claims: the tiles alone, which see no candidate
    # at or past the row, give the unsorted problem another result
    one = tuple(t[1:2] for t in x)
    S1 = one[4].clone()
    P1 = torch.where(torch.arange(N)[None, :] < one[6][:, None], one[5],
                     torch.full_like(one[5], -1))
    asm_geo = variant == "global_nocov"
    chain._tiled_dp(one[0], one[1], one[2], one[3], S1, P1, one[6],
                    int(one[6][0]), int(one[1][0]), False, chain._f32(0.15),
                    KW["maxgap"], KW["skipcost"],
                    "global" if asm_geo else variant, asm_geo, 16, 3)
    assert not torch.equal(P1, want[1][1:2])


def test_cold_unsorted_read_above_max_n_gives_the_plain_result():
    """Above MAX_N chain_scores_batch takes the warm kernel cold on a card;
    that route's twin gives the plain version's result on an unsorted
    read beside a sorted one (here chain_scores_batch itself is the plain
    version: CPU tensors)."""
    rng = np.random.default_rng(1200)
    width = 2 * chain.MAX_N
    bad = _sorted(chainy_anchors(rng, read_len=8000, noise=30), "global")
    bad[[40, 150]] = bad[[150, 40]]
    alist = [_sorted(random_anchors(rng, 200), "global"), bad]
    arrays = prepare_batch(alist, "global", KW["skipcost"], KW["maxdiff"])
    pad = width - arrays[0].shape[1]
    arrays = (np.pad(arrays[0], ((0, 0), (0, pad), (0, 0))), arrays[1],
              np.pad(arrays[2], ((0, 0), (0, pad))),
              np.pad(arrays[3], ((0, 0), (0, pad))))
    x = to_device("cpu", *arrays)
    assert x[0].shape[1] > chain.MAX_N
    kw = {**KW, "variant": "global"}
    want = chain_scores_batch_ref(*x, **kw)
    _assert_exact(chain.chain_scores_batch(*x, **kw), want)
    zeros = torch.zeros((2, width))
    cold = chain_scores_batch_warm_tiled_ref(
        *x, zeros, zeros.int(), torch.zeros(2, dtype=torch.int32), **kw)
    _assert_exact(cold, want)
    assert chain._unsorted_reads(x[0], x[1], torch.zeros_like(x[1]),
                                 False).tolist() == [False, True]
