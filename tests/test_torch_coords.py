"""Device coordinates past 2^31 (``vacmap_tpu_torch.ops.chain.device_coords``)
on the CPU.  A human reference in one coordinate space runs past 2^31
(GRCh38 from chr13 on); the chain kernels take int32 anchors, so each
problem's reference column is renumbered: order kept, every long gap cut
to a length at which every clipped term of the pair score saturates.

The plain chain DPs on the renumbered anchors are held to the JAX
package's host DPs on the int64 anchors (``vacmap_tpu.ops.chain_ref``,
``vacmap_tpu.native.chain_dp_native_warm``): P exact, S within atol 1e-3
and rtol 1e-5 (``np.allclose``'s rule, as tests/test_executor.py holds
the JAX package's device chain to the host DP: f32 against f64 sums over
chains of a few thousand).  A read that fits, and a copy with clusters
moved past 2^31, give S and P bit for bit the same."""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from vacmap_tpu import native as jax_pkg_native
from vacmap_tpu.ops.chain_ref import chain_dp
from vacmap_tpu.pipeline.asm import stream_chain as jax_pkg_stream_chain
from vacmap_tpu_torch.ops.chain import (
    COORD_LIMIT, GAP_CLIP, TorchChainBackend, TorchStreamChainBackend,
    chain_scores_batch_ref, chain_scores_batch_warm_ref, device_coords,
    prepare_batch, to_device,
)
from vacmap_tpu_torch.parallel.device_service import TorchAggregatingChainBackend
from vacmap_tpu_torch.pipeline.asm import stream_chain
from tests.test_chain import chainy_anchors

VARIANTS = ["global", "global_nocov", "refund", "fine", "mismatch"]
LAYOUTS = ["shifted", "split", "edges"]
KW = dict(kmersize=15, maxdiff=50, maxgap=1000, skipcost=40.0)


def _sorted(A, variant):
    key = A[:, 0] + (A[:, 3] if variant in ("fine", "mismatch") else 0)
    return A[np.argsort(key, kind="stable")]


def _layout(kind, variant, seed=5):
    """One read of two chained halves (4 kb each, with noise anchors):
    (i) "shifted": both past 2^31; (ii) "split": 2^31 apart; (iii)
    "edges": the first half ends at 2^31 - 1 and the second starts at 0,
    100 read bases on, so that one pair's readgap - refgap is exactly
    2^31 (int32 INT_MIN, whose absolute value is still negative)."""
    rng = np.random.default_rng(seed)
    a = chainy_anchors(rng, read_len=4000, noise=12)
    b = chainy_anchors(rng, read_len=4000, noise=12)
    if kind == "edges":
        a[:, 1] += 2**31 - 1 - (a[:, 1] + a[:, 3]).max()
        b[:, 1] -= b[:, 1].min()
        j = int(np.argmax(a[:, 1] + a[:, 3]))
        a[j, 2] = 1
        b[:, 0] += int(a[j, 0] + a[j, 3] + 100 - b[0, 0])
        b[0, 1:3] = (99, 1)
    else:
        b[:, 0] += 4000
        lo = 2**31 + 12_345 if kind == "shifted" else 1_000_000
        a[:, 1] += lo
        b[:, 1] += lo + (7_655 if kind == "shifted" else 2**31 + 777)
    return _sorted(np.concatenate([a, b]), variant)


def _plain(alist, variant, cast=None):
    """The plain chain DP of each read through prepare_batch, as the
    device entry points build their launches; (S, P) per read."""
    arrays = list(prepare_batch(alist, variant, KW["skipcost"], KW["maxdiff"]))
    if cast is not None:
        arrays[0] = cast
    S, P = chain_scores_batch_ref(*to_device("cpu", *arrays), variant=variant,
                                  **KW)
    return [(S[b, : len(a)].numpy(), P[b, : len(a)].numpy())
            for b, a in enumerate(alist)]


def _held_to_host(S, P, want_S, want_P):
    np.testing.assert_array_equal(P, want_P)
    np.testing.assert_allclose(S, want_S, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_dp_on_device_coords_matches_host_dp(variant, kind):
    A = _layout(kind, variant)
    D = device_coords(A, KW["maxdiff"])
    # renumbered: rows in place, strands, read positions and lengths kept
    assert D is not None and D.dtype == np.int32
    assert 0 <= D[:, 1].min() and D[:, 1].max() < COORD_LIMIT
    np.testing.assert_array_equal(D[:, [0, 2, 3]], A[:, [0, 2, 3]])
    assert (np.sign(np.diff(D[:, 1].astype(np.int64)))
            == np.sign(np.diff(A[:, 1]))).all()
    want = chain_dp(A, variant=variant, **KW)
    assert not want.aborted
    (S, P), = _plain([A], variant)
    _held_to_host(S, P, want.S, want.P)
    assert len(P) > 100 and (P >= 0).mean() > 0.9


@pytest.mark.parametrize("kind", LAYOUTS)
def test_warm_dp_on_device_coords_matches_host_warm_dp(kind):
    """The asm stream's warm DP: a frontier of 24 rows (scores of the
    host DP on them, cross-block codes) and the rest as the block, one
    problem renumbered together."""
    variant = "global_nocov"
    A = _layout(kind, variant)
    nw = 24
    front = chain_dp(A[:nw], variant=variant, **KW)
    w_S = front.S
    w_P = -2 - np.arange(nw, dtype=np.int64)
    want_S, want_P, aborted = jax_pkg_native.chain_dp_native_warm(
        A, KW["kmersize"], KW["skipcost"], KW["maxdiff"], KW["maxgap"],
        variant, w_S, w_P)
    assert not aborted
    arrays = prepare_batch([A], variant, KW["skipcost"], KW["maxdiff"])
    n, N = len(A), arrays[0].shape[1]
    wS = np.zeros((1, N), np.float32)
    wP = np.zeros((1, N), np.int32)
    wS[0, :nw], wP[0, :nw] = w_S, w_P
    S, P = chain_scores_batch_warm_ref(
        *to_device("cpu", *arrays, wS, wP, np.array([nw], np.int32)),
        variant=variant, **KW)
    _held_to_host(S[0, :n].numpy(), P[0, :n].numpy(), want_S, want_P)
    # some block row links into the frontier
    assert ((P[0, nw:n] >= 0) & (P[0, nw:n] < nw)).any()


def test_unguarded_int32_cast_wraps_on_the_edges_read():
    """Why the bound is 2^30 and not 2^31: the "edges" read fits int32 as
    given, but the pair 2^31 apart wraps readgap - refgap to INT_MIN, and
    the global DP's scores go wrong on the plain anchors cast as they are
    (what the device entry points launched before renumbering)."""
    variant = "global"
    A = _layout("edges", variant)
    assert A[:, 1].max() < 2**31
    want = chain_dp(A, variant=variant, **KW)
    N = prepare_batch([A], variant, 40.0, 50)[0].shape[1]
    cast = np.zeros((1, N, 4), np.int32)
    cast[0, : len(A)] = A.astype(np.int32)
    (S0, P0), = _plain([A], variant, cast=cast)
    assert np.abs(S0 - want.S).max() > 1e6
    (S, P), = _plain([A], variant)
    _held_to_host(S, P, want.S, want.P)


def _clustered(rng, n_clusters, read_lens, noises, strands, extra):
    """A read of n_clusters segments, each a chainy cluster (its own
    locus, strand-flipped where strands says -1), the loci far enough
    apart that every pair across two clusters is already past every
    clip of the pair score; the reference coordinates fit as given."""
    parts, r0 = [], 0
    for k in range(n_clusters):
        c = chainy_anchors(rng, read_len=read_lens[k], noise=noises[k])
        c[:, 0] += r0
        c[:, 2] *= strands[k]
        r0 += read_lens[k]
        parts.append(c)
    rspan = r0 + 20
    y0 = 0
    for k, c in enumerate(parts):
        c[:, 1] += y0 - c[:, 1].min()
        y0 = int(c[:, 1].max()) + 2 * rspan + 2 * 20 + GAP_CLIP + 1 + extra[k]
    return np.concatenate(parts)


def _moved(A, bounds, offsets):
    """A copy with the clusters from index bounds[k] on moved by
    offsets[k] more (offsets >= 0, so the order of the loci stays)."""
    B = A.copy()
    for lo, off in zip(bounds, offsets):
        B[lo:, 1] += off
    return B


def _bit_equal(a, b):
    return np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("variant", VARIANTS)
def test_moving_far_clusters_past_2_31_changes_nothing(variant):
    """A read that fits goes to the device as it is (bit for bit the
    int32 cast); moving its far clusters past 2^31 renumbers it, and the
    plain DP then gives the same S and P bit for bit."""
    rng = np.random.default_rng(31 + VARIANTS.index(variant))
    A = _clustered(rng, 3, [2500, 1800, 3000], [8, 5, 10], [1, -1, 1],
                   [400_000, 0, 0])
    D = device_coords(A, KW["maxdiff"])
    assert D.dtype == np.int32 and np.array_equal(D, A.astype(np.int32))
    n0, n1 = (A[:, 0] < 2500).sum(), (A[:, 0] < 4300).sum()
    B = _moved(A, [n0, n1], [2**31 + 5, 3 * 2**30])
    assert B[:, 1].max() > 2**32 and not np.array_equal(
        device_coords(B, KW["maxdiff"]), B.astype(np.int32))
    got, want = _plain([_sorted(B, variant), _sorted(A, variant)], variant)
    assert _bit_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert (want[1] >= 0).mean() > 0.8


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_far_cluster_moves_are_exact_property(data):
    """(b) over random layouts: 2-4 clusters of 200-1500 read bases, any
    strands, loci spread further at random, a random suffix of clusters
    moved by 2^31 to 2^33 (more for later ones): S and P bit-equal to
    the read as it was, in every variant."""
    n = data.draw(st.integers(2, 4), label="clusters")
    lens = data.draw(st.lists(st.integers(200, 1500), min_size=n, max_size=n))
    noises = data.draw(st.lists(st.integers(0, 6), min_size=n, max_size=n))
    strands = data.draw(st.lists(st.sampled_from([1, -1]), min_size=n,
                                 max_size=n))
    extra = data.draw(st.lists(st.integers(0, 5_000_000), min_size=n,
                               max_size=n))
    first = data.draw(st.integers(0, n - 1), label="first moved cluster")
    offs = data.draw(st.lists(st.integers(2**31, 2**33), min_size=n - first,
                              max_size=n - first))
    variant = data.draw(st.sampled_from(VARIANTS))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    A = _clustered(rng, n, lens, noises, strands, extra)
    bounds = [int((A[:, 0] < sum(lens[:k])).sum()) for k in range(first, n)]
    B = _moved(A, bounds, offs)
    assert device_coords(A, KW["maxdiff"]) is not None
    got, want = _plain([_sorted(B, variant), _sorted(A, variant)], variant)
    assert _bit_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_device_coords_declines_what_cannot_fit():
    """None only when the renumbered problem fails the 2^30 bound: a read
    span of 2^29 makes one cut gap alone longer than 2^30; a read
    position of 2^30 fails as given."""
    rng = np.random.default_rng(3)
    A = chainy_anchors(rng, read_len=2000, noise=0)
    A[:, 1] += 2**31
    assert device_coords(A) is not None
    wide = A.copy()
    wide[-1, 0] = 2**29
    wide[-1, 1] += 2**32
    assert device_coords(wide) is None
    far = A.copy()
    far[-1, 0] = 2**30
    assert device_coords(far) is None
    assert device_coords(np.zeros((0, 4), np.int64)).shape == (0, 4)


def test_backends_chain_past_2_31_and_count_declines():
    """The per-call and the aggregating backend take a read past 2^31
    (the host DP's result), and the aggregating one counts what it
    declines by cause."""
    A = _layout("split", "fine")
    want = chain_dp(A, variant="fine", **KW)
    args = ("fine", KW["kmersize"], KW["skipcost"], KW["maxdiff"],
            KW["maxgap"])
    res = TorchChainBackend("cpu")(A, *args)
    _held_to_host(res.S, res.P, want.S, want.P)
    agg = TorchAggregatingChainBackend("cpu", max_wait_ms=0.0)
    res = agg(A, *args)
    _held_to_host(res.S, res.P, want.S, want.P)
    wide = A.copy()
    wide[-1, 0] = 2**29
    wide[-1, 1] += 2**32
    assert agg(wide, *args) is None
    assert agg(A, "scar", *args[1:]) is None
    assert agg(A[:0], *args) is None
    assert agg.chained == 1
    assert agg.declined == {"variant": 1, "size": 1, "coords": 1}


def test_stream_chain_past_2_31_on_the_device_backend():
    """asm round 1: a chain with an SV jump in three blocks, all past
    2^31 and 2^31 apart in the middle: every block chained by the warm
    DP's plain version, the stream equal to the native one's and to the
    JAX package's (whose backend leaves such blocks to the native DP)."""
    rng = np.random.default_rng(5)
    r = np.arange(0, 6000, 23)
    y = r + 2**31 + 54_321 + rng.integers(-3, 4, len(r))
    y[len(y) // 2 :] += 2**31
    a = np.stack([r, y, np.ones_like(r), np.full_like(r, 15)], 1)
    batches = [a[: len(a) // 3], a[len(a) // 3 : 2 * len(a) // 3],
               a[2 * len(a) // 3 :]]
    args = (15, 40.0, 50, 1000, "global_nocov", None)
    be = TorchStreamChainBackend("cpu")
    got = stream_chain(iter(batches), *args, chain_backend=be)
    assert got == stream_chain(iter(batches), *args)
    assert got == jax_pkg_stream_chain(iter(batches), *args)
    assert len(got) > 50
    assert be.calls == be.engaged == 3
    assert be.declined == {"variant": 0, "size": 0, "coords": 0}
