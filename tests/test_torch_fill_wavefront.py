"""The wavefront decomposition of the full-width fill (csrc/fill_rows.cuh)
on the CPU: ``_fill_bits_wavefront_ref`` (int32 cells, lanes of C
columns, a row a step in each lane, the horizontal gap by its recurrence
and carried across lanes, the op and flags read from which side of each
maximum won) against the plain f32 prefix-maximum fill ``_fill_bits_ref``
bit for bit, and its row-run planes and op streams against the Pallas
kernels of ``vacmap_tpu.ops.affine_pallas`` in interpret mode.

Cases at N = 64, 160 and 256 (B = 8): t_len 1, q_len 1, t_len = q_len =
N, an all-code-4 target and an all-code-4 query (a base code 4 matches
nothing), a long insertion, a mutated and an unrelated pair; at N = 512
two jobs of two target rows whose insertion runs pass 255 in one row.
Each lane width is taken twice: N / 32 columns a lane, and the kernel's
own (4 from N = 128 up, a warp per 128 columns).  ``_fill_and_rowruns``
packs characters to two bits, so the planes are compared on the jobs
without code 4; the op streams (``_fill_and_traceback`` takes unpacked
characters) on every job."""

import numpy as np
import pytest
import torch

from vacmap_tpu.ops.affine_pallas import (
    _fill_and_rowruns, _fill_and_traceback, pack_chars,
)
from vacmap_tpu_torch.ops.affine_fill import (
    _fill_bits_ref, _fill_bits_wavefront_ref, _op_walk, _rowrun_walk,
)

SCORING = dict(match=2, mismatch=-4, o1=4, e1=2, o2=24, e2=1)
WIDTHS = [64, 160, 256, 512]


def _kernel_cols(N):
    """csrc/fill_rows.cuh::cols_a_lane."""
    c = 1
    while 32 * c < N and c < 4:
        c *= 2
    return c


def _cases(N, rng):
    r = lambda n: rng.integers(0, 4, n).astype(np.uint8)  # noqa: E731
    if N == 512:  # the target matches the query's head; the rest of the
        # query (no base of the target) is one insertion run in the last row
        return [(np.array([0, 1], np.uint8),
                 np.concatenate([[0, 1], 2 + rng.integers(0, 2, 298)]).astype(np.uint8)),
                (np.array([2], np.uint8),
                 np.concatenate([[2], rng.choice([0, 1, 3], 399)]).astype(np.uint8))]
    h = N // 2
    t = r(N)
    q = t.copy()
    m = rng.random(N) < 0.1
    q[m] = r(int(m.sum()))
    short = r(N // 4)
    p = N // 8
    mut = r(h + 7)
    mq = mut.copy()
    mq[rng.random(len(mq)) < 0.08] = 0
    return [
        (r(1), r(h)),  # t_len 1
        (r(h), r(1)),  # q_len 1
        (t, q),  # t_len = q_len = N
        (np.full(h, 4, np.uint8), r(h - 5)),  # all-code-4 target
        (r(h - 3), np.full(h, 4, np.uint8)),  # all-code-4 query
        (short, np.concatenate([short[:p], r(h), short[p:]])),  # insertion
        (mut, mq),
        (r(h), r(h + 9)),  # unrelated
    ]


@pytest.fixture(scope="module", params=WIDTHS)
def width(request):
    """One reference run per width: the planes, the plain fill's table,
    the Pallas kernels' planes and streams, and the wavefront tables."""
    N = request.param
    cases = _cases(N, np.random.default_rng(80 + N))
    B = 8  # the Pallas kernels' job tile
    tT = np.full((B, N), 4, np.uint8)
    tQ = np.full((B, N), 4, np.uint8)
    lens = np.ones((B, 2), np.int32)
    tT[:, 0] = tQ[:, 0] = 1
    for b, (t, q) in enumerate(cases):
        tT[b] = 4
        tQ[b] = 4
        tT[b, : len(t)] = t
        tQ[b, : len(q)] = q
        lens[b] = (len(t), len(q))
    rows = int(lens[:, 0].max())
    x = (torch.from_numpy(tT), torch.from_numpy(tQ))
    wave = {c: _fill_bits_wavefront_ref(*x, rows, cols=c, **SCORING)
            for c in {N // 32, _kernel_cols(N)}}
    return dict(
        N=N, n=len(cases), lens=torch.from_numpy(lens),
        code4=[bool((t == 4).any() or (q == 4).any()) for t, q in cases],
        plain=_fill_bits_ref(*x, rows, **SCORING), wave=wave,
        planes=np.asarray(_fill_and_rowruns(pack_chars(tT, tQ), lens, N=N,
                                            interpret=True)),
        stream=np.asarray(_fill_and_traceback(
            tT.astype(np.int32), tQ.astype(np.int32), lens[:, 0].copy(),
            lens[:, 1].copy(), N=N, interpret=True)))


def test_wavefront_bits_equal_plain_fill(width):
    """Every byte of rows 1..max(t_len), at both lane widths."""
    for cols, bits in width["wave"].items():
        assert bits.dtype == torch.uint8
        assert bits.shape == width["plain"].shape, cols
        assert torch.equal(bits, width["plain"]), cols


def test_wavefront_planes_match_pallas(width):
    n, N = width["n"], width["N"]
    keep = [b for b in range(n) if not width["code4"][b]]
    assert keep
    for cols, bits in width["wave"].items():
        got = _rowrun_walk(bits, width["lens"]).numpy()
        assert got.shape == (8, 2 * N)
        np.testing.assert_array_equal(got[keep], width["planes"][keep],
                                      err_msg=f"cols={cols}")
    if N == 512:  # the last row's run: 298 and 399 (ex bit 1 = n_ins >> 8)
        pl = width["planes"].astype(np.int64)
        assert [pl[0, 1] | (pl[0, N + 1] >> 1) << 8,
                pl[1, 0] | (pl[1, N] >> 1) << 8] == [298, 399]


def test_wavefront_op_streams_match_pallas(width):
    n = width["n"]
    for cols, bits in width["wave"].items():
        got = _op_walk(bits, width["lens"][:, 0], width["lens"][:, 1]).numpy()
        np.testing.assert_array_equal(got[:, :n], width["stream"][:, :n],
                                      err_msg=f"cols={cols}")
