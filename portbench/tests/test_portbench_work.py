"""The frozen work counts and peaks agree with chip_smoke.py's on its own
inputs."""

import numpy as np
import pytest

import chip_smoke as cs
from yardstick import work


def test_constants_equal_chip_smoke():
    assert (work.PEAK_OPS, work.PEAK_BYTES, work.OPS_PER_PAIR,
            work.OPS_PER_CELL) == (cs.PEAK_OPS, cs.PEAK_BYTES,
                                   cs.OPS_PER_PAIR, cs.OPS_PER_CELL)
    for ops, nb in ((1e9, 1e6), (1e6, 1e9)):
        assert work.bound_s(ops, nb) * 1e3 == pytest.approx(
            cs.bound(ops, nb)[0], rel=1e-12)


@pytest.mark.parametrize("local", [False, True])
def test_chain_pairs_equal_chip_smoke(local):
    rng = np.random.default_rng(4)
    reads = [cs.sv_anchors(rng, n, local) for n in (300, 1000, 64)]
    N = 1024
    A = np.zeros((len(reads), N, 4), np.int32)
    nv = np.array([len(r) for r in reads], np.int32)
    for b, r in enumerate(reads):
        A[b, : len(r)] = r
    want = cs.chain_pairs(A, nv, np.zeros_like(nv), local)
    assert work.chain_pairs(A, nv, np.zeros_like(nv), local) == want
    ops, nbytes = work.chain_work(A, nv, "fine" if local else "global")
    assert ops == want * cs.OPS_PER_PAIR
    assert nbytes == int(nv.sum()) * 32


def test_band_cells_equal_chip_smoke():
    rng = np.random.default_rng(5)
    g = cs.make_genome_codes(np.random.default_rng(1), 1_000_000)
    pairs = cs.fill_pairs(rng, g, 16, 30, 256)
    lens = np.array([[len(t), len(q)] for t, q in pairs], np.int32)
    want = int((lens[:, 0].astype(np.int64) * 128).sum()) * cs.OPS_PER_CELL
    ops, _ = work.band_work(lens[:, 0], 256)
    assert ops == want
