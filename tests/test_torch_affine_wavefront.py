"""The CPU twin of csrc/affine_band.cu's order,
``affine_batch_wavefront_ref`` (cell (i, l) at step s = 2i + l, each
lane carrying its row's cummaxes, F and best to the lane on its right),
held bit for bit to the plain row loop ``affine_batch_ref`` at the band
widths the kernel takes (W = 32, 128, 256 and 512: 1, 4, 8 and 16 lanes
a thread) on ``chip_smoke.band_edge_batches``: t_len = q_len = 1,
|q - t| >= W, dlo clamped at -t_len, an all-code-4 target, equal maxima
at several lanes and rows (zero gap costs), a pair that drops at its
first rows and one that never drops.  Tolerance 0 on all six outputs,
planes included (tests/test_torch_affine_batch.py holds the twin to the
JAX function itself)."""

import numpy as np
import pytest
import torch

from chip_smoke import EDGE_ZDROP, band_edge_batches
from vacmap_tpu_torch.ops.affine_batch import (
    affine_batch_ref, affine_batch_wavefront_ref,
)

NAMES = ("tb", "best", "best_i", "best_j", "dead", "dlo")


@pytest.mark.parametrize("mode", ["global", "extension", "ties"])
@pytest.mark.parametrize("W", [32, 128, 256, 512])
def test_wavefront_twin_equals_the_row_loop(W, mode):
    x, kw, roles = band_edge_batches(W)[mode]
    args = [torch.from_numpy(a) for a in x]
    want = affine_batch_ref(*args, **kw)
    got = affine_batch_wavefront_ref(*args, **kw)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    # the edge cases are there
    _, _, tl, ql = x
    best, best_i, best_j, dead, dlo = (a.numpy() for a in want[1:])
    b = roles["clamp"]
    assert dlo[b] == -tl[b]
    for name in ("far_long_query", "far_short_query"):
        if name in roles:
            b = roles[name]
            assert abs(ql[b] - tl[b]) >= W
            assert not dlo[b] <= ql[b] - tl[b] < dlo[b] + W  # end cell out
    assert (tl[roles["one"]], ql[roles["one"]]) == (1, 1)
    if mode == "extension":
        b = roles["unrelated"]
        assert dead[b] and best_i[b] <= 8, (best_i[b], EDGE_ZDROP)
        assert not dead[roles["same"]]
        assert best_i[roles["same"]] == tl[roles["same"]]
    if mode == "ties":
        # H never falls along a row or down a column, so a row's best
        # stands at its last in-band lane too, and every row after best_i
        # holds best: a best short of either end is a tie the lowest lane
        # and the first row won
        right = np.minimum(ql, best_i + dlo + W - 1)
        assert (best_j < right).any()
        assert (best_i < tl).any()
