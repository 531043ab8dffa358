"""Peaks of the card and the work a kernel's inputs need (frozen copies of
``chip_smoke.py``'s ``bound``, ``chain_pairs`` and work counts, PERF.md's
kernel table: a chain pair 80 operations, a fill cell 30).

The work is counted from the inputs a launch was given: the pairs that
the anchors below ``n_valid`` need, and the band cells of the fill jobs'
own target lengths.  Padding is never counted.
"""

from __future__ import annotations

import numpy as np

PEAK_OPS = 67e12      # H100 SXM, float32 outside the tensor cores (700 W)
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3
OPS_PER_PAIR = 80     # one pair score of the chain DP (csrc/chain_pair.cuh)
OPS_PER_CELL = 30     # one cell of the two-piece affine fill
BAND_W = 128          # band lanes of csrc/fill_banded.cu
LOCAL_VARIANTS = ("fine", "mismatch")


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds the card could take for this work."""
    return max(ops / PEAK_OPS, nbytes / PEAK_BYTES)


def barriers(anchors: np.ndarray, local: bool) -> np.ndarray:
    """(B, N) barrier of each anchor: its reference start, plus its read
    start in the local variants."""
    bar = anchors[:, :, 0].astype(np.int64)
    if local:
        bar += anchors[:, :, 3]
    return bar


def pairs_of(bar: np.ndarray, n_valid, n_warm) -> int:
    """For every scored row i, the rows j < n_valid with a barrier below
    row i's."""
    total = 0
    for b in range(len(n_valid)):
        x = bar[b, : n_valid[b]]
        total += int(np.searchsorted(np.sort(x), x[n_warm[b]:],
                                     side="left").sum())
    return total


def chain_pairs(anchors, n_valid, n_warm, local):
    """Candidate pairs a chain DP needs for these inputs: for every
    scored row i, the rows j < n_valid with barrier_j < barrier_i."""
    return pairs_of(barriers(anchors, local), n_valid, n_warm)


def chain_work(anchors: np.ndarray, n_valid: np.ndarray, variant: str):
    """(operations, bytes) of one chain_dp launch: pairs at 80 operations;
    each valid anchor's inputs (16 bytes of anchor, a skip cost and a gap
    bound) read once and its S and P written once."""
    return chain_work_of(barriers(anchors, variant in LOCAL_VARIANTS),
                         n_valid)


def chain_work_of(bar: np.ndarray, n_valid: np.ndarray):
    """chain_work from the launch's barriers."""
    n_valid = np.asarray(n_valid)
    pairs = pairs_of(bar, n_valid, np.zeros_like(n_valid))
    rows = int(np.sum(n_valid))
    return pairs * OPS_PER_PAIR, rows * (16 + 4 + 4) + rows * (4 + 4)


def band_work(t_len: np.ndarray, T: int):
    """(operations, bytes) of one fill_banded launch of jobs with target
    lengths ``t_len``: each job's target rows times the band's 128 lanes
    at 30 operations; its target row, band-aligned query and lengths read
    once, its two planes written."""
    t_len = np.asarray(t_len, np.int64)
    cells = int((t_len * BAND_W).sum())
    B = len(t_len)
    return cells * OPS_PER_CELL, B * (T + (T + BAND_W) + 8 + 2 * T)
