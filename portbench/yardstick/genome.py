"""Frozen sequence generators (copied from ``chip_smoke.py``, which made the
port's 100 Mb test genome and its ONT-like reads), widened only by
parameters: the counts of tandem arrays and segmental duplications scale
with the genome, and the error mix of ``mutate_codes`` is an argument whose
default is chip_smoke's 40/30/30.

Codes are 0-3 for A, C, G, T.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
ONT_CUTS = (0.4, 0.7)  # cumulative shares: substitutions, then insertions


def make_genome_codes(rng, n, tandem_arrays=200, segdups=1):
    """A random genome with ``tandem_arrays`` tandem-repeat arrays (a
    300-800 bp unit, 8-20 copies) and ``segdups`` 50 kb blocks each copied
    twice elsewhere (chip_smoke: 200 arrays and one block on 100 Mb)."""
    g = rng.integers(0, 4, n, dtype=np.uint8)
    for _ in range(tandem_arrays):
        unit = rng.integers(0, 4, int(rng.integers(300, 800)), dtype=np.uint8)
        copies = int(rng.integers(8, 20))
        arr = np.tile(unit, copies)
        st = int(rng.integers(0, n - len(arr)))
        g[st : st + len(arr)] = arr
    for _ in range(segdups):
        st = int(rng.integers(0, n - 50_000))
        block = g[st : st + 50_000].copy()
        for _ in range(2):
            dst = int(rng.integers(0, n - 50_000))
            g[dst : dst + 50_000] = block
    return g


def mutate_codes(rng, codes, err, cuts=ONT_CUTS, origin=False):
    """Sequencing errors at rate ``err``: a base is substituted below
    ``err * cuts[0]``, gets an inserted base after it below ``err *
    cuts[1]``, and is deleted below ``err`` (chip_smoke: ~40/30/30).
    With ``origin`` also returns, for each output base, the index of the
    input base it came from (-1 for an inserted base); the draws, and so
    the bases, are the same either way."""
    n = len(codes)
    r = rng.random(n)
    sub = r < err * cuts[0]
    ins = (r >= err * cuts[0]) & (r < err * cuts[1])
    dele = (r >= err * cuts[1]) & (r < err)
    out = codes.copy()
    out[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.uint8)
    rep = np.ones(n, np.int64)
    rep[ins] = 2
    rep[dele] = 0
    expanded = np.repeat(out, rep)
    if ins.any():
        pos = np.cumsum(rep) - 1
        ins_slots = pos[ins]
        expanded[ins_slots] = rng.integers(0, 4, len(ins_slots), dtype=np.uint8)
    if not origin:
        return expanded
    src = np.repeat(np.arange(n, dtype=np.int64), rep)
    if ins.any():
        src[ins_slots] = -1
    return expanded, src


def revcomp_codes(c):
    return (3 - c)[::-1]


def codes_to_str(codes) -> str:
    return BASES[codes].tobytes().decode("ascii")
