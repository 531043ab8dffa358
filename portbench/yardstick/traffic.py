"""The one generator of every traffic mix: a sample haplotype with
structural variants, and a pool of reads from it, all drawn from the seed
and the mix's parameters (a JSON file under ``portbench/traffic/``).

Parameters of a mix:

- ``lengths``: ``{"dist": "lognormal", "median", "n50", "min", "max"}``
  (the log-normal whose length-weighted median is ``n50``) or
  ``{"dist": "normal", "mean", "sd", "min", "max"}``; clipped to
  [min, max].
- ``error``: ``{"low", "high"}``, a read's error rate, uniform; and
  ``error_mix``: ``{"sub", "ins", "del"}``, shares summing to 1.
- ``reverse_share``: the share of reads from the reverse strand.
- ``block_reads``: every block of this many reads holds the same
  lengths and error rates (the mix's quantiles at (i + 1/2) / block),
  in an order drawn from the seed, so every seed maps the same work in
  whole blocks and the seed changes only where the reads come from.
- ``svs``: ``{"spacing": bp of haplotype per event, "kinds": {KIND:
  [share, min_len, max_len]}}`` with KIND in DEL, INS, INV, DUP (a tandem
  copy) and TRA (two loci swap segments of one length, as ``vacsim``'s
  TRA does); one event in each slot of ``spacing`` bases, at a random
  offset, lengths log-uniform (stratified in the same way).
- ``pool_mbp_per_s``: bases of the pool per second of the window, in Mbp;
  set at three times or more the rate the cell measured, so that the
  window never drains the pool.
- ``warm_reads``: reads of an extra block that set-up maps to warm every
  shape (never in the pool).
"""

from __future__ import annotations

import dataclasses
import math
import multiprocessing
from statistics import NormalDist
from typing import List, Tuple

import numpy as np

from .genome import codes_to_str, mutate_codes, revcomp_codes

KINDS = ("DEL", "INS", "INV", "DUP", "TRA")
SV_MARGIN = 2_000  # bases between an event's end and its slot's end
TRUTH_STEP = 50    # read bases between two of a read's truth points


@dataclasses.dataclass
class HapMap:
    """Where each piece of the haplotype came from: bases [hap_start,
    hap_start + length) are the genome's from genome_start on, on strand
    +1, or its reverse complement (-1), or new sequence (0)."""
    hap_start: np.ndarray
    genome_start: np.ndarray
    length: np.ndarray
    strand: np.ndarray

    def to_genome(self, h: np.ndarray):
        """(genome position, strand) of haplotype positions ``h``."""
        k = np.searchsorted(self.hap_start, h, side="right") - 1
        off = h - self.hap_start[k]
        g0, s = self.genome_start[k], self.strand[k]
        return np.where(s < 0, g0 + self.length[k] - 1 - off, g0 + off), s


@dataclasses.dataclass
class Pool:
    """Reads as the program takes them, ``(name, sequence)``, and what
    each is: length on the haplotype, error rate, start on the
    haplotype, strand, and whether it covers a structural variant."""
    reads: List[Tuple[str, str]]
    frag_len: np.ndarray
    err: np.ndarray
    hap_start: np.ndarray
    reverse: np.ndarray
    spans_sv: np.ndarray
    # for every TRUTH_STEP-th base of a read, the index of the fragment's
    # base it came from (-1: a sequencing insertion)
    origin: List[np.ndarray]
    hap: "HapMap | None" = None

    def truth(self, i: int):
        """Read ``i``'s truth points: (read positions, genome positions,
        strands), the strand +1 where the read is the genome's forward
        strand; inserted bases and new sequence are left out."""
        k = self.origin[i].astype(np.int64)
        r = np.arange(len(k), dtype=np.int64) * TRUTH_STEP
        keep = k >= 0
        r, k = r[keep], k[keep]
        L = int(self.frag_len[i])
        h = self.hap_start[i] + (L - 1 - k if self.reverse[i] else k)
        g, s = self.hap.to_genome(h)
        s = -s if self.reverse[i] else s
        keep = s != 0
        return r[keep], g[keep], s[keep]

    @property
    def bases(self) -> int:
        return sum(len(s) for _, s in self.reads)


def length_quantiles(spec: dict, n: int) -> np.ndarray:
    """The mix's read lengths at the quantiles (i + 1/2) / n."""
    q = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
    if spec["dist"] == "lognormal":
        sigma = math.sqrt(math.log(spec["n50"] / spec["median"]))
        x = spec["median"] * np.exp(sigma * z)
    elif spec["dist"] == "normal":
        x = spec["mean"] + spec["sd"] * z
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def error_quantiles(spec: dict, n: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    return spec["low"] + (spec["high"] - spec["low"]) * q


def error_cuts(mix: dict) -> Tuple[float, float]:
    total = mix["sub"] + mix["ins"] + mix["del"]
    if abs(total - 1) > 1e-9:
        raise ValueError(f"error_mix shares sum to {total}, not 1")
    return (round(mix["sub"], 12), round(mix["sub"] + mix["ins"], 12))


def sv_events(rng, genome_len: int, svs: dict) -> List[Tuple[str, int, int, int]]:
    """Events ``(kind, position, length, partner position)`` in genome
    coordinates, one a slot, sorted by position; a TRA's partner is the
    position of the TRA it swaps with (-1 for the other kinds)."""
    spacing = int(svs["spacing"])
    n = genome_len // spacing
    kinds = svs["kinds"]
    # shares to counts by largest remainder, all slots at most
    want = {k: v[0] * n for k, v in kinds.items()}
    counts = {k: int(x) for k, x in want.items()}
    left = min(n, int(round(sum(want.values())))) - sum(counts.values())
    for k in sorted(want, key=lambda k: counts[k] - want[k])[:max(left, 0)]:
        counts[k] += 1
    if counts.get("TRA", 0) % 2:  # TRAs come in pairs
        counts["TRA"] -= 1
    total = sum(counts.values())
    labels = [k for k in KINDS if k in counts for _ in range(counts[k])]
    lens = []
    for k in KINDS:
        if k not in counts:
            continue
        lo, hi = kinds[k][1], kinds[k][2]
        if lo + SV_MARGIN > spacing:
            raise ValueError(f"{k} events of {lo} bp do not fit a slot")
        q = (np.arange(counts[k]) + 0.5) / max(counts[k], 1)
        ln = np.exp(np.log(lo) + (np.log(hi) - np.log(lo)) * q)
        lens.extend(np.rint(rng.permutation(ln)).astype(np.int64).tolist())
    slots = np.sort(rng.choice(n, total, replace=False))
    order = rng.permutation(total)
    events = []
    for s, i in zip(slots, order):
        k, ln = labels[i], int(lens[i])
        ln = min(ln, spacing - SV_MARGIN)
        off = int(rng.integers(0, spacing - SV_MARGIN - ln + 1))
        events.append([k, int(s) * spacing + off, ln, -1])
    tra = [e for e in events if e[0] == "TRA"]
    tra = [tra[i] for i in rng.permutation(len(tra))]
    for a, b in zip(tra[0::2], tra[1::2]):
        ln = min(a[2], b[2])
        a[2] = b[2] = ln
        a[3], b[3] = b[1], a[1]
    return [tuple(e) for e in events]


def haplotype(rng, genome: np.ndarray, events):
    """The sample haplotype, each event's span on it ([start, end), at
    least one base: a deletion is its junction), and its HapMap."""
    pieces, spans, cur, out = [], [], 0, 0
    origin = []  # (hap start, genome start, length, strand)
    for kind, p, ln, partner in events:
        pieces.append(genome[cur:p])
        origin.append((out, cur, p - cur, 1))
        out += p - cur
        if kind == "DEL":
            alt, cur, parts = genome[p:p], p + ln, []
        elif kind == "INS":
            alt, cur = rng.integers(0, 4, ln, dtype=np.uint8), p
            parts = [(0, 0, ln, 0)]
        elif kind == "INV":
            alt, cur = revcomp_codes(genome[p : p + ln]), p + ln
            parts = [(0, p, ln, -1)]
        elif kind == "DUP":
            alt, cur = np.concatenate([genome[p : p + ln]] * 2), p + ln
            parts = [(0, p, ln, 1), (ln, p, ln, 1)]
        else:  # TRA: this locus takes its partner's segment
            alt, cur = genome[partner : partner + ln], p + ln
            parts = [(0, partner, ln, 1)]
        pieces.append(alt)
        origin.extend((out + o, g0, n, st) for o, g0, n, st in parts)
        spans.append((out, out + max(len(alt), 1)))
        out += len(alt)
    pieces.append(genome[cur:])
    origin.append((out, cur, len(genome) - cur, 1))
    o = np.array([x for x in origin if x[2] > 0], np.int64).reshape(-1, 4)
    hap_map = HapMap(*(np.ascontiguousarray(o[:, j]) for j in range(4)))
    return (np.concatenate(pieces), np.array(spans, np.int64).reshape(-1, 2),
            hap_map)


_WORK = {}  # the haplotype and mix of make_reads, inherited by its workers


def _block(args):
    b, child = args
    hap, mix, prefix = _WORK["hap"], _WORK["mix"], _WORK["prefix"]
    block = int(mix["block_reads"])
    rng = np.random.default_rng(child)
    lens = rng.permutation(length_quantiles(mix["lengths"], block))
    errs = rng.permutation(error_quantiles(mix["error"], block))
    starts = (rng.random(block) * (len(hap) - lens)).astype(np.int64)
    rev = rng.random(block) < mix["reverse_share"]
    cuts = error_cuts(mix["error_mix"])
    reads, origin = [], []
    for i in range(block):
        frag = hap[starts[i] : starts[i] + lens[i]]
        if rev[i]:
            frag = revcomp_codes(frag)
        codes, src = mutate_codes(rng, frag, float(errs[i]), cuts,
                                  origin=True)
        reads.append((f"{prefix}{b * block + i}", codes_to_str(codes)))
        origin.append(src[::TRUTH_STEP].astype(np.int32))
    return reads, lens, errs, starts, rev, origin


def make_reads(seq: np.random.SeedSequence, hap: np.ndarray,
               sv_spans: np.ndarray, mix: dict, n_blocks: int,
               prefix: str, workers: int = 1, hap_map=None) -> Pool:
    """``n_blocks`` blocks of reads, each block from its own stream of
    ``seq``, made by ``workers`` forked processes (the number changes no
    read).  Fork only before the process has set CUDA up."""
    _WORK.update(hap=hap, mix=mix, prefix=prefix)
    jobs = list(enumerate(seq.spawn(n_blocks)))
    try:
        if workers > 1 and n_blocks > 1:
            ctx = multiprocessing.get_context("fork")
            with ctx.Pool(min(workers, n_blocks)) as pool:
                parts = pool.map(_block, jobs, chunksize=1)
        else:
            parts = [_block(j) for j in jobs]
    finally:
        _WORK.clear()
    lens = np.concatenate([p[1] for p in parts])
    starts = np.concatenate([p[3] for p in parts])
    ends = starts + lens
    lo = np.searchsorted(sv_spans[:, 1], starts, side="right")
    spans_sv = (lo < len(sv_spans)) & (
        sv_spans[np.minimum(lo, len(sv_spans) - 1), 0] < ends)
    return Pool([r for p in parts for r in p[0]], lens,
                np.concatenate([p[2] for p in parts]), starts,
                np.concatenate([p[4] for p in parts]), spans_sv,
                [o for p in parts for o in p[5]], hap_map)


def generate(genome: np.ndarray, mix: dict, seed: int, seconds: float,
             workers: int = 1):
    """(warm-up reads, pool) for one run; the same seed gives the same
    reads.  The pool holds at least ``pool_mbp_per_s * seconds`` Mbp in
    whole blocks."""
    root = np.random.SeedSequence([int(seed) & (2**64 - 1), 0x9E3779B9])
    sv_seq, warm_seq, pool_seq = root.spawn(3)
    rng = np.random.default_rng(sv_seq)
    events = sv_events(rng, len(genome), mix["svs"])
    hap, spans, hap_map = haplotype(rng, genome, events)
    block = int(mix["block_reads"])
    lq = length_quantiles(mix["lengths"], block)
    want = mix["pool_mbp_per_s"] * 1e6 * seconds
    n_blocks = max(1, math.ceil(want / lq.sum()))
    warm = make_reads(warm_seq, hap, spans, mix, 1, "warm")
    warm.reads = warm.reads[: int(mix["warm_reads"])]
    pool = make_reads(pool_seq, hap, spans, mix, n_blocks, "read", workers,
                      hap_map)
    return warm, pool
