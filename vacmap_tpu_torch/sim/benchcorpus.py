"""The SV-accuracy corpus (counterpart of ``vacmap_tpu/sim/benchcorpus.py``:
the same genome, truth set and reads from the same seeds).

An accuracy measurement compares aligners on the SAME reads, so the
corpus generation lives here once.

Workload design: a 400 kb mostly-unique
genome with a realistic density of tandem arrays; events span mid-size
simple DEL/INS/INV/DUP, small (60-150 bp, near the 7%-error noise
floor) indels, and nested Random recipes — the reference's non-linear
chaining specialty (VACmap's own validation recipe: vacsim events,
then an SV caller over the alignments).
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)

PARAMS = (
    "Specified{DEL:300:900;number=2}\n"
    "Specified{INS:300:900;number=2}\n"
    "Specified{INV:800:2000;number=2}\n"
    "Specified{DUP:400:900:0:1;number=2}\n"
    "Specified{DEL:60:150;number=3}\n"
    "Specified{INS:60:150;number=3}\n"
    "Random{eventset=['DEL:200:600,NML:100:300,INV:300:900',"
    "'INS:200:600,NML:100:300,DEL:200:600'];"
    "eventcount=[2,4];number=3}\n"
)
READ_LEN = 12_000
ERR = 0.07
READ_SEEDS = (99, 123)


def codes_to_str(codes):
    return _BASES[codes].tobytes().decode("ascii")


def mutate_codes(rng, codes, err):
    """ONT-like errors, vectorized: ~40% mismatch, 30% ins, 30% del.
    (The JAX package's mutator, kept here so corpora are shared.)"""
    n = len(codes)
    r = rng.random(n)
    sub = r < err * 0.4
    ins = (r >= err * 0.4) & (r < err * 0.7)
    dele = (r >= err * 0.7) & (r < err)
    out = codes.copy()
    out[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.uint8)
    rep = np.ones(n, np.int64)
    rep[ins] = 2
    rep[dele] = 0
    expanded = np.repeat(out, rep)
    if ins.any():
        pos = np.cumsum(rep) - 1
        ins_slots = pos[ins]
        expanded[ins_slots] = rng.integers(
            0, 4, len(ins_slots), dtype=np.uint8)
    return expanded


def sv_genome():
    """The 400 kb SV-accuracy genome (deterministic)."""
    rng_sv = np.random.default_rng(99)
    svg = rng_sv.integers(0, 4, 400_000, dtype=np.uint8)
    for _ in range(8):
        unit = rng_sv.integers(
            0, 4, int(rng_sv.integers(300, 800)), dtype=np.uint8)
        arr = np.tile(unit, int(rng_sv.integers(8, 20)))
        st_ = int(rng_sv.integers(0, len(svg) - len(arr)))
        svg[st_: st_ + len(arr)] = arr
    return {"chrS": codes_to_str(svg)}


def sv_world():
    """(genome_dict, altered_dict, truth_rows) for the bench corpus."""
    from .vacsim import simulate

    genome = sv_genome()
    altered, truth = simulate(PARAMS, genome, heterozygous_ratio=0.0,
                              seed=7)
    return genome, altered, truth


def sample_reads(alt: str, seed: int, coverage: int = 6):
    """The bench's read sample for one seed: [(name, read_str), ...]."""
    from ..seq import encode, revcomp

    rl = READ_LEN
    n_r = max(1, coverage * len(alt) // rl)
    rng_r = np.random.default_rng(seed)
    reads = []
    for i in range(n_r):
        st = int(rng_r.integers(0, max(1, len(alt) - rl)))
        frag = encode(alt[st: st + rl])
        read = codes_to_str(mutate_codes(rng_r, frag, ERR))
        if rng_r.random() < 0.5:
            read = revcomp(read)
        reads.append((f"sv{i}", read))
    return reads


# ---------------------------------------------------------------------------
# Scaled corpus (round 5): >=200 truth events across DEL/INS/INV/DUP/TRA
# plus nested Random recipes, two contigs so TRA has a real cross-contig
# signature (the scale of VACmap's own vacsim validation)
# ---------------------------------------------------------------------------

PARAMS_LARGE = (
    "Specified{DEL:300:900;number=24}\n"
    "Specified{INS:300:900;number=24}\n"
    "Specified{INV:800:2000;number=24}\n"
    "Specified{DUP:400:900:0:1;number=24}\n"
    "Specified{TRA:600:1500:0;number=16}\n"
    "Specified{DEL:60:150;number=26}\n"
    "Specified{INS:60:150;number=26}\n"
    "Random{eventset=['DEL:200:600,NML:100:300,INV:300:900',"
    "'INS:200:600,NML:100:300,DEL:200:600'];"
    "eventcount=[2,4];number=26}\n"
)


def _mkcontig(seed: int, n: int):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n, dtype=np.uint8)
    for _ in range(max(2, n // 50_000)):
        unit = rng.integers(
            0, 4, int(rng.integers(300, 800)), dtype=np.uint8)
        arr = np.tile(unit, int(rng.integers(8, 20)))
        st_ = int(rng.integers(0, n - len(arr)))
        g[st_: st_ + len(arr)] = arr
    return codes_to_str(g)


def sv_genome_large():
    """Two 600 kb contigs (deterministic) for the scaled SV corpus."""
    return {"chrS1": _mkcontig(99, 600_000),
            "chrS2": _mkcontig(101, 600_000)}


def sv_world_large():
    """(genome, altered, truth) with >=200 DEDUPED truth events.  TRA
    materializes two ops carrying the same truth row (vacsim.py TRA
    branch), so rows are deduplicated before scoring."""
    from .vacsim import simulate

    genome = sv_genome_large()
    altered, truth = simulate(PARAMS_LARGE, genome,
                              heterozygous_ratio=0.0, seed=7)
    seen, dedup = set(), []
    for row in truth:
        key = str(row)
        if key not in seen:
            seen.add(key)
            dedup.append(row)
    return genome, altered, dedup


def sample_reads_multi(altered: dict, seed: int, coverage: int = 6):
    """Reads sampled across ALL altered contigs proportional to length
    (multi-contig twin of sample_reads; same error model)."""
    from ..seq import encode, revcomp

    rl = READ_LEN
    names = sorted(altered)
    lens = np.array([len(altered[n]) for n in names], np.float64)
    total = int(lens.sum())
    n_r = max(1, coverage * total // rl)
    rng_r = np.random.default_rng(seed)
    probs = lens / lens.sum()
    reads = []
    for i in range(n_r):
        ci = int(rng_r.choice(len(names), p=probs))
        alt = altered[names[ci]]
        st = int(rng_r.integers(0, max(1, len(alt) - rl)))
        frag = encode(alt[st: st + rl])
        read = codes_to_str(mutate_codes(rng_r, frag, ERR))
        if rng_r.random() < 0.5:
            read = revcomp(read)
        reads.append((f"sv{i}", read))
    return reads
