"""The frozen generators repeat exactly for a seed, equal chip_smoke's,
and the traffic files' parameters show up in the generated reads."""

import json

import numpy as np
import pytest

import chip_smoke as cs
from conftest import BENCH
from yardstick import genome as G
from yardstick import traffic as T


def test_genome_and_errors_equal_chip_smoke():
    a = G.make_genome_codes(np.random.default_rng(7), 2_000_000, 200, 1)
    b = cs.make_genome_codes(np.random.default_rng(7), 2_000_000)
    assert np.array_equal(a, b)
    frag = a[:50_000]
    for err in (0.05, 0.01):
        x = G.mutate_codes(np.random.default_rng(3), frag, err)
        y = cs.mutate_codes(np.random.default_rng(3), frag, err)
        assert np.array_equal(x, y)


@pytest.fixture(scope="module")
def genome():
    return G.make_genome_codes(np.random.default_rng(11), 30_000_000, 60, 1)


@pytest.mark.parametrize("mix_name", ["wgs_ont", "wgs_hifi"])
def test_pool_repeats_for_a_seed(genome, mix_name):
    mix = json.loads((BENCH / "traffic" / f"{mix_name}.json").read_text())
    w1, p1 = T.generate(genome, mix, 2**31 + 3, 0.5, workers=2)
    w2, p2 = T.generate(genome, mix, 2**31 + 3, 0.5, workers=1)
    assert p1.reads == p2.reads and w1.reads == w2.reads
    _, p3 = T.generate(genome, mix, 2**31 + 4, 0.5)
    assert p3.reads != p1.reads
    # every block holds the same lengths and error rates
    b = mix["block_reads"]
    assert len(p1.reads) % b == 0
    assert np.array_equal(np.sort(p1.frag_len[:b]), np.sort(p3.frag_len[-b:]))
    assert np.array_equal(np.sort(p1.err[:b]), np.sort(p3.err[-b:]))


def _n50(lengths):
    s = np.sort(lengths)[::-1]
    return s[np.searchsorted(np.cumsum(s), s.sum() / 2)]


def test_ont_mix_parameters_show(genome):
    mix = json.loads((BENCH / "traffic" / "wgs_ont.json").read_text())
    _, p = T.generate(genome, mix, 5, 1.0, workers=2)
    L = p.frag_len
    assert abs(np.median(L) / 15_000 - 1) < 0.03
    assert abs(_n50(L) / 25_000 - 1) < 0.1
    assert L.min() >= 1_000 and L.max() <= 100_000
    assert abs(p.err.mean() - 0.07) < 1e-9
    assert 0.04 <= p.err.min() and p.err.max() <= 0.10
    assert 0.4 < p.reverse.mean() < 0.6
    # one SV per 125 kb: a read of mean length ~19.4 kb covers one about
    # one time in six or five
    assert 0.1 < p.spans_sv.mean() < 0.3
    # read lengths follow the fragments (insertions and deletions balance)
    rl = np.array([len(s) for _, s in p.reads])
    assert abs(rl.sum() / L.sum() - 1) < 0.01


def test_hifi_mix_parameters_show(genome):
    mix = json.loads((BENCH / "traffic" / "wgs_hifi.json").read_text())
    _, p = T.generate(genome, mix, 6, 1.0)
    L = p.frag_len
    assert abs(L.mean() / 16_000 - 1) < 0.02
    assert abs(L.std() / 3_000 - 1) < 0.1
    assert L.min() >= 5_000 and L.max() <= 30_000
    assert 0.001 <= p.err.min() and p.err.max() <= 0.01


def test_error_rate_shows_in_the_reads(genome):
    """Substitutions alone: a read differs from its fragment at 3/4 of the
    error rate (a substituted base is drawn from all four)."""
    mix = json.loads((BENCH / "traffic" / "wgs_ont.json").read_text())
    mix["error_mix"] = {"sub": 1.0, "ins": 0.0, "del": 0.0}
    mix["reverse_share"] = 0.0
    rng = np.random.default_rng(9)
    events = T.sv_events(rng, len(genome), mix["svs"])
    hap, spans, _ = T.haplotype(rng, genome, events)
    p = T.make_reads(np.random.default_rng(1).bit_generator.seed_seq, hap,
                     spans, mix, 2, "r")
    diff = total = 0
    want = 0.0
    for (_, s), st, ln, e in zip(p.reads, p.hap_start, p.frag_len, p.err):
        read = np.frombuffer(s.encode(), np.uint8)
        frag = G.BASES[hap[st : st + ln]]
        diff += int((read != frag).sum())
        total += ln
        want += 0.75 * e * ln
    assert abs(diff / want - 1) < 0.02


def test_sv_events_follow_the_mix(genome):
    mix = json.loads((BENCH / "traffic" / "wgs_ont.json").read_text())
    ev = T.sv_events(np.random.default_rng(2), len(genome), mix["svs"])
    n = len(genome) // mix["svs"]["spacing"]
    kinds = [e[0] for e in ev]
    for k, (share, lo, hi) in mix["svs"]["kinds"].items():
        assert abs(kinds.count(k) - share * n) <= 1
        lens = [e[2] for e in ev if e[0] == k]
        assert all(lo <= x <= hi for x in lens)
    pos = [e[1] for e in ev]
    assert pos == sorted(pos)
    assert all(a[1] + a[2] < b[1] for a, b in zip(ev, ev[1:]))


@pytest.mark.parametrize("mix_name", ["wgs_ont", "wgs_hifi"])
def test_truth_points_name_each_read_base_origin(genome, mix_name):
    """Every truth point's read base is its origin's genome base (its
    complement on the reverse strand) but for substitutions: they differ
    at 3/4 of the substitution rate, on both strands and across SVs."""
    mix = json.loads((BENCH / "traffic" / f"{mix_name}.json").read_text())
    mix["svs"]["spacing"] = 20_000
    for k in mix["svs"]["kinds"].values():
        k[2] = min(k[2], 5_000)
    _, p = T.generate(genome, mix, 2**31 + 9, 2.0, workers=2)
    codes = G.BASES[genome].tobytes().decode()
    comp = str.maketrans("ACGT", "TGCA")
    differ = points = 0
    want = 0.0
    strands = set()
    for i, (_, seq) in enumerate(p.reads):
        r, g, s = p.truth(i)
        strands.update(s.tolist())
        for rr, gg, ss in zip(r.tolist(), g.tolist(), s.tolist()):
            base = codes[gg] if ss > 0 else codes[gg].translate(comp)
            differ += seq[rr] != base
        points += len(r)
        want += 0.75 * mix["error_mix"]["sub"] * p.err[i] * len(r)
    assert strands == {-1, 1} and p.spans_sv.any()
    assert points > 0.9 * p.bases / T.TRUTH_STEP
    assert abs(differ / want - 1) < 0.15
