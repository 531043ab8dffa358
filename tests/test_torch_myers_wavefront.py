"""The CPU twin of csrc/myers.cu's decomposition,
``myers_distances_wavefront_ref`` (step s computes column s - w of every
pattern word w, with the carry and shift bits word w - 1 gave the step
before, on the pair's own ceil(m / 64) words), held bit for bit to the
plain version ``myers_distances_ref`` and, through it, to the Pallas
kernel of examples/myers_pallas_device.py in interpret mode and to the
native Myers on pairs without an ambiguous base.  Distances are integers:
tolerance 0.  Each reference runs once over all cases (module
fixtures)."""

import os
import sys

import numpy as np
import pytest
import torch

from vacmap_tpu.native import edit_distance_native
from vacmap_tpu_torch.ops.myers import (
    myers_distances_ref, myers_distances_wavefront_ref, pack_jobs,
)

# (text columns T, pattern words Wd of 32 bits): up to 40 64-bit words
BUCKETS = ((256, 8), (2560, 80))


def _mutated(rng, n, err):
    """A random text of n bases and a copy with substitutions, insertions
    and deletions at rate ``err``."""
    t = rng.integers(0, 4, n).astype(np.uint8)
    q = []
    for b in t:
        r = rng.random()
        if r < err / 3:
            continue  # deletion
        if r < 2 * err / 3:
            q.append((int(b) + int(rng.integers(1, 4))) % 4)
        else:
            q.append(int(b))
        if rng.random() < err / 3:
            q.append(int(rng.integers(0, 4)))
    return t, np.array(q or [0], np.uint8)


def _sized(rng, n, m, err=0.1):
    """A text of n bases and a pattern of exactly m bases drawn from it."""
    t, q = _mutated(rng, n, err)
    return t, np.resize(q, m)


def _cases():
    rng = np.random.default_rng(91)
    cases = {f"m{m}": _sized(rng, 150, m) for m in (1, 63, 64, 65, 127, 128,
                                                     129)}
    t, q = _mutated(rng, 700, 0.05)
    tn, qn = t.copy(), q.copy()
    tn[[0, 333, 699]] = 4
    qn[[1, 64, 128]] = 4
    both_t, both_q = t.copy(), t.copy()
    both_t[[10, 400]] = both_q[[10, 400]] = 4  # N against N: no match here
    cases.update({
        "n1": (rng.integers(0, 4, 1).astype(np.uint8),
               rng.integers(0, 4, 70).astype(np.uint8)),
        "n1_m1": (np.array([2], np.uint8), np.array([2], np.uint8)),
        "n_below_m": _sized(rng, 300, 520),
        "n_above_m": _sized(rng, 900, 300),
        "err5": _mutated(rng, 2400, 0.05),
        "err40": _mutated(rng, 1700, 0.40),
        "n_in_text": (tn, q),
        "n_in_pattern": (t, qn),
        "n_both": (both_t, both_q),
    })
    return cases


CASES = _cases()
NAMES = list(CASES)


@pytest.fixture(scope="module")
def pallas():
    """The Pallas kernel's distance of every case, from one interpret-mode
    run a bucket."""
    examples = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples")
    sys.path.insert(0, examples)
    try:
        from myers_pallas_device import PallasMyersAligner
    finally:
        sys.path.remove(examples)
    pa = PallasMyersAligner(buckets=BUCKETS, shape_b={256: 8, 2560: 8}, tb=8,
                            interpret=True)
    return dict(zip(NAMES, pa.distance_batch([CASES[k] for k in NAMES])))


@pytest.fixture(scope="module")
def batch():
    """Every case in one batch at the larger bucket (pairs of different n
    and m, so their top words differ): the twin's and the plain version's
    distances, and the inputs."""
    T, Wd = BUCKETS[-1]
    x = [torch.from_numpy(a) for a in pack_jobs([CASES[k] for k in NAMES], T,
                                                Wd)]
    twin = myers_distances_wavefront_ref(*x).tolist()
    plain = myers_distances_ref(*x).tolist()
    return dict(zip(NAMES, twin)), dict(zip(NAMES, plain)), x


@pytest.mark.parametrize("name", NAMES)
def test_twin_equals_plain_pallas_and_native(batch, pallas, name):
    twin, plain, _ = batch
    assert twin[name] == plain[name] == pallas[name]
    t, q = CASES[name]
    if (t == 4).any() or (q == 4).any():
        if name == "n_both":  # the native Myers would match N to N
            assert twin[name] > edit_distance_native(t, q)
    else:
        assert twin[name] == edit_distance_native(t, q)


@pytest.mark.parametrize("name", ["m1", "m64", "m65", "m129", "n1",
                                  "n_below_m", "n_in_text"])
def test_twin_alone_at_the_small_bucket(name):
    """A pair alone, at the width its bucket gives (Wd = 8: four words)."""
    t, q = CASES[name]
    if len(t) > 256 or len(q) > 256:
        t, q = t[:256], q[:256]
    x = [torch.from_numpy(a) for a in pack_jobs([(t, q)], *BUCKETS[0])]
    assert torch.equal(myers_distances_wavefront_ref(*x),
                       myers_distances_ref(*x))


def test_twin_reads_only_the_pairs_own_words(batch):
    """Words above a pair's top word (ceil(m / 64) - 1) never enter the
    twin: Peq bits there change nothing."""
    twin, _, (text, peq, n, m) = batch
    noisy = peq.clone()
    words = torch.arange(peq.shape[2])
    above = words.unsqueeze(0) >= ((m.long() + 63) >> 6).unsqueeze(1)
    noise = torch.from_numpy(np.random.default_rng(5).integers(
        -2**62, 2**62, noisy.shape, dtype=np.int64))
    noisy = torch.where(above.unsqueeze(1), noise, noisy)
    assert not torch.equal(noisy, peq)
    assert (myers_distances_wavefront_ref(text, noisy, n, m).tolist()
            == [twin[k] for k in NAMES])


def test_twin_of_an_empty_batch_and_a_text_of_no_columns():
    t, q = CASES["m65"]
    text, peq, n, m = (torch.from_numpy(a) for a in pack_jobs([(t, q)], 256, 8))
    zero = torch.zeros_like(n)
    assert myers_distances_wavefront_ref(text, peq, zero, m).tolist() == [65]
    assert myers_distances_wavefront_ref(text[:0], peq[:0], n[:0],
                                         m[:0]).shape == (0,)
