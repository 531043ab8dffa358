"""vacmap_tpu_torch/ops/myers.py on the CPU: the plain PyTorch version of
the Myers edit-distance kernel and TorchMyersAligner(device="cpu"), held
to the Pallas kernel of examples/myers_pallas_device.py in interpret mode
on the same numpy pairs, and to the native Myers on pairs without an
ambiguous base.  Distances are integers: tolerance 0."""

import os
import sys

import numpy as np
import pytest
import torch

from vacmap_tpu.native import edit_distance_native
from vacmap_tpu_torch.ops import myers
from vacmap_tpu_torch.ops.myers import (
    TorchMyersAligner, myers_distances, myers_distances_ref, pack_jobs,
    pack_peq,
)

BUCKETS = ((256, 8), (512, 24))


@pytest.fixture(scope="module")
def pallas_aligner():
    examples = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples")
    sys.path.insert(0, examples)
    try:
        from myers_pallas_device import PallasMyersAligner
    finally:
        sys.path.remove(examples)
    return PallasMyersAligner(buckets=BUCKETS, shape_b={256: 8, 512: 8},
                              tb=8, interpret=True)


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


def _cases(seed=11):
    rng = np.random.default_rng(seed)
    one = lambda: rng.integers(0, 4, 1).astype(np.uint8)  # noqa: E731
    t64, q64 = _mutated(rng, 70, 0.05)
    pairs = {
        "err5": _mutated(rng, 200, 0.05),
        "err40": _mutated(rng, 180, 0.40),
        "err5_mid": _mutated(rng, 480, 0.05),
        "err40_mid": _mutated(rng, 400, 0.40),
        "m1": (rng.integers(0, 4, 40).astype(np.uint8), one()),
        "n1": (one(), rng.integers(0, 4, 50).astype(np.uint8)),
        "m64": (t64, np.resize(q64, 64)),
        "m128": (rng.integers(0, 4, 150).astype(np.uint8),
                 rng.integers(0, 4, 128).astype(np.uint8)),
        "m256_full": _mutated(rng, 250, 0.1)[:1]
        + (rng.integers(0, 4, 256).astype(np.uint8),),
        "longer_pattern": (rng.integers(0, 4, 100).astype(np.uint8),
                           rng.integers(0, 4, 140).astype(np.uint8)),
    }
    return pairs


def _with_n(seed=12):
    rng = np.random.default_rng(seed)
    t, q = _mutated(rng, 220, 0.05)
    tn = t.copy()
    tn[[3, 50, 51]] = 4
    qn = q.copy()
    qn[[0, 77]] = 4
    both_t, both_q = t.copy(), t.copy()
    both_t[10] = both_q[10] = 4  # N against N: no match in this kernel
    return {"n_in_text": (tn, q), "n_in_pattern": (t, qn),
            "n_both": (both_t, both_q)}


def test_ref_equals_native_without_n():
    ta = TorchMyersAligner("cpu", buckets=BUCKETS)
    pairs = list(_cases().values())
    got = ta.distance_batch(pairs)
    want = [edit_distance_native(t, q) for t, q in pairs]
    assert got == want


@pytest.mark.parametrize("name", list(_cases()) + list(_with_n()))
def test_ref_equals_pallas_interpret(pallas_aligner, name):
    pair = {**_cases(), **_with_n()}[name]
    want = pallas_aligner.distance_batch([pair])
    got = TorchMyersAligner("cpu", buckets=BUCKETS).distance_batch([pair])
    assert got == want and got[0] >= 0
    if name == "n_both":  # the native Myers would say 0
        assert got == [1]


def test_batch_equals_pallas_interpret(pallas_aligner):
    """One batch over both buckets, mixed lengths, with N pairs."""
    pairs = list(_cases(21).values()) + list(_with_n(22).values())
    assert (TorchMyersAligner("cpu", buckets=BUCKETS).distance_batch(pairs)
            == pallas_aligner.distance_batch(pairs))


def test_oversized_and_empty_sides(pallas_aligner):
    rng = np.random.default_rng(3)
    big = rng.integers(0, 4, 600).astype(np.uint8)
    small = rng.integers(0, 4, 30).astype(np.uint8)
    long_q = rng.integers(0, 4, 24 * 32 + 1).astype(np.uint8)
    empty = np.zeros(0, np.uint8)
    pairs = [(big, small), (small, long_q), (empty, small), (small, empty),
             (empty, empty), (small, small)]
    ta = TorchMyersAligner("cpu", buckets=BUCKETS)
    got = ta.distance_batch(pairs)
    assert got == [-1, -1, 30, 30, 0, 0]
    assert got == pallas_aligner.distance_batch(pairs)
    assert ta._bucket(256, 256) == (256, 8) and ta._bucket(257, 10) == (512, 24)
    assert ta._bucket(513, 10) is None


def test_dispatch_fetch_and_chunking():
    """dispatch_jobs / fetch, the service's calls, and distance_batch's
    chunks of shape_b pairs."""
    rng = np.random.default_rng(4)
    pairs = [_mutated(rng, int(rng.integers(5, 250)), 0.1) for _ in range(11)]
    ta = TorchMyersAligner("cpu", buckets=BUCKETS, shape_b={256: 4, 512: 2})
    want = [edit_distance_native(t, q) for t, q in pairs]
    d = ta.fetch(ta.dispatch_jobs(pairs[:4], 256, 8))
    assert d.dtype == np.int64 and d.tolist() == want[:4]
    with pytest.raises(ValueError):
        ta.dispatch_jobs(pairs[:5], 256, 8)
    assert ta.distance_batch(pairs) == want
    ta.prewarm()
    assert myers_distances.launches == 0  # the CPU runs the plain version


def test_pack_peq_layout():
    q = np.array([0, 1, 2, 3, 4, 0] + [3] * 60, np.uint8)  # 66 bases
    peq = pack_peq([q], 2)
    assert peq.shape == (1, 4, 2) and peq.dtype == np.int64
    u = peq.view(np.uint64)
    assert int(u[0, 0, 0]) == 0b100001 and int(u[0, 0, 1]) == 0
    assert int(u[0, 1, 0]) == 0b10 and int(u[0, 2, 0]) == 0b100
    assert int(u[0, 3, 0]) == (2**64 - 1) & ~0b110111 and int(u[0, 3, 1]) == 0b11
    text, peq2, n, m = pack_jobs([(q[:5], q)], 256, 8)
    assert text.shape == (1, 256) and (text[0, 5:] == 4).all()
    assert peq2.shape == (1, 4, 4) and n.tolist() == [5] and m.tolist() == [66]


def test_wrapper_takes_plain_version_only_on_cpu_tensors():
    text, peq, n, m = (torch.from_numpy(a) for a in pack_jobs(
        [(np.array([0, 1, 2], np.uint8), np.array([0, 2], np.uint8))], 32, 2))
    assert myers_distances(text, peq, n, m).tolist() == [1]
    assert torch.equal(myers_distances(text, peq, n, m),
                       myers_distances_ref(text, peq, n, m))
    assert myers.MAX_WORDS == 448 and myers.DEFAULT_BUCKETS[-1] == (20480, 896)
    with pytest.raises(myers.DeviceKernelError):
        myers_distances(text.to("meta"), peq.to("meta"), n.to("meta"),
                        m.to("meta"))
