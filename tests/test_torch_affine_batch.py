"""vacmap_tpu_torch.ops.affine_batch (plain PyTorch version, CPU) against
the JAX package's ``ops/affine_jax.py``: the same seeded numpy inputs
through ``_affine_batch``, ``affine_batch_ref`` and the kernel's order
(``affine_batch_wavefront_ref``), the two BatchAligners,
and the two ShardedMappingSteps; then the port's AggregatingAligner.

Tolerances: best, best_i, best_j, dead and dlo exactly equal; traceback
bytes exactly equal on every cell a walk can visit (in band, or column
0), checked first, and then over the whole plane (the plain version
repeats the reference's float32 operations in order, so even masked
cells round alike); CIGARs,
endpoints and scores equal.  The mapping step's chain S within 1e-4 and
P equal, as tests/test_torch_entry.py holds them; its ``best`` equal.
One JAX run per shape, shared through module fixtures."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from vacmap_tpu.ops import affine_jax
from vacmap_tpu.ops.chain_jax import prepare_batch as jax_prepare_batch
from vacmap_tpu.parallel import mesh as jax_mesh
from vacmap_tpu_torch.device import DeviceKernelError
from vacmap_tpu_torch.ops import affine_batch as ab
from vacmap_tpu_torch.ops.affine_fill import TorchFillAligner
from vacmap_tpu_torch.ops.chain import prepare_batch
from vacmap_tpu_torch.parallel import device_service
from vacmap_tpu_torch.parallel.mesh import ShardedMappingStep, make_mesh

EXTEND_KW = dict(o1=4, e1=4, o2=4, e2=4)


def _mutate(rng, t, err):
    """An ONT-like copy of t: substitutions, insertions, deletions."""
    out = []
    for c in t:
        r = rng.random()
        if r < err * 0.4:
            out.append(rng.integers(0, 4))
        elif r < err * 0.7:
            out += [c, rng.integers(0, 4)]
        elif r >= err:
            out.append(c)
    return np.array(out, np.uint8)


def _batch(seed, B, T, W, far=False, tail=0):
    """B ragged pairs padded to T (code 4): mutated copies, every third an
    unrelated query; ``far``: every other query cut W + 0..20 bases
    shorter than its target (|q - t| >= W); ``tail``: every other pair
    with that many unrelated bases after the copy (an extension runs into
    them and drops)."""
    rng = np.random.default_rng(seed)
    tg = np.full((B, T), 4, np.uint8)
    qr = np.full((B, T), 4, np.uint8)
    tl = np.zeros(B, np.int32)
    ql = np.zeros(B, np.int32)
    for b in range(B):
        L = int(rng.integers(T // 3, T - tail + 1))
        t = rng.integers(0, 4, L).astype(np.uint8)
        q = _mutate(rng, t, 0.08)
        if b % 3 == 2:
            q = rng.integers(0, 4, int(rng.integers(T // 4, T))).astype(np.uint8)
        if far and b % 2:
            q = q[: max(1, L - W - int(rng.integers(0, 21)))]
        if tail and b % 2 == 0:
            t = np.concatenate([t, rng.integers(0, 4, tail).astype(np.uint8)])
            q = np.concatenate([q, rng.integers(0, 4, tail).astype(np.uint8)])
        t, q = t[:T], q[:T]
        tg[b, : len(t)] = t
        qr[b, : len(q)] = q
        tl[b], ql[b] = len(t), len(q)
    return tg, qr, tl, ql


CASES = {
    # name: (seed, B, T, W, glob, zdrop, scores, far, tail)
    "global_W128_T256": (1, 8, 256, 128, True, -1, {}, False, 0),
    "global_W256_T1024": (2, 6, 1024, 256, True, -1, {}, False, 0),
    "extend_W128_T512_zdrop50": (3, 8, 512, 128, False, 50, EXTEND_KW, False,
                                 150),
    "global_W32_T128_far": (4, 8, 128, 32, True, -1, {}, True, 0),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One case's inputs and the JAX function's outputs on them."""
    seed, B, T, W, glob, zdrop, kw, far, tail = CASES[request.param]
    x = _batch(seed, B, T, W, far, tail)
    want = [np.asarray(a) for a in affine_jax._affine_batch(
        *map(jnp.asarray, x), W=W, zdrop=zdrop, glob=glob, **kw)]
    return request.param, x, dict(W=W, zdrop=zdrop, glob=glob, **kw), want


def test_plain_version_matches_the_jax_function(case):
    name, x, kw, want = case
    got = [a.numpy() for a in ab.affine_batch_ref(
        *map(torch.from_numpy, x), **kw)]
    for what, g, w in zip(("tb", "best", "best_i", "best_j", "dead", "dlo"),
                          got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
    for what, g, w in zip(("best", "best_i", "best_j", "dead", "dlo"),
                          got[1:], want[1:]):
        np.testing.assert_array_equal(g, w, err_msg=what)
    tg, qr, tl, ql = x
    B, T = tg.shape
    W = kw["W"]
    if kw["glob"]:
        # the cells a walk can visit: in band, or column 0
        i = np.arange(1, T + 1)[None, :, None]
        j = np.arange(W)[None, None, :] + i + want[5][:, None, None]
        okc = (((j >= 1) & (j <= ql[:, None, None]) & (i <= tl[:, None, None]))
               | (j == 0))
        okc = np.broadcast_to(okc, want[0].shape)
        np.testing.assert_array_equal(got[0][okc], want[0][okc])
        # masked cells too: the plain version keeps the reference's
        # float32 operation order, so their bits round alike
        np.testing.assert_array_equal(got[0], want[0])
    else:
        np.testing.assert_array_equal(got[0], want[0])
        assert want[4].any() and not want[4].all(), "a pair should drop"
    if "far" in name:
        assert (np.abs(ql - tl) >= W).any()


def test_wavefront_twin_matches_the_jax_function(case):
    """csrc/affine_band.cu's order on the CPU (affine_batch_wavefront_ref)
    against the JAX function: all six outputs equal, whole planes."""
    _, x, kw, want = case
    got = [a.numpy() for a in ab.affine_batch_wavefront_ref(
        *map(torch.from_numpy, x), **kw)]
    for what, g, w in zip(("tb", "best", "best_i", "best_j", "dead", "dlo"),
                          got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        np.testing.assert_array_equal(g, w, err_msg=what)


def _pairs(seed, n, lo, hi, far=0):
    """n mutated-copy pairs of lo..hi bases; the first ``far`` with a
    length difference the band cannot hold (the host route)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(n):
        t = rng.integers(0, 4, int(rng.integers(lo, hi + 1))).astype(np.uint8)
        q = _mutate(rng, t, 0.06)
        if k < far:
            q = q[: len(q) // 3]
        pairs.append((t, q))
    return pairs


def _fields(results):
    return [dataclasses.astuple(r) for r in results]


@pytest.fixture(scope="module")
def global_pairs():
    pairs = _pairs(11, 7, 150, 480, far=1)
    jba = affine_jax.BatchAligner(glob=True)
    return pairs, {eqx: _fields(jba.align_batch(pairs, eqx=eqx))
                   for eqx in (False, True)}


@pytest.mark.parametrize("eqx", [False, True])
def test_global_batch_aligner_matches_the_jax_class(global_pairs, eqx):
    """Identical CIGARs (M runs, or =/X with eqx), counts and scores; the
    pair whose length difference the band cannot hold goes to align2p in
    both classes."""
    pairs, want = global_pairs
    got = _fields(ab.BatchAligner(glob=True, device="cpu")
                  .align_batch(pairs, eqx=eqx))
    assert got == want[eqx]
    assert any("X" in r[0] for r in got) == eqx


def test_extension_batch_aligner_matches_the_jax_class():
    rng = np.random.default_rng(12)
    pairs = []
    for k in range(6):
        common = rng.integers(0, 4, int(rng.integers(200, 1200))).astype(np.uint8)
        tail = rng.integers(0, 4, 300).astype(np.uint8)
        pairs.append((np.concatenate([common, tail]),
                      np.concatenate([_mutate(rng, common, 0.03),
                                      rng.integers(0, 4, 300 + 40 * k)
                                      .astype(np.uint8)])))
    pairs.append((pairs[0][0], pairs[0][1][:200]))  # the host route
    kw = dict(EXTEND_KW, zdrop=50, glob=False)
    want = _fields(affine_jax.BatchAligner(**kw).align_batch(pairs))
    got = _fields(ab.BatchAligner(**kw, device="cpu").align_batch(pairs))
    assert got == want
    assert any(r[1] for r in got)  # some extension dropped


def _mapping_inputs(B):
    """The dry run's chain batches (as __graft_entry__ and entry.py make
    them) and fill pairs of 128 bases, every other with |q - t| >= 32."""
    rng = np.random.default_rng(5)
    g_list, l_list = [], []
    for _ in range(B):
        r = np.arange(0, 1000, 40)
        y = r + 5000 + rng.integers(-3, 4, len(r))
        g_list.append(np.stack([r, y, np.ones(len(r), np.int64),
                                np.full(len(r), 15)], axis=1))
        r = np.arange(0, 400, 12)
        y = r + 9000 + rng.integers(-2, 3, len(r))
        l_list.append(np.stack([r, y, np.ones(len(r), np.int64),
                                np.full(len(r), 9)], axis=1))
    fills = _batch(6, B, 128, 32, far=True)
    return g_list, l_list, fills


def test_mapping_step_matches_the_jax_step_on_four_devices():
    B = 8
    g_list, l_list, fills = _mapping_inputs(B)
    want = jax_mesh.ShardedMappingStep(jax_mesh.make_mesh(4))(
        *jax_prepare_batch(g_list, "global", 40.0, 50),
        *jax_prepare_batch(l_list, "fine", 30.0, 30),
        *map(jnp.asarray, fills))
    want = [np.asarray(a) for a in want]
    got = ShardedMappingStep(make_mesh(4, "cpu"))(*prepare_batch(g_list, "global", 40.0, 50),
               *prepare_batch(l_list, "fine", 30.0, 30), *fills)
    for k in (0, 2):  # S within 1e-4 on the valid rows, P equal
        n_valid = (g_list, l_list)[k // 2]
        valid = np.zeros_like(want[k], bool)
        for b, a in enumerate(n_valid):
            valid[b, : len(a)] = True
        err = float(np.abs(got[k] - want[k])[valid].max())
        print(f"mapping step: chain {k // 2} max|dS| {err:.3g}")
        assert err <= 1e-4
        np.testing.assert_array_equal(got[k + 1], want[k + 1])
    assert got[4].dtype == np.float32 and got[4].shape == (B,)
    np.testing.assert_array_equal(got[4], want[4])
    assert got[5] == int(want[5]) > 0


def test_wrapper_takes_no_plain_route_off_cpu():
    """A tensor that is not on the CPU never reaches the plain version."""
    meta = dict(device="meta")
    with pytest.raises(DeviceKernelError):
        ab.affine_batch(torch.empty((1, 128), dtype=torch.uint8, **meta),
                        torch.empty((1, 128), dtype=torch.uint8, **meta),
                        torch.empty((1,), dtype=torch.int32, **meta),
                        torch.empty((1,), dtype=torch.int32, **meta), W=32)


def test_batch_aligner_on_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    pair = _pairs(13, 1, 100, 100)
    with pytest.raises(DeviceKernelError):
        ab.BatchAligner(device="cuda").align_batch(pair)


class _Recorder:
    """An align_batch aligner that answers each pair with its own id and
    records the size of every call; with ``fail`` it raises that instead
    on calls whose eqx is ``fail_eqx`` (None: every call)."""

    def __init__(self, fail=None, fail_eqx=None):
        self.calls = []
        self.fail = fail
        self.fail_eqx = fail_eqx
        self.lock = threading.Lock()

    def align_batch(self, pairs, eqx=False):
        with self.lock:
            self.calls.append((len(pairs), eqx))
        if self.fail is not None and self.fail_eqx in (None, eqx):
            raise self.fail
        return [(p, eqx) for p in pairs]


def _submit_together(agg, n, per, timeout=30.0):
    """n threads, each submitting ``per`` pairs of its own (odd threads
    with eqx) at once; returns {thread: result or error}."""
    out = {}
    start = threading.Barrier(n)

    def run(k):
        start.wait()
        try:
            out[k] = agg.align_batch([f"{k}:{i}" for i in range(per)],
                                     eqx=bool(k % 2))
        except Exception as err:  # noqa: BLE001 - the test reads it
            out[k] = err

    threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive()
    return out


def test_aggregating_aligner_gives_each_thread_its_own_results():
    """More threads than cores at a short switch interval: each caller
    gets exactly its own answers, the calls are merged by eqx."""
    rec = _Recorder()
    agg = device_service.AggregatingAligner(rec, max_wait_ms=50.0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = _submit_together(agg, 32, 5)
    finally:
        sys.setswitchinterval(old)
    for k, res in out.items():
        assert res == [(f"{k}:{i}", bool(k % 2)) for i in range(5)]
    assert sum(n for n, _ in rec.calls) == 32 * 5
    assert len(rec.calls) < 32  # merged


def test_aggregating_aligner_sends_a_device_error_to_every_waiter():
    """Eight callers in one dispatch window, in two eqx groups: a
    DeviceKernelError in the first group's call reaches all eight and no
    further call is made; another error reaches its own group only."""
    rec = _Recorder(fail=DeviceKernelError("card gone"))
    out = _submit_together(
        device_service.AggregatingAligner(rec, max_wait_ms=300.0), 8, 3)
    assert all(isinstance(v, DeviceKernelError) for v in out.values())
    assert len(rec.calls) == 1
    rec = _Recorder(fail=ValueError("bad pair"), fail_eqx=True)
    out = _submit_together(
        device_service.AggregatingAligner(rec, max_wait_ms=300.0), 8, 3)
    for k, res in out.items():
        if k % 2:
            assert isinstance(res, ValueError)
        else:
            assert res == [(f"{k}:{i}", False) for i in range(3)]
    assert len(rec.calls) == 2


def test_aggregating_aligner_wakes_every_waiter_when_interrupted():
    """A BaseException in the dispatcher (KeyboardInterrupt) still wakes
    the other callers, each with a DeviceKernelError."""
    rec = _Recorder(fail=KeyboardInterrupt())
    agg = device_service.AggregatingAligner(rec, max_wait_ms=300.0)
    out = {}
    start = threading.Barrier(4)

    def run(k):
        start.wait()
        try:
            out[k] = agg.align_batch([k])
        except BaseException as err:  # noqa: BLE001 - the test reads it
            out[k] = err

    threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
        assert not t.is_alive()
    kinds = sorted(type(v).__name__ for v in out.values())
    assert kinds == ["DeviceKernelError"] * 3 + ["KeyboardInterrupt"]


def test_aggregating_aligner_over_the_batch_aligner():
    """The aggregator over the port's BatchAligner gives what the aligner
    gives alone; an empty request answers at once."""
    pairs = _pairs(14, 4, 120, 240)
    ba = ab.BatchAligner(glob=True, device="cpu")
    agg = device_service.AggregatingAligner(ba, max_wait_ms=1.0)
    assert agg([]) == []
    assert _fields(agg(pairs, eqx=True)) == _fields(
        ba.align_batch(pairs, eqx=True))


def test_device_fill_aligner():
    """On the CPU (asked for) it wraps the plain fills and gives the fill
    aligner's CIGARs; a card asked for and missing raises."""
    pairs = _pairs(15, 3, 60, 200)
    agg = device_service.device_fill_aligner("cpu", max_wait_ms=1.0)
    assert isinstance(agg, device_service.AggregatingAligner)
    want = TorchFillAligner(device="cpu").align_batch(pairs, eqx=True)
    assert [r.cigar for r in agg(pairs, eqx=True)] == [r.cigar for r in want]
    if not torch.cuda.is_available():
        with pytest.raises(DeviceKernelError):
            device_service.device_fill_aligner("cuda")
