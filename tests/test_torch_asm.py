"""vacmap_tpu_torch's asm path on the CPU against the JAX package: the
warm-start chain DP's plain version against the XLA scan
``chain_scores_batch_warm``, the stream backend against the native
streaming chain and ``JaxStreamChainBackend``, ``Mapper.map_contig`` and
the ``-mode asm`` CLI against ``vacmap_tpu``'s.  The same numpy inputs,
made from a seed, go through both packages.

Stated tolerance of the chain scores: S max abs error <= 1e-3 and P
agreement >= 0.999 on the scored rows (f32 transcendentals may round
differently in XLA and in PyTorch); frozen rows and rows past n_valid are
exact.  The agreement rate of every case is printed."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vacmap_tpu.config import AlignerConfig
from vacmap_tpu.index import ReferenceIndex
from vacmap_tpu.ops.chain_jax import (
    JaxStreamChainBackend,
    chain_scores_batch_warm as jax_chain_scores_batch_warm,
)
from vacmap_tpu.pipeline.asm import STREAM_THRESHOLD
from vacmap_tpu.pipeline.asm import stream_chain as jax_pkg_stream_chain
from vacmap_tpu.pipeline.mapper import Mapper
from vacmap_tpu_torch import DeviceKernelError
from vacmap_tpu_torch.config import AlignerConfig as PortConfig
from vacmap_tpu_torch.index import ReferenceIndex as PortIndex
from vacmap_tpu_torch.ops.chain import (
    MAX_ANCHORS, MAX_N, TorchChainBackend, TorchStreamChainBackend,
    chain_scores_batch_ref, chain_scores_batch_warm,
    chain_scores_batch_warm_ref, prepare_batch, to_device,
)
from vacmap_tpu_torch.pipeline.asm import stream_chain
from vacmap_tpu_torch.pipeline.mapper import Mapper as PortMapper
from tests.conftest import random_dna
from tests.test_chain import chainy_anchors, random_anchors

REPO = Path(__file__).resolve().parent.parent
VARIANTS = ["global", "global_nocov", "refund", "fine", "mismatch"]
KW = dict(kmersize=15, maxdiff=50, maxgap=1000, skipcost=40.0)
N = 512


def _sorted(a, variant):
    key = a[:, 0] + (a[:, 3] if variant in ("fine", "mismatch") else 0)
    return a[np.argsort(key, kind="stable")]


def _warm_case(rng, variant, kind, n_warm):
    """Two problems of N = 512 rows: a frontier of n_warm (and n_warm - 5)
    anchors in no order, with scores rebased around 1000 and predecessor
    codes <= -2, then a block sorted by the variant's barrier."""
    alist, w_S, w_P, nws = [], np.zeros((2, N), np.float32), \
        np.zeros((2, N), np.int32), []
    for b in range(2):
        nw = max(n_warm - 5 * b, 0)
        if kind == "random":
            a = random_anchors(rng, 300)
        else:
            a = chainy_anchors(rng, read_len=6000, noise=15)[:300]
        a = _sorted(a, variant)
        a[:, 0] += 500
        # the frontier: anchors of an "earlier block" (smaller read
        # positions), ordered by score, not by position
        f = a[rng.permutation(len(a))[:nw]].copy()
        f[:, 0] -= int(rng.integers(50, 400))
        alist.append(np.concatenate([f, a]) if nw else a)
        w_S[b, :nw] = np.sort(1000.0 - rng.random(nw) * 96.0)
        w_P[b, :nw] = -rng.integers(0, 20000, nw) - 2
        nws.append(nw)
    arrays = prepare_batch(alist, variant, KW["skipcost"], KW["maxdiff"])
    pad = N - arrays[0].shape[1]  # one width, so one XLA compile a variant
    assert pad >= 0
    arrays = (np.pad(arrays[0], ((0, 0), (0, pad), (0, 0))), arrays[1],
              np.pad(arrays[2], ((0, 0), (0, pad))),
              np.pad(arrays[3], ((0, 0), (0, pad))))
    # rows past n_valid hold what the caller left there
    for b in range(2):
        w_S[b, arrays[1][b] :] = 7.5
        w_P[b, arrays[1][b] :] = -3
    return arrays, w_S, w_P, np.array(nws, np.int32)


@pytest.mark.parametrize("kind", ["random", "chainy"])
@pytest.mark.parametrize("n_warm", [0, 17, 200])
@pytest.mark.parametrize("variant", VARIANTS)
def test_warm_ref_matches_jax(variant, n_warm, kind):
    rng = np.random.default_rng(
        300 + 10 * VARIANTS.index(variant) + n_warm + (kind == "chainy"))
    arrays, w_S, w_P, nw = _warm_case(rng, variant, kind, n_warm)
    kw = {**KW, "variant": variant}
    S_j, P_j = jax_chain_scores_batch_warm(*arrays, w_S, w_P, nw, **kw)
    S_j, P_j = np.asarray(S_j), np.asarray(P_j)
    S_t, P_t = chain_scores_batch_warm(
        *to_device("cpu", *arrays, w_S, w_P, nw), **kw)
    S_t, P_t = S_t.numpy(), P_t.numpy()
    idx = np.arange(N)[None, :]
    frozen = idx < nw[:, None]
    past = idx >= arrays[1][:, None]
    scored = ~frozen & ~past
    np.testing.assert_allclose(S_t[scored], S_j[scored], atol=1e-3, rtol=1e-6)
    agree = float(np.mean(P_t[scored] == P_j[scored]))
    print(f"warm chain {variant}/{kind}/n_warm={n_warm}: P agreement "
          f"{agree:.6f}, S max abs err "
          f"{float(np.abs(S_t[scored] - S_j[scored]).max()):.3g}")
    assert agree >= 0.999
    # frozen rows: S and the negative P codes pass through, bit for bit
    assert np.array_equal(S_t[frozen], w_S[frozen])
    assert np.array_equal(P_t[frozen], w_P[frozen])
    assert np.array_equal(S_j[frozen], w_S[frozen])
    # rows past n_valid keep warm_S and get P = -1 (frozen ones excepted)
    assert np.array_equal(S_t[past & ~frozen], w_S[past & ~frozen])
    assert (P_t[past & ~frozen] == -1).all()
    assert np.array_equal(P_t[past], P_j[past])
    if n_warm:
        # the frontier was used: some scored row links into it
        assert ((P_t >= 0) & (P_t < nw[:, None]) & scored).any()


def test_warm_refund_is_scored_without_the_ledger():
    """The reference's warm scan scores "refund" with no penalty ledger,
    so cold (n_warm = 0) it differs from ``chain_scores_batch`` on a
    chain whose refund fires; the port reproduces exactly that."""
    rng = np.random.default_rng(77)
    a = _sorted(chainy_anchors(rng, read_len=6000, noise=25), "refund")
    arrays = prepare_batch([a], "refund", 40.0, 50)
    n = arrays[0].shape[1]
    zS, zP = np.zeros((1, n), np.float32), np.zeros((1, n), np.int32)
    nw = np.zeros(1, np.int32)
    kw = {**KW, "variant": "refund"}
    S_w, P_w = chain_scores_batch_warm_ref(
        *to_device("cpu", *arrays, zS, zP, nw), **kw)
    S_j, P_j = jax_chain_scores_batch_warm(*arrays, zS, zP, nw, **kw)
    np.testing.assert_allclose(S_w.numpy(), np.asarray(S_j), atol=1e-3)
    assert np.array_equal(P_w.numpy(), np.asarray(P_j))
    # and without frozen rows the other variants are the cold DP itself
    kw = {**KW, "variant": "global_nocov"}
    S_w, P_w = chain_scores_batch_warm_ref(
        *to_device("cpu", *arrays, zS, zP, nw), **kw)
    S_c, P_c = chain_scores_batch_ref(*to_device("cpu", *arrays), **kw)
    assert torch.equal(S_w, S_c) and torch.equal(P_w, P_c)


def _sv_batches(rng):
    """tests/test_asm.py's stream case: a chain with an SV jump, in three
    blocks."""
    r = np.arange(0, 6000, 23)
    y = r + 54321 + rng.integers(-3, 4, len(r))
    y[len(y) // 2 :] += 40_000
    a = np.stack([r, y, np.ones_like(r), np.full_like(r, 15)], 1).astype(np.int64)
    return [a[: len(a) // 3], a[len(a) // 3 : 2 * len(a) // 3],
            a[2 * len(a) // 3 :]]


def test_stream_chain_torch_backend_matches_native_and_jax():
    batches = _sv_batches(np.random.default_rng(5))
    args = (15, 40.0, 50, 1000, "global_nocov", None)
    p_native = stream_chain(iter(batches), *args)
    be = TorchStreamChainBackend("cpu")
    p_torch = stream_chain(iter(batches), *args, chain_backend=be)
    p_jax = jax_pkg_stream_chain(iter(batches), *args,
                                 chain_backend=JaxStreamChainBackend())
    assert p_torch == p_native == p_jax
    assert len(p_torch) > 50
    assert be.calls == be.engaged == 3 and be.device_s > 0
    # the first block has no frontier, so it is the anchors as given
    assert be.rows >= sum(len(b) for b in batches)
    assert len(batches[0]) <= be.max_rows <= be.rows
    assert be.declined == {"variant": 0, "size": 0, "coords": 0}


def test_stream_backends_give_the_same_S_and_P():
    """The state carried across blocks, (linked, warm_S, warm_P) as numpy
    arrays, gives the same (S, P) through both packages' backends."""
    rng = np.random.default_rng(6)
    b0, b1, _ = _sv_batches(rng)
    keep = rng.permutation(len(b0))[:40]
    linked = np.concatenate([b0[keep], b1])
    warm_S = np.sort(1000.0 - rng.random(40) * 90.0)
    warm_P = -(keep.astype(np.int64)) - 2
    args = (linked, "global_nocov", 15, 40.0, 50, 1000, warm_S, warm_P)
    S_t, P_t = TorchStreamChainBackend("cpu")(*args)
    S_j, P_j = JaxStreamChainBackend()(*args)
    assert S_t.dtype == S_j.dtype == np.float64 and len(S_t) == len(linked)
    np.testing.assert_allclose(S_t, S_j, atol=1e-3)
    assert np.array_equal(P_t, P_j)
    assert np.array_equal(P_t[:40], warm_P)


@pytest.mark.parametrize("cause", ["variant", "size", "coords"])
def test_stream_backend_declines(cause):
    """What the device does not chain goes to the native DP, counted by
    cause, as the reference's backend answers None."""
    b0 = _sv_batches(np.random.default_rng(7))[0]
    be = TorchStreamChainBackend("cpu", max_anchors=len(b0))
    jbe = JaxStreamChainBackend(max_anchors=len(b0))
    none = (np.zeros(0, np.float64), np.zeros(0, np.int64))
    variant, a = "global_nocov", b0
    if cause == "variant":
        variant = "asm_fine"
    elif cause == "size":
        a = np.concatenate([b0, b0[-1:] + [30, 30, 0, 0]])
    else:
        a = b0.copy()
        a[:, 1] += 2**31
    args = (a, variant, 15, 40.0, 50, 1000, *none)
    assert be(*args) is None and jbe(*args) is None
    assert be.declined[cause] == 1 and sum(be.declined.values()) == 1
    assert be.calls == 1 and be.engaged == 0
    # the streaming chain then takes the native DP for that block
    if cause == "variant":
        p = stream_chain(iter([b0]), 9, 30.0, 30, 1000, "asm_fine", None,
                         chain_backend=be)
        assert p == stream_chain(iter([b0]), 9, 30.0, 30, 1000, "asm_fine",
                                 None)


def test_per_call_backend_takes_contigs_up_to_the_reference_limit(
        monkeypatch):
    """Above chain_dp.cu's 8192 anchors the per-call backend goes on to
    the device call (the tiled kernel on a card) instead of declining, up
    to the reference's 65,536 anchors."""
    import vacmap_tpu_torch.ops.chain as chain_mod

    calls = []

    def spy(device, anchor_list, variant, *rest, **kw):
        calls.append((len(anchor_list[0]), variant))
        return ["chained"]

    monkeypatch.setattr(chain_mod, "chain_results", spy)
    be = TorchChainBackend("cpu")
    for n in (MAX_N + 40, MAX_ANCHORS, MAX_ANCHORS + 1):
        a = np.zeros((n, 4), np.int64)
        got = be(a, "global_nocov", 15, 40.0, 50, 1000)
        assert got == ("chained" if n <= MAX_ANCHORS else None)
    assert calls == [(MAX_N + 40, "global_nocov"), (MAX_ANCHORS, "global_nocov")]


# ---------------------------------------------------------------------------
# Mapper.map_contig and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def asm_world():
    """tests/test_asm.py's production case: an 800 kb genome indexed at
    w = 64 (sparse, so the CPU chain DPs stay small), a 600 kb contig
    with a 2 kb deletion (streaming path), and a 60 kb contig with an
    inversion (the per-read path of contigs under 500 kb)."""
    from vacmap_tpu.seq import revcomp

    rng = np.random.default_rng(2024)
    genome = {"g3": random_dna(rng, 800_000)}
    src = genome["g3"][50_000:650_000]
    big = src[:300_000] + src[302_000:]
    assert len(big) >= STREAM_THRESHOLD
    small = genome["g3"][700_000:760_000]
    small = small[:20_000] + revcomp(small[20_000:30_000]) + small[30_000:]
    return genome, [("dctg", big), ("sctg", small)]


def test_map_contig_matches_jax_backend_and_host(asm_world):
    genome, contigs = asm_world
    idx = ReferenceIndex.build(genome, k=15, w=64)
    pidx = PortIndex.build(genome, k=15, w=64)
    host = Mapper(idx, AlignerConfig(mode="asm"))
    jax_dev = Mapper(idx, AlignerConfig(mode="asm", backend="jax"))
    port_host = PortMapper(pidx, PortConfig(mode="asm"))
    port_dev = PortMapper(pidx, PortConfig(mode="asm", backend="jax"),
                          device="cpu")
    assert port_host.stream_backend is None and port_host.chain_backend is None
    assert isinstance(port_dev.stream_backend, TorchStreamChainBackend)
    assert isinstance(port_dev.chain_backend, TorchChainBackend)
    for name, seq in contigs:
        want = host.map_contig(name, seq)
        assert want, name
        assert jax_dev.map_contig(name, seq) == want, name
        assert port_host.map_contig(name, seq) == want, name
        assert port_dev.map_contig(name, seq) == want, name
    be, jbe = port_dev.stream_backend, jax_dev.stream_backend
    # every round-1 block was chained by the device path; the asm_fine
    # blocks of round 2 were declined by contract
    assert be.engaged > 0 and be.engaged == jbe.engaged
    assert be.calls == jbe.calls == be.engaged + be.declined["variant"]
    assert be.declined["size"] == be.declined["coords"] == 0


def test_map_contig_raises_device_errors(asm_world):
    """A device fault inside the stream backend, or inside the per-call
    backend of a small contig, ends map_contig with DeviceKernelError; a
    host error is logged and drops the contig, as in the reference."""
    genome, contigs = asm_world
    pidx = PortIndex.build(genome, k=15, w=64)
    m = PortMapper(pidx, PortConfig(mode="asm", backend="jax"), device="cpu")

    def broken(*a, **k):
        raise DeviceKernelError("chain_dp_warm kernel launch failed")

    m.stream_backend = broken
    with pytest.raises(DeviceKernelError):
        m.map_contig(*contigs[0])
    m.chain_backend = broken
    with pytest.raises(DeviceKernelError):
        m.map_contig(*contigs[1])

    def host_fault(*a, **k):
        raise RuntimeError("host fault")

    m.stream_backend = host_fault
    assert m.map_contig(*contigs[0]) == []
    # a backend on a card that is not there raises at its first call
    if not torch.cuda.is_available():
        with pytest.raises(DeviceKernelError):
            TorchStreamChainBackend("cuda")(
                _sv_batches(np.random.default_rng(1))[0], "global_nocov", 15,
                40.0, 50, 1000, np.zeros(0), np.zeros(0, np.int64))


def _body(path):
    return [l for l in Path(path).read_text().splitlines()
            if not l.startswith("@PG")]


def test_asm_cli_matches_host_cli(asm_world, tmp_path):
    """`vacmap-tpu-torch -mode asm`, on the host path and with
    --backend jax --device cpu, writes the SAM of `vacmap-tpu -mode asm`;
    an existing workdir is refused and a fresh one is removed."""
    from vacmap_tpu import cli as host_cli
    from vacmap_tpu_torch import cli as port_cli

    genome, contigs = asm_world
    ref = tmp_path / "ref.fa"
    ref.write_text(f">g3\n{genome['g3']}\n")
    rd = tmp_path / "contigs.fa"
    rd.write_text("".join(f">{n}\n{s}\n" for n, s in contigs))
    common = ["-ref", str(ref), "-read", str(rd), "-mode", "asm", "-w", "64",
              "--nowriteindex"]
    want = tmp_path / "want.sam"
    assert host_cli.main(common + ["-o", str(want)]) == 0
    assert sum(not l.startswith("@") for l in _body(want)) >= 2
    wd = tmp_path / "wd"
    host_out = tmp_path / "port_host.sam"
    assert port_cli.main(common + ["--backend", "numpy", "-workdir", str(wd),
                                   "-o", str(host_out)]) == 0
    assert not wd.exists()
    dev_out = tmp_path / "port_dev.sam"
    assert port_cli.main(common + ["--backend", "jax", "--device", "cpu",
                                   "-o", str(dev_out)]) == 0
    assert _body(host_out) == _body(want)
    assert _body(dev_out) == _body(want)
    wd.mkdir()
    assert port_cli.main(common + ["-workdir", str(wd),
                                   "-o", str(tmp_path / "x.sam")]) == 1
    assert wd.exists() and not (tmp_path / "x.sam").exists()


def test_asm_cli_exits_nonzero_on_a_device_error(asm_world, tmp_path):
    """--backend jax with --device cuda and no card: the CLI fails before
    mapping instead of chaining on the host."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    genome, contigs = asm_world
    ref = tmp_path / "ref.fa"
    ref.write_text(f">g3\n{genome['g3'][:100_000]}\n")
    rd = tmp_path / "c.fa"
    rd.write_text(f">c\n{genome['g3'][1000:9000]}\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "vacmap_tpu_torch.cli", "-ref", str(ref),
         "-read", str(rd), "-mode", "asm", "--backend", "jax",
         "--nowriteindex", "-o", str(tmp_path / "o.sam")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "DeviceKernelError" in r.stderr
