"""vacmap_tpu_torch batched executor and CLI on the CPU (plain kernel
versions) against the vacmap_tpu executor, the host per-read mapper and
the host CLI."""

import numpy as np
import pytest

from vacmap_tpu.config import AlignerConfig
from vacmap_tpu.index import ReferenceIndex
from vacmap_tpu.pipeline.chaining import chain_read, prepare_read_anchors
from vacmap_tpu.pipeline.executor import BatchExecutor
from vacmap_tpu.pipeline.mapper import Mapper
from vacmap_tpu.seq import revcomp
from vacmap_tpu_torch.ops.chain import MAX_N
from vacmap_tpu_torch.parallel.device_service import TorchAggregatingChainBackend
from vacmap_tpu_torch.pipeline.executor import TorchBatchExecutor
from tests.conftest import random_dna


@pytest.fixture(scope="module")
def world():
    """tests/test_executor.py's world: a 150 kb genome and 6 x 6 kb reads,
    half of them carrying a 2 kb inversion."""
    rng = np.random.default_rng(4321)
    genome = {"e1": random_dna(rng, 150_000)}
    idx = ReferenceIndex.build(genome, k=15, w=10)
    reads = []
    for i in range(6):
        st = int(rng.integers(0, 150_000 - 6000))
        frag = genome["e1"][st : st + 6000]
        if i % 2:
            frag = frag[:2000] + revcomp(frag[2000:4000]) + frag[4000:]
        reads.append((f"r{i}", frag))
    return genome, idx, reads


def _cols(lines):
    return sorted(tuple(l.split("\t")[1:6]) for l in lines)


def test_torch_executor_matches_jax_executor_and_host(world):
    genome, idx, reads = world
    cfg = AlignerConfig(mode="H")
    host = [Mapper(idx, cfg).map_read(n, s) for n, s in reads]
    jax_lines = BatchExecutor(Mapper(idx, cfg), device_local_dp=True).map_batch(
        reads, n_threads=3)
    m = Mapper(idx, cfg)
    ex = TorchBatchExecutor(m, device="cpu")
    assert isinstance(m.chain_backend, TorchAggregatingChainBackend)
    assert m.global_aligner is not None  # fills go through TorchFillAligner
    got = ex.map_batch(reads, n_threads=3)
    for (name, _), g, j, h in zip(reads, got, jax_lines, host):
        assert g, name
        assert len(g) == len(j) == len(h), name
        assert _cols(g) == _cols(j) == _cols(h), name


def test_torch_map_stream_matches_map_batch(world):
    genome, idx, reads = world
    ex = TorchBatchExecutor(Mapper(idx, AlignerConfig(mode="H")), device="cpu")
    got = list(ex.map_stream(iter(reads), batch_reads=4, n_threads=2))
    assert got == ex.map_batch(reads, n_threads=2)


def test_torch_executor_routes_2_31_anchors_to_host(world):
    """The reference executor casts anchors to int32 unguarded; the port
    hands a read whose anchors reach 2^31 to the host DP."""
    genome, idx, reads = world
    m = Mapper(idx, AlignerConfig(mode="H"))
    ex = TorchBatchExecutor(m, device="cpu")
    anchors = idx.seeds(reads[0][1].upper(), check_num=m.config.check_num)
    _, A = prepare_read_anchors(anchors, len(reads[0][1]))
    A_big = A.copy()
    A_big[:, 1] += 2**31
    skip, maxdiff, maxgap = m.config.chain_params_global()
    res = ex._device_chain([A, A_big], "global", skip, maxdiff, maxgap, 15)
    assert res[0] is not None and res[1] is None
    # the read then chains on host: the device chain backend declines it
    gc_port = chain_read(A_big, len(reads[0][1]), kmersize=15, skipcost=skip,
                         maxdiff=maxdiff, maxgap=maxgap,
                         chain_backend=m.chain_backend)
    gc_host = chain_read(A_big, len(reads[0][1]), kmersize=15, skipcost=skip,
                         maxdiff=maxdiff, maxgap=maxgap)
    assert gc_port is not None and gc_host is not None
    assert gc_port.mapq == gc_host.mapq
    for p, q in zip(gc_port.paths, gc_host.paths):
        np.testing.assert_array_equal(p, q)


def test_torch_cli_matches_host_cli(world, tmp_path):
    from vacmap_tpu import cli as host_cli
    from vacmap_tpu_torch import cli as port_cli

    genome, idx, reads = world
    ref = tmp_path / "ref.fa"
    ref.write_text(f">e1\n{genome['e1']}\n")
    rd = tmp_path / "reads.fa"
    rd.write_text("".join(f">{n}\n{s}\n" for n, s in reads[:4]))
    out_port = tmp_path / "port.sam"
    out_host = tmp_path / "host.sam"
    common = ["-ref", str(ref), "-read", str(rd), "-mode", "H", "--nowriteindex"]
    assert port_cli.main(common + ["--device", "cpu", "-o", str(out_port)]) == 0
    assert host_cli.main(common + ["--backend", "numpy", "-t", "1",
                                   "--device-fills", "off",
                                   "-o", str(out_host)]) == 0

    def body(p):
        return [l for l in p.read_text().splitlines() if not l.startswith("@PG")]

    got, want = body(out_port), body(out_host)
    assert sum(not l.startswith("@") for l in want) >= 4
    assert got == want


@pytest.mark.parametrize("argv", [
    ["-mode", "asm"], ["-mode", "H", "--num-processes", "2"],
    ["-mode", "H", "--coordinator", "localhost:1234"], ["--prewarm", "-mode", "H"],
])
def test_torch_cli_refuses_unported_paths(argv, tmp_path):
    from vacmap_tpu_torch import cli as port_cli

    with pytest.raises(SystemExit, match="not yet ported"):
        port_cli.main(["-ref", str(tmp_path / "r.fa"), "-read",
                       str(tmp_path / "q.fa"), "--device", "cpu", *argv])


def test_torch_executor_raises_device_errors(world):
    """A failing device call stops the run; it is not dropped like a host
    error.  Without a card, a backend on "cuda" fails in the finishing
    threads' local-DP launches, and an executor on "cuda" in its global
    chain launch."""
    import torch

    from vacmap_tpu_torch import DeviceKernelError

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    genome, idx, reads = world
    m = Mapper(idx, AlignerConfig(mode="H"))
    m.chain_backend = TorchAggregatingChainBackend("cuda", max_wait_ms=0.0)
    ex = TorchBatchExecutor(m, device="cpu", device_fills=False)
    with pytest.raises(DeviceKernelError):
        ex.map_batch(reads[:2], n_threads=2)
    with pytest.raises(DeviceKernelError):
        TorchBatchExecutor(Mapper(idx, AlignerConfig(mode="H")),
                           device="cuda").map_batch(reads[:2], n_threads=2)


def test_aggregating_chain_backend_concurrent_exact():
    """Many threads (more than cores) submit local DPs at once, with a
    short switch interval: each gets exactly its own S/P back."""
    import concurrent.futures
    import sys

    from vacmap_tpu.ops.chain_ref import chain_dp

    rng = np.random.default_rng(77)
    jobs = []
    for k in range(48):
        n = int(rng.integers(5, 150))
        A = np.zeros((n, 4), np.int64)
        A[:, 0] = np.sort(rng.integers(0, 3000, n))
        A[:, 1] = rng.integers(0, 100_000, n)
        A[:, 2] = rng.choice([-1, 1], n)
        A[:, 3] = rng.integers(9, 20, n)
        A = A[np.argsort(A[:, 0] + A[:, 3], kind="stable")]
        jobs.append((A, "fine" if k % 2 else "mismatch"))
    be = TorchAggregatingChainBackend("cpu", max_wait_ms=2.0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(24) as pool:
            futs = [pool.submit(be, A, v, 9, 40.0, 30, 99) for A, v in jobs]
            got = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(old)
    for (A, variant), res in zip(jobs, got):
        want = chain_dp(A, kmersize=9, skipcost=40.0, maxdiff=30, maxgap=99,
                        variant=variant)
        assert res is not None
        assert np.array_equal(res.P, want.P), variant
        assert np.allclose(res.S, want.S, atol=1e-3), variant
    assert be(jobs[0][0], "scar", 9, 40.0, 30, 99) is None
    big = np.zeros((MAX_N + 1, 4), np.int64)
    assert be(big, "fine", 9, 40.0, 30, 99) is None
