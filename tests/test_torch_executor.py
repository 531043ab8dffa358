"""vacmap_tpu_torch batched executor and CLI on the CPU (plain kernel
versions) against the vacmap_tpu executor, the host per-read mapper and
the host CLI: the executor (--backend jax), the single-worker and the
fork-pool deployments with their fill service."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vacmap_tpu.config import AlignerConfig
from vacmap_tpu.index import ReferenceIndex
from vacmap_tpu.pipeline.chaining import chain_read, prepare_read_anchors
from vacmap_tpu.pipeline.executor import BatchExecutor
from vacmap_tpu.pipeline.mapper import Mapper
from vacmap_tpu.seq import revcomp
from vacmap_tpu_torch.config import AlignerConfig as PortConfig
from vacmap_tpu_torch.index import ReferenceIndex as PortIndex
from vacmap_tpu_torch.pipeline.mapper import Mapper as PortMapper
from vacmap_tpu_torch.ops.chain import MAX_N
from vacmap_tpu_torch.parallel.device_service import TorchAggregatingChainBackend
from vacmap_tpu_torch.parallel.fill_service import AsyncFillAligner
from vacmap_tpu_torch.pipeline.executor import TorchBatchExecutor
from tests.conftest import random_dna

REPO = Path(__file__).resolve().parent.parent


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


@pytest.fixture(scope="module")
def port_mapper(world):
    """A fresh Mapper of the port (its own index, config and host
    layers) over the world's genome."""
    pidx = PortIndex.build(world[0], k=15, w=10)
    return lambda **kw: PortMapper(pidx, PortConfig(mode="H"), **kw)


def _cols(lines):
    return sorted(tuple(l.split("\t")[1:6]) for l in lines)


def test_torch_executor_matches_jax_executor_and_host(world, port_mapper):
    genome, idx, reads = world
    cfg = AlignerConfig(mode="H")
    host = [Mapper(idx, cfg).map_read(n, s) for n, s in reads]
    jax_lines = BatchExecutor(Mapper(idx, cfg), device_local_dp=True).map_batch(
        reads, n_threads=3)
    m = port_mapper()
    ex = TorchBatchExecutor(m, device="cpu")
    assert isinstance(m.chain_backend, TorchAggregatingChainBackend)
    # fills go through the in-process fill service, as in the reference
    assert isinstance(m.global_aligner, AsyncFillAligner)
    assert m.global_aligner.ready.wait(60)
    try:
        got = ex.map_batch(reads, n_threads=3)
    finally:
        ex.close()
    for (name, _), g, j, h in zip(reads, got, jax_lines, host):
        assert g, name
        assert len(g) == len(j) == len(h), name
        assert _cols(g) == _cols(j) == _cols(h), name


def test_torch_executor_replaces_the_per_call_backend(world):
    """A Mapper built for --backend jax carries the per-call chain
    backend; under the executor the aggregating one takes its place, so
    the executor's routes are the same whichever Mapper it is given."""
    from vacmap_tpu_torch.ops.chain import TorchChainBackend

    pidx = PortIndex.build(world[0], k=15, w=10)
    m = PortMapper(pidx, PortConfig(mode="H", backend="jax"), device="cpu")
    assert isinstance(m.chain_backend, TorchChainBackend)
    TorchBatchExecutor(m, device="cpu", device_fills=False)
    assert isinstance(m.chain_backend, TorchAggregatingChainBackend)


def test_torch_map_stream_matches_map_batch(world, port_mapper):
    genome, idx, reads = world
    ex = TorchBatchExecutor(port_mapper(), device="cpu")
    try:
        got = list(ex.map_stream(iter(reads), batch_reads=4, n_threads=2))
        assert got == ex.map_batch(reads, n_threads=2)
    finally:
        ex.close()


def test_torch_executor_routes_2_31_anchors_to_host(world, port_mapper):
    """The reference executor casts anchors to int32 unguarded; the port
    hands a read whose anchors reach 2^31 to the host DP."""
    genome, idx, reads = world
    m = port_mapper()
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
    assert port_cli.main(common + ["--backend", "jax", "--device", "cpu",
                                   "-o", str(out_port)]) == 0
    assert host_cli.main(common + ["--backend", "numpy", "-t", "1",
                                   "--device-fills", "off",
                                   "-o", str(out_host)]) == 0

    def body(p):
        return [l for l in p.read_text().splitlines() if not l.startswith("@PG")]

    got, want = body(out_port), body(out_host)
    assert sum(not l.startswith("@") for l in want) >= 4
    assert got == want


def _port_cli_process(args, tmp_path, timeout=300, **env_extra):
    env = dict(os.environ, **env_extra)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "vacmap_tpu_torch.cli", *args],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("threads", ["2", "1"])
def test_torch_cli_service_deployments_match_host_cli(world, tmp_path, threads):
    """The default deployment (-t 2: fork workers sharing one service
    process) and -t 1 (one deferred-window loop and the service process),
    with --device cpu --device-fills on: the service serves fills, and
    the SAM records equal vacmap_tpu's --backend numpy --device-fills off."""
    from vacmap_tpu import cli as host_cli

    genome, idx, reads = world
    ref = tmp_path / "ref.fa"
    ref.write_text(f">e1\n{genome['e1']}\n")
    rd = tmp_path / "reads.fa"
    rd.write_text("".join(f">{n}\n{s}\n" for n, s in reads))
    out_port = tmp_path / "port.sam"
    out_host = tmp_path / "host.sam"
    stats = tmp_path / "stats.txt"
    common = ["-ref", str(ref), "-read", str(rd), "-mode", "H", "--nowriteindex"]
    r = _port_cli_process(common + ["-t", threads, "--device", "cpu",
                                    "--device-fills", "on", "-o", str(out_port)],
                          tmp_path, VACMAP_TPU_FILL_STATS=str(stats))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "device error" not in r.stderr
    fields = dict(kv.split("=", 1) for kv in stats.read_text().split())
    assert int(fields["jobs"]) > 0 and int(fields["calls"]) > 0
    assert host_cli.main(common + ["--backend", "numpy", "-t", "1",
                                   "--device-fills", "off",
                                   "-o", str(out_host)]) == 0

    def records(p):
        return sorted(l for l in p.read_text().splitlines()
                      if not l.startswith("@"))

    assert len(records(out_host)) >= len(reads)
    assert records(out_port) == records(out_host)


def test_torch_cli_without_a_card_exits_nonzero(world, tmp_path):
    """--device cuda (the default) with no card fails before mapping, on
    both the executor and the fork-pool paths."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    genome, idx, reads = world
    ref = tmp_path / "ref.fa"
    ref.write_text(f">e1\n{genome['e1'][:20000]}\n")
    rd = tmp_path / "reads.fa"
    rd.write_text(f">r\n{genome['e1'][1000:3000]}\n")
    for extra in (["-t", "2"], ["--backend", "jax"]):
        r = _port_cli_process(["-ref", str(ref), "-read", str(rd), "-mode", "H",
                               "--nowriteindex", "-o", str(tmp_path / "o.sam"),
                               "--force", *extra], tmp_path, timeout=120)
        assert r.returncode != 0 and "DeviceKernelError" in r.stderr, extra


@pytest.mark.parametrize("argv", [
    ["-mode", "asm", "--num-processes", "2"],
    ["-mode", "H", "--num-processes", "2"],
    ["-mode", "H", "--coordinator", "localhost:1234"],
    ["-mode", "L", "--num-processes", "3", "--process-id", "1"],
])
def test_torch_cli_refuses_unported_paths(argv, tmp_path):
    """Multi-host runs are ported: these flags pass the argument checks
    (no "not yet ported" refusal) and the run stops at the missing read
    file, before any process group or output is made."""
    from vacmap_tpu_torch import cli as port_cli

    rc = port_cli.main(["-ref", str(tmp_path / "r.fa"), "-read",
                        str(tmp_path / "q.fa"), "--device", "cpu", *argv])
    assert rc == 1
    assert not list(tmp_path.iterdir())


def test_torch_cli_prewarm_runs_on_the_cpu_and_needs_a_card_otherwise(capsys):
    """--prewarm is ported: with --device cpu it builds the host library,
    runs every wrapper's plain version once and exits 0; with --device
    cuda (the default) and no card it fails with the no-card error."""
    import torch

    from vacmap_tpu_torch import DeviceKernelError
    from vacmap_tpu_torch import cli as port_cli

    assert port_cli.main(["--prewarm", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for word in ("host library", "fill kernel", "scan fill kernel",
                 "myers kernel (T=20480", "chain kernel", "asm stream chain",
                 "prewarm complete"):
        assert word in out, word
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for argv in (["--prewarm"], ["--prewarm", "--device", "cuda"]):
        with pytest.raises(DeviceKernelError, match="no CUDA card"):
            port_cli.main(argv)


def test_torch_prewarm_module_entry(tmp_path):
    """python -m vacmap_tpu_torch.prewarm: the flags select the families."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "vacmap_tpu_torch.prewarm", *a], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    r = run("--chain", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "chain kernel (N=512)" in r.stdout and "fill kernel" not in r.stdout
    r = run("--fills", "--asm", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "myers kernel" in r.stdout and "asm stream chain" in r.stdout
    assert "chain kernel (N=512)" not in r.stdout
    import torch

    if not torch.cuda.is_available():
        r = run("--all")
        assert r.returncode != 0 and "no CUDA card" in r.stderr


def test_torch_cli_edit_route_matches_host_cli(world, tmp_path):
    """VACMAP_TPU_EDIT_DEVICE=1: the executor's divergence filter takes
    exact distances from the service's edit kind (the plain version on
    --device cpu), and the SAM still equals vacmap-tpu --backend numpy."""
    from vacmap_tpu import cli as host_cli

    genome, idx, reads = world
    ref = tmp_path / "ref.fa"
    ref.write_text(f">e1\n{genome['e1']}\n")
    rd = tmp_path / "reads.fa"
    rd.write_text("".join(f">{n}\n{s}\n" for n, s in reads[:3]))
    out_port = tmp_path / "port.sam"
    out_host = tmp_path / "host.sam"
    stats = tmp_path / "stats.txt"
    common = ["-ref", str(ref), "-read", str(rd), "-mode", "H", "--nowriteindex"]
    r = _port_cli_process(common + ["--backend", "jax", "--device", "cpu",
                                    "-o", str(out_port)], tmp_path,
                          timeout=600, VACMAP_TPU_FILL_STATS=str(stats),
                          VACMAP_TPU_EDIT_DEVICE="1")
    assert r.returncode == 0, r.stderr[-3000:]
    st = dict(kv.split("=", 1) for kv in stats.read_text().split())
    assert int(st["edit_served"]) >= 3 and st["edit_not_live"] == "0"
    assert int(st["edit_submitted"]) == (int(st["edit_sent"])
                                         + int(st["edit_capped"]))
    assert host_cli.main(common + ["--backend", "numpy", "-t", "1",
                                   "--device-fills", "off",
                                   "-o", str(out_host)]) == 0

    def body(p):
        return [l for l in p.read_text().splitlines() if not l.startswith("@PG")]

    assert sum(not l.startswith("@") for l in body(out_host)) >= 3
    assert body(out_port) == body(out_host)


def test_torch_executor_raises_device_errors(world, port_mapper):
    """A failing device call stops the run; it is not dropped like a host
    error.  Without a card, a backend on "cuda" fails in the finishing
    threads' local-DP launches, and an executor on "cuda" in its global
    chain launch."""
    import torch

    from vacmap_tpu_torch import DeviceKernelError

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    genome, idx, reads = world
    m = port_mapper()
    m.chain_backend = TorchAggregatingChainBackend("cuda", max_wait_ms=0.0)
    ex = TorchBatchExecutor(m, device="cpu", device_fills=False)
    with pytest.raises(DeviceKernelError):
        ex.map_batch(reads[:2], n_threads=2)
    with pytest.raises(DeviceKernelError):
        TorchBatchExecutor(port_mapper(), device="cuda").map_batch(reads[:2], n_threads=2)


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
