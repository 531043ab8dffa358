"""vacmap_tpu_torch's data-parallel layer on the CPU: ShardedChainStep
over lists of CPU devices against the unsplit plain call and against
vacmap_tpu's ShardedChainStep on the 8 virtual CPU devices; the executor
over a device list; the CLI's read sharding across processes (merged
SAM, BAM and sorted BAM equal to vacmap-tpu's) and its gloo boot with
--coordinator; no CPU fallback for a missing card."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from vacmap_tpu import cli as host_cli
from vacmap_tpu.ops.chain_jax import prepare_batch as jax_prepare_batch
from vacmap_tpu.parallel import mesh as jax_mesh
from vacmap_tpu.seq import revcomp
from vacmap_tpu_torch import cli as port_cli
from vacmap_tpu_torch.config import AlignerConfig as PortConfig
from vacmap_tpu_torch.device import DeviceKernelError
from vacmap_tpu_torch.index import ReferenceIndex as PortIndex
from vacmap_tpu_torch.io.bam_reader import read_bam
from vacmap_tpu_torch.io.merge_parts import raw_bam_records
from vacmap_tpu_torch.ops.chain import chain_scores_batch, prepare_batch, to_device
from vacmap_tpu_torch.parallel.mesh import ShardedChainStep, make_mesh
from vacmap_tpu_torch.pipeline.executor import TorchBatchExecutor
from vacmap_tpu_torch.pipeline.mapper import Mapper as PortMapper
from tests.conftest import random_dna
from tests.test_chain import chainy_anchors

REPO = Path(__file__).resolve().parent.parent
S_ATOL = 1e-4
P_MIN = 0.999


def _batch(seed, n_reads, read_len, noise):
    rng = np.random.default_rng(seed)
    alist = [chainy_anchors(rng, read_len=read_len, noise=noise).astype(np.int32)
             for _ in range(n_reads)]
    port = prepare_batch(alist, "global", 40.0, 50)
    ref = jax_prepare_batch(alist, "global", 40.0, 50)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    return port


def _unsplit(batch):
    S, P = chain_scores_batch(*to_device("cpu", *batch))
    return S.numpy(), P.numpy()


@pytest.fixture(scope="module")
def full():
    """test_mesh_scaling's batch (8 chainy reads) and its unsplit plain
    call."""
    batch = _batch(4242, 8, 1200, 4)
    return batch, _unsplit(batch)


def _held_to_jax(batch, got, n_dev):
    """The port's step output against vacmap_tpu's ShardedChainStep over
    n_dev of the virtual CPU devices; returns (max |dS|, P agreement)."""
    S, P, best, n_acc = got
    jS, jP, jbest, jn = jax_mesh.ShardedChainStep(jax_mesh.make_mesh(n_dev))(*batch)
    valid = np.arange(S.shape[1])[None, :] < batch[1][:, None]
    err = float(np.abs(S - np.asarray(jS))[valid].max())
    agree = float((P == np.asarray(jP))[valid].mean())
    print(f"n_dev={n_dev}: max|dS| {err:.3g} P agreement {agree:.6f}")
    assert err <= S_ATOL
    assert agree >= P_MIN
    np.testing.assert_allclose(best, np.asarray(jbest), rtol=0, atol=S_ATOL)
    assert n_acc == jn
    return err, agree


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_chain_step_matches_unsplit_and_jax(full, n_dev):
    """The split over n CPU devices gives the unsplit plain call's bits,
    and vacmap_tpu's sharded step's S within 1e-4 (largest seen: 0, the
    plain version keeps f32 and the reference's operation order), its P
    at >= 0.999 agreement (seen: 1.000000) and its accepted count."""
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough virtual CPU devices")
    batch, (S0, P0) = full
    step = ShardedChainStep(make_mesh(n_dev, "cpu"))
    assert step.devices == [torch.device("cpu")] * n_dev
    got = step(*batch)
    S, P, best, n_acc = got
    np.testing.assert_array_equal(S.view(np.int32), S0.view(np.int32))
    np.testing.assert_array_equal(P, P0)
    np.testing.assert_array_equal(best, S0.max(axis=1))
    assert n_acc == 8  # every chainy read accepted
    _held_to_jax(batch, got, n_dev)


def test_sharded_chain_step_pads_ragged_batch():
    """5 reads over 4 devices: padded to 8 with empty rows, cut back to
    5; the same bits as the unsplit call, and vacmap_tpu's step's
    results."""
    batch = _batch(77, 5, 800, 2)
    step = ShardedChainStep(make_mesh(4, "cpu"))
    padded = step.pad_batch(*batch)
    assert padded[0].shape[0] == 8 and padded[4] == 5
    assert not padded[1][5:].any()
    got = step(*batch)
    S, P, best, n_acc = got
    S0, P0 = _unsplit(batch)
    assert S.shape[0] == 5 and n_acc == 5
    np.testing.assert_array_equal(S.view(np.int32), S0.view(np.int32))
    np.testing.assert_array_equal(P, P0)
    _held_to_jax(batch, got, 4)


def test_no_cpu_fallback_for_a_missing_card():
    """make_mesh asks for cards and gets none here: an error, never a
    list of CPU devices."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible")
    with pytest.raises(DeviceKernelError):
        make_mesh(2, "cuda")
    with pytest.raises(DeviceKernelError):
        make_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")


@pytest.fixture(scope="module")
def world():
    """A 150 kb genome and 6 x 6 kb reads, half with a 2 kb inversion
    (tests/test_torch_executor.py's world)."""
    rng = np.random.default_rng(4321)
    genome = random_dna(rng, 150_000)
    reads = []
    for i in range(6):
        st = int(rng.integers(0, 150_000 - 6000))
        frag = genome[st : st + 6000]
        if i % 2:
            frag = frag[:2000] + revcomp(frag[2000:4000]) + frag[4000:]
        reads.append((f"r{i}", frag))
    return genome, reads


def test_executor_over_a_device_list_matches_one_device(world):
    """TorchBatchExecutor(devices=[cpu, cpu]): the global chain and the
    local DPs run through the split steps, and the records are those of
    the executor on one device."""
    genome, reads = world
    idx = PortIndex.build({"e1": genome}, k=15, w=10)
    lines = {}
    for name, devices in (("one", None), ("two", make_mesh(2, "cpu"))):
        ex = TorchBatchExecutor(PortMapper(idx, PortConfig(mode="H"),
                                           device="cpu"),
                                "cpu", device_fills=False, devices=devices)
        lines[name] = ex.map_batch(reads, n_threads=2)
        if devices is None:
            assert ex.devices is None and not ex._sharded_steps
        else:
            assert ex.devices == devices
            assert ex.mapper.chain_backend.devices == devices
            assert ex._sharded_steps, "the global chain took no split step"
            assert ex.mapper.chain_backend._steps, \
                "the local DPs took no split step"
    assert sum(len(x) for x in lines["one"]) >= len(reads)
    assert lines["two"] == lines["one"]


# ---------------------------------------------------------------------------
# the CLI across processes (tests/test_cli.py's multi-host cases)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    """tests/test_cli.py's world: a 60 kb genome and 3 reads of 4 kb."""
    rng = np.random.default_rng(1234)
    d = tmp_path_factory.mktemp("port_mh")
    genome = random_dna(rng, 60_000)
    ref = d / "ref.fa"
    ref.write_text(f">c1\n{genome}\n")
    reads = d / "reads.fa"
    reads.write_text("".join(
        f">rd{i}\n{genome[5_000 + i * 10_000 : 9_000 + i * 10_000]}\n"
        for i in range(3)))
    return d, ref, reads, genome


def _run(main, args):
    return main([str(a) for a in args])


def _records(path):
    """Sorted SAM records (header left out) of a SAM or BAM file."""
    path = str(path)
    if path.endswith(".bam"):
        return sorted(tuple(map(str, r)) for r in read_bam(path))
    with open(path) as f:
        return sorted(ln for ln in f.read().splitlines() if not ln.startswith("@"))


def _sharded(main, args, out, n=2):
    """Every process of an n-process run, process 0 last, as in
    tests/test_cli.py; returns the merged output's records."""
    for pid in range(n - 1, -1, -1):
        assert _run(main, [*args, "-o", out, "--force", "--num-processes", n,
                           "--process-id", pid]) == 0
    return _records(out)


def test_port_multihost_read_sharding(cli_world, tmp_path):
    """Two processes partition the de-duplicated reads round-robin into
    part files; process 0 merges them; the merged records are those of
    vacmap-tpu's run of the same command, and of one process."""
    d, ref, reads, genome = cli_world
    many = tmp_path / "many.fa"
    with open(many, "w") as f:
        for i in range(6):
            st = 3_000 + i * 8_000
            f.write(f">m{i}\n{genome[st : st + 4_000]}\n")
        f.write(f">m0\n{genome[3_000:7_000]}\n")  # duplicate name: dropped
    common = ["-ref", ref, "-read", many, "-mode", "H", "-t", "1",
              "--nowriteindex", "--device-fills", "off"]
    port = ["--device", "cpu"]
    assert _run(port_cli.main, [*common, *port, "-o", tmp_path / "single.sam"]) == 0
    single = _records(tmp_path / "single.sam")
    assert {ln.split("\t")[0] for ln in single} == {f"m{i}" for i in range(6)}

    out = tmp_path / "mh.sam"
    assert _run(port_cli.main, [*common, *port, "-o", out, "--force",
                                "--num-processes", 2, "--process-id", 1]) == 0
    part1 = tmp_path / "mh.part1.sam"
    assert part1.exists() and (tmp_path / "mh.part1.sam.done").exists()
    assert {ln.split("\t")[0] for ln in _records(part1)} == {"m1", "m3", "m5"}
    assert _run(port_cli.main, [*common, *port, "-o", out, "--force",
                                "--num-processes", 2, "--process-id", 0]) == 0
    assert not part1.exists()
    merged = _records(out)
    assert merged == single
    assert _sharded(host_cli.main, common, tmp_path / "host_mh.sam") == merged


@pytest.mark.parametrize("ext", ["sam", "bam", "sorted.bam"])
def test_port_multihost_merged_output(cli_world, tmp_path, ext):
    """The executor (--backend jax --device cpu) in two processes: one
    merged output, no part left, one @HD, records equal to vacmap-tpu's
    two-process host run (SAM header-dedup, BAM restream, sorted-BAM
    coordinate merge)."""
    d, ref, reads, genome = cli_world
    common = ["-ref", ref, "-read", reads, "-mode", "H", "-t", "1",
              "--nowriteindex"]
    out = tmp_path / f"mh.{ext}"
    got = _sharded(port_cli.main, [*common, "--backend", "jax", "--device",
                                    "cpu"], out)
    assert not any(".part" in f for f in os.listdir(tmp_path))
    (tmp_path / "host").mkdir()
    want = _sharded(host_cli.main, [*common, "--backend", "numpy",
                                    "--device-fills", "off"],
                    tmp_path / "host" / f"mh.{ext}")
    assert len(got) == 3 and got == want
    if ext == "sam":
        hdr = [ln for ln in out.read_text().splitlines() if ln.startswith("@")]
        assert sum(ln.startswith("@HD") for ln in hdr) == 1
    else:
        assert sorted(r[0] for r in read_bam(str(out))) == ["rd0", "rd1", "rd2"]
    if ext == "sorted.bam":
        poss = [(rid, pos) for rid, pos, _ in raw_bam_records(str(out))]
        assert poss == sorted(poss)


@pytest.mark.parametrize("mode", ["H", "asm"])
def test_port_multihost_file_sharding(cli_world, tmp_path, mode):
    """With as many input files as processes, whole files shard across
    processes; the merged output covers every read once and equals
    vacmap-tpu's run of the same command (-mode asm too)."""
    d, ref, reads, genome = cli_world
    files = []
    for j in range(2):
        f = tmp_path / f"in{j}.fa"
        with open(f, "w") as fh:
            for i in range(2):
                st = 4_000 + (2 * j + i) * 9_000
                fh.write(f">f{j}_{i}\n{genome[st : st + 4_000]}\n")
        files.append(f)
    common = ["-ref", ref, "-read", *files, "-mode", mode, "-t", "1",
              "--nowriteindex", "--device-fills", "off", "--backend", "numpy"]
    got = _sharded(port_cli.main, [*common, "--device", "cpu"],
                   tmp_path / "fs.sam")
    assert sorted({ln.split("\t")[0] for ln in got}) == [
        "f0_0", "f0_1", "f1_0", "f1_1"]
    assert _sharded(host_cli.main, common, tmp_path / "host_fs.sam") == got


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_port_multihost_gloo_boot(cli_world, tmp_path):
    """Two port CLI processes (-t 2: each a fork pool) join a gloo group
    through --coordinator, pass its barrier, map their shards and merge:
    the records are byte-identical to one port process and to vacmap-tpu's
    one process; one @HD and one @PG."""
    d, ref, reads, genome = cli_world
    common = ["-ref", ref, "-read", reads, "-mode", "H", "--nowriteindex",
              "--device-fills", "off"]
    solo = tmp_path / "solo.sam"
    assert _run(port_cli.main, [*common, "-t", "1", "--device", "cpu", "-o",
                                solo]) == 0
    host_solo = tmp_path / "host_solo.sam"
    assert _run(host_cli.main, [*common, "-t", "1", "-o", host_solo]) == 0
    out = tmp_path / "dist.sam"
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "vacmap_tpu_torch.cli",
             *map(str, common), "-t", "2", "--device", "cpu", "-o", str(out),
             "--force", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid)],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        for pid in (0, 1)
    ]
    try:
        errs = [p.communicate(timeout=300)[1].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
        assert "joined the gloo group" in err
    got = _records(out)
    assert len(got) == 3
    assert got == _records(solo) == _records(host_solo)
    hdr = [ln.split("\t")[0] for ln in out.read_text().splitlines()
           if ln.startswith("@")]
    assert hdr.count("@HD") == 1 and hdr.count("@PG") == 1
    assert not any(".part" in f for f in os.listdir(tmp_path))


def test_port_cli_refuses_a_bad_shard(tmp_path):
    """--process-id outside [0, --num-processes) is refused before
    anything runs (--num-processes defaults to 1)."""
    base = ["-ref", str(tmp_path / "r.fa"), "-read", str(tmp_path / "q.fa"),
            "-mode", "H", "--device", "cpu"]
    for bad in (["--num-processes", "2", "--process-id", "2"],
                ["--process-id", "1"], ["--process-id", "-1"]):
        with pytest.raises(SystemExit, match="ERROR"):
            port_cli.main(base + bad)


def test_missing_peer_raises_instead_of_hanging(tmp_path):
    """A two-process group whose peer never comes: rank 0 (serving the
    rendezvous) and rank 1 (dialling it) each end with an error once the
    timeout passes (shortened here to 3 s)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c",
             "import vacmap_tpu_torch.parallel.mesh as m\n"
             "m.DIST_TIMEOUT_S = 3\n"
             f"m.initialize_distributed('127.0.0.1:{_free_port()}', 2, {rank})\n"],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)
    ]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode != 0
        assert "DistStoreError" in err or "DistNetworkError" in err, err[-2000:]
