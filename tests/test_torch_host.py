"""The port's own copy of the host layers against the JAX package's: the
host path (``--backend numpy --device-fills off``) writes the same SAM
records in modes H, L, S and R on a small simulated corpus, and one
``.vmi`` index serves both packages."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vacmap_tpu import cli as host_cli
from vacmap_tpu.index import ReferenceIndex
from vacmap_tpu.seq import revcomp
from vacmap_tpu_torch import cli as port_cli
from vacmap_tpu_torch.index import ReferenceIndex as PortIndex
from tests.conftest import random_dna

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 150 kb two-contig genome and 8 reads of 5-6 kb with 3% errors:
    plain, a 2 kb inversion, a 1.5 kb deletion, a 600 bp tandem
    duplication, and a reverse-strand read."""
    rng = np.random.default_rng(31337)
    genome = {"h1": random_dna(rng, 100_000), "h2": random_dna(rng, 50_000)}
    d = tmp_path_factory.mktemp("hostcorpus")
    (d / "ref.fa").write_text("".join(f">{n}\n{s}\n" for n, s in genome.items()))
    reads = []
    for i in range(8):
        ctg = "h1" if i % 3 else "h2"
        g = genome[ctg]
        st = int(rng.integers(0, len(g) - 7000))
        frag = g[st : st + 6000]
        kind = i % 4
        if kind == 1:
            frag = frag[:2000] + revcomp(frag[2000:4000]) + frag[4000:]
        elif kind == 2:
            frag = frag[:2500] + frag[4000:]
        elif kind == 3:
            frag = frag[:3000] + frag[2400:3000] + frag[3000:]
        seq = np.array(list(frag))
        err = rng.random(len(seq)) < 0.03
        seq[err] = np.array(list("ACGT"))[rng.integers(0, 4, int(err.sum()))]
        frag = "".join(seq)
        if i == 5:
            frag = revcomp(frag)
        reads.append((f"h{i}", frag))
    (d / "reads.fa").write_text("".join(f">{n}\n{s}\n" for n, s in reads))
    return d, genome, reads


def _records(path):
    return [l for l in Path(path).read_text().splitlines()
            if not l.startswith("@PG")]


@pytest.mark.parametrize("mode", ["H", "L", "S", "R"])
def test_host_path_matches_the_jax_package(corpus, mode, tmp_path):
    d, genome, reads = corpus
    common = ["-ref", str(d / "ref.fa"), "-read", str(d / "reads.fa"),
              "-mode", mode, "--nowriteindex", "--backend", "numpy",
              "--device-fills", "off", "-t", "1", "--MD", "--cs"]
    want, got = tmp_path / "want.sam", tmp_path / "got.sam"
    assert host_cli.main(common + ["-o", str(want)]) == 0
    assert port_cli.main(common + ["-o", str(got)]) == 0
    recs = _records(want)
    assert sum(not l.startswith("@") for l in recs) >= len(reads)
    assert _records(got) == recs


def test_host_fork_pool_matches_the_jax_package(corpus, tmp_path):
    """-t 2 without a device: the port's own worker and writer
    processes."""
    d, genome, reads = corpus
    common = ["-ref", str(d / "ref.fa"), "-read", str(d / "reads.fa"),
              "-mode", "H", "--nowriteindex", "--backend", "numpy",
              "--device-fills", "off", "-t", "2"]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    outs = {}
    for pkg in ("vacmap_tpu", "vacmap_tpu_torch"):
        out = tmp_path / f"{pkg}.sam"
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli", *common, "-o", str(out)],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        outs[pkg] = sorted(l for l in out.read_text().splitlines()
                           if not l.startswith("@"))
    assert len(outs["vacmap_tpu"]) >= len(reads)
    assert outs["vacmap_tpu_torch"] == outs["vacmap_tpu"]


@pytest.mark.parametrize("writer", ["port", "jax_package"])
def test_one_vmi_serves_both_packages(corpus, writer, tmp_path):
    """An index saved by either package loads in the other and seeds the
    same anchors; the CLIs of both map from it."""
    d, genome, reads = corpus
    path = str(tmp_path / "ref.vmi")
    build, load = ((PortIndex, ReferenceIndex) if writer == "port"
                   else (ReferenceIndex, PortIndex))
    built = build.build(genome, k=15, w=10)
    built.save(path)
    saved = path if os.path.isdir(path) else path + ".npz"
    loaded = load.load(saved)
    assert list(loaded.contig_names) == list(built.contig_names)
    assert np.array_equal(loaded.contig_lens, built.contig_lens)
    assert np.array_equal(np.asarray(loaded.seq_codes),
                          np.asarray(built.seq_codes))
    for _, seq in reads[:3]:
        assert np.array_equal(loaded.seeds(seq, check_num=100),
                              built.seeds(seq, check_num=100))
    common = ["-ref", saved, "-read", str(d / "reads.fa"), "-mode", "H",
              "--backend", "numpy", "--device-fills", "off", "-t", "1"]
    want, got = tmp_path / "want.sam", tmp_path / "got.sam"
    assert host_cli.main(common + ["-o", str(want)]) == 0
    assert port_cli.main(common + ["-o", str(got)]) == 0
    assert _records(got) == _records(want)
