"""vacmap_tpu_torch.sim against vacmap_tpu.sim: the same seed writes the
same altered genome and truth VCF (in memory and through both command
lines), benchcorpus builds the same corpus, and call_signatures,
cluster_calls and score_events give the same answers on one mapping
run's records."""

import numpy as np
import pytest

from vacmap_tpu.sim import benchcorpus as ref_corpus
from vacmap_tpu.sim import svcalls as ref_svcalls
from vacmap_tpu.sim import vacsim as ref_vacsim
from vacmap_tpu_torch.config import AlignerConfig as PortConfig
from vacmap_tpu_torch.index import ReferenceIndex as PortIndex
from vacmap_tpu_torch.pipeline.mapper import Mapper as PortMapper
from vacmap_tpu_torch.sim import benchcorpus, svcalls, vacsim
from tests.conftest import random_dna

RECIPES = (
    "Specified{DEL:300:900;number=3}\n"
    "Specified{INS:200:400;number=2}\n"
    "Specified{INV:800:1500;number=2}\n"
    "Specified{DUP:400:900:0:1;number=2}\n"
    "Specified{TRA:600:1500:0;number=1}\n"
    "Random{eventset=['DEL:100:200,NML:100:200','INV:100:200'];"
    "eventcount=[1,3];number=3}\n"
)


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(2024)
    return {"c1": random_dna(rng, 120_000), "c2": random_dna(rng, 80_000)}


@pytest.mark.parametrize("het", [0.0, 0.6])
def test_simulate_and_vcf_match(genome, het, tmp_path):
    got = vacsim.simulate(RECIPES, genome, heterozygous_ratio=het, seed=11)
    want = ref_vacsim.simulate(RECIPES, genome, heterozygous_ratio=het, seed=11)
    assert got[0] == want[0]
    assert got[1] == want[1] and len(got[1]) >= 13
    lens = {c: len(s) for c, s in genome.items()}
    paths = []
    for k, mod in enumerate((vacsim, ref_vacsim)):
        p = tmp_path / f"truth{k}.vcf"
        mod.write_vcf(mod.truth_to_vcf_rows(got[1]), lens, str(p))
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()


@pytest.mark.parametrize("mode", ["read", "reference"])
def test_command_lines_write_the_same_files(genome, mode, tmp_path):
    g = tmp_path / "g.fa"
    g.write_text("".join(f">{c}\n{s}\n" for c, s in genome.items()))
    pf = tmp_path / "params.txt"
    pf.write_text("Specified{DEL:400:500;number=2}\n"
                  "Specified{INS:300:400;number=2}\n")
    files = []
    for k, mod in enumerate((vacsim, ref_vacsim)):
        alt, vcf = tmp_path / f"alt{k}.fa", tmp_path / f"truth{k}.vcf"
        assert mod.main([
            "-parameterfilepath", str(pf), "-inputgenomepath", str(g),
            "-altedgenomepath", str(alt), "-outputvcfpath", str(vcf),
            "-heterozygous_ratio", "0", "-mode", mode, "-seed", "5",
        ]) == 0
        files.append((alt.read_bytes(), vcf.read_bytes()))
    assert files[0] == files[1]


@pytest.fixture(scope="module")
def sv_world():
    got, want = benchcorpus.sv_world(), ref_corpus.sv_world()
    return got, want


def test_benchcorpus_builds_the_same_corpus(sv_world):
    (g, alt, truth), (g0, alt0, truth0) = sv_world
    assert g == g0 and alt == alt0 and truth == truth0
    for seed in benchcorpus.READ_SEEDS:
        assert (benchcorpus.sample_reads(alt["chrS"], seed)
                == ref_corpus.sample_reads(alt0["chrS"], seed))
    large, large0 = benchcorpus.sv_world_large(), ref_corpus.sv_world_large()
    assert large == large0 and len(large[2]) >= 200
    assert (benchcorpus.sample_reads_multi(large[1], 7, coverage=1)
            == ref_corpus.sample_reads_multi(large0[1], 7, coverage=1))


def test_call_signatures_match_on_one_mapping_run(sv_world):
    """The port's mapper on 24 corpus reads: both packages' callers give
    the same signatures, clusters and scores against the truth set."""
    (g, alt, truth), _ = sv_world
    mapper = PortMapper(PortIndex.build(g, k=15, w=10), PortConfig(mode="H"))
    reads = benchcorpus.sample_reads(alt["chrS"], benchcorpus.READ_SEEDS[0])
    records = [mapper.map_read_records(name, seq)[0] for name, seq in reads[:24]]
    calls, calls0 = [], []
    for recs in records:
        calls += svcalls.call_signatures(recs)
        calls0 += ref_svcalls.call_signatures(recs)
    assert calls == calls0 and calls
    events = svcalls.cluster_calls(calls)
    assert events == ref_svcalls.cluster_calls(calls0)
    assert (svcalls.score_events(truth, events)
            == ref_svcalls.score_events(truth, events))
    assert (svcalls.score_events_per_class(truth, events)
            == ref_svcalls.score_events_per_class(truth, events))
