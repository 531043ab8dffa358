"""Shared inputs of the benchmark's CPU tests: the cells' files cut to a
size the CPU's plain kernels map in seconds (1 Mb genome, reads of
1-8 kb, 4 reads a batch)."""

import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def load(rel):
    return json.loads((BENCH / rel).read_text())


def tiny(cfg_file, mix_file):
    cfg = copy.deepcopy(load(cfg_file))
    cfg.update(genome_length=1_000_000, batch_reads=4, threads=2)
    cfg["check"].update(sample_reads=8, longest_reads=2)
    mix = copy.deepcopy(load(mix_file))
    mix.update(lengths={"dist": "lognormal", "median": 3000, "n50": 5000,
                        "min": 1000, "max": 8000},
               block_reads=8, warm_reads=4, pool_mbp_per_s=0.05)
    mix["svs"]["spacing"] = 20_000
    for k in mix["svs"]["kinds"].values():
        k[2] = min(k[2], 2_000)
    return cfg, mix


@pytest.fixture(scope="session")
def tiny_ont():
    return tiny("configs/ont_H.json", "traffic/wgs_ont.json")


@pytest.fixture(scope="session")
def cache_root(tmp_path_factory):
    return tmp_path_factory.mktemp("portbench_cache")


@pytest.fixture
def card():
    """Skips a test that needs an NVIDIA card where torch sees none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); this machine has none")
