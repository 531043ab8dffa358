"""The plain reference that decides ``correct`` (``yardstick/judge.py``):
its banded DP equals a full two-piece affine DP, its traceback scores what
the DP found, it judges the port's host path sound on a small genome, its
bfloat16 control reads above every configuration's limit, and it imports
nothing of the program."""

import ast
import json

import numpy as np
import pytest

from conftest import BENCH
from yardstick import cache, check, traffic
from yardstick import genome as G
from yardstick import judge as J

NEG = -(10**9)


def full_dp(q, t):
    """The two-piece affine global DP over the whole matrix, cell by cell."""
    m, n = len(q), len(t)
    H = np.full((m + 1, n + 1), NEG, np.int64)
    E = {k: np.full((m + 1, n + 1), NEG, np.int64) for k in (1, 2)}
    F = {k: np.full((m + 1, n + 1), NEG, np.int64) for k in (1, 2)}
    cost = {1: (J.Q1, J.E1), 2: (J.Q2, J.E2)}
    H[0, 0] = 0
    for i in range(m + 1):
        for j in range(n + 1):
            if i == 0 and j == 0:
                continue
            for k, (qo, e) in cost.items():
                if j:
                    E[k][i, j] = max(H[i, j - 1] - qo - e, E[k][i, j - 1] - e)
                if i:
                    F[k][i, j] = max(H[i - 1, j] - qo - e, F[k][i - 1, j] - e)
            d = (H[i - 1, j - 1] + (J.MATCH if q[i - 1] == t[j - 1]
                                    else J.MISMATCH)) if i and j else NEG
            H[i, j] = max(d, E[1][i, j], E[2][i, j], F[1][i, j], F[2][i, j])
    return int(H[m, n])


def small_pairs(rng, count):
    qs, ts = [], []
    for _ in range(count):
        t = rng.integers(0, 4, int(rng.integers(0, 50))).astype(np.uint8)
        q = G.mutate_codes(rng, t, 0.2)
        if rng.random() < 0.5:
            a = int(rng.integers(0, len(q) + 1))
            q = np.concatenate([q[:a], rng.integers(0, 4, int(
                rng.integers(1, 14))).astype(np.uint8), q[a:]])
        qs.append(q.astype(np.uint8))
        ts.append(t)
    return qs, ts


def rescore(path, q, t):
    m = path[:, 0] == 0
    return J.path_score(path[:, 0], q[path[m, 1]], t[path[m, 2]])


def test_band_dp_equals_the_full_dp_and_traces_its_best():
    qs, ts = small_pairs(np.random.default_rng(0), 40)
    dlo = np.array([-len(q) - 1 for q in qs])
    dhi = np.array([len(t) + 1 for t in ts])
    best, paths = J.band_dp(qs, ts, dlo, dhi, traceback=True)
    want = [full_dp(q, t) for q, t in zip(qs, ts)]
    assert best.astype(np.int64).tolist() == want
    for path, q, t, w in zip(paths, qs, ts, want):
        assert rescore(path, q, t) == w
        assert (path[:, 0] != 2).sum() == len(q)
        assert (path[:, 0] != 1).sum() == len(t)


def test_a_narrow_band_never_beats_the_full_dp():
    qs, ts = small_pairs(np.random.default_rng(1), 30)
    dlo = np.array([min(0, len(t) - len(q)) - 2 for q, t in zip(qs, ts)])
    dhi = np.array([max(0, len(t) - len(q)) + 2 for q, t in zip(qs, ts)])
    best, _ = J.band_dp(qs, ts, dlo, dhi)
    assert all(b <= full_dp(q, t) for b, q, t in zip(best, qs, ts))


@pytest.mark.parametrize("name,mix_name", [("ont_H", "wgs_ont"),
                                           ("hifi_L", "wgs_hifi")])
def test_bf16_control_reads_above_the_limit(name, mix_name):
    """The DP in bfloat16, put in the program's place on 1 kb pieces at the
    mix's mean error, its paths scored exactly."""
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    mix = json.loads((BENCH / "traffic" / f"{mix_name}.json").read_text())
    err = (mix["error"]["low"] + mix["error"]["high"]) / 2
    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, 200_000).astype(np.uint8)
    ts = [g[k * 1000:(k + 1) * 1000] for k in range(128)]
    qs = [G.mutate_codes(rng, t, err) for t in ts]
    dlo, dhi = np.full(128, -J.MARGIN - 8), np.full(128, J.MARGIN + 8)
    best, _ = J.band_dp(qs, ts, dlo, dhi)
    _, paths = J.band_dp(qs, ts, dlo, dhi, bf16=True, traceback=True)
    low = np.array([rescore(p, q, t) for p, q, t in zip(paths, qs, ts)])
    gap = (best - low).sum() / (sum(map(len, qs)) / 1e3)
    assert gap > conf["check"]["limits"]["score_gap_per_kb"]


def test_judge_finds_the_port_host_path_sound(tiny_ont, cache_root):
    """The port's host mapper on generated reads: no SAM fault, no score
    gap, placement under the limit; the same lines with a position moved
    read a SAM fault and a score gap."""
    from vacmap_tpu_torch.config import AlignerConfig
    from vacmap_tpu_torch.index.index import ReferenceIndex
    from vacmap_tpu_torch.pipeline.mapper import Mapper

    cfg, mix = tiny_ont
    cdir, _ = cache.ensure(cfg, cache_root)
    genome = np.load(cdir / "genome.npy")
    _, pool = traffic.generate(genome, mix, 2**31 + 21, 1.0)
    mapper = Mapper(ReferenceIndex.load(str(cdir / "port.vmi")),
                    AlignerConfig(mode="H", rg_id="1", backend="numpy"),
                    device="cpu")
    reads = pool.reads[:12]
    lines = [mapper.map_read(n, s) for n, s in reads]
    truth = [pool.truth(i) for i in range(len(reads))]
    got = J.judge(reads, lines, truth, genome, cache.CONTIG)
    assert got["sam_faults"] == 0 and got["pieces"] > 10
    assert got["score_gap_per_kb"] == 0 and got["below_program"] == 0
    assert got["unplaced_share"] < cfg["check"]["limits"]["unplaced_share"]

    def moved(ls):
        out = []
        for ln in ls:
            f = ln.split("\t")
            if not int(f[1]) & 4:
                f[3] = str(int(f[3]) + 3)
            out.append("\t".join(f))
        return out

    bad = J.judge(reads, [moved(ls) for ls in lines], truth, genome,
                  cache.CONTIG)
    assert bad["sam_faults"] > 0
    assert bad["score_gap_per_kb"] > 100


def test_sample_holds_the_longest_and_repeats_for_a_seed():
    lengths = list(range(100))
    a = check.sample(lengths, 7, 10, 4)
    assert a == check.sample(lengths, 7, 10, 4) and len(a) == 10
    assert {96, 97, 98, 99} <= set(a)
    assert a != check.sample(lengths, 8, 10, 4)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for name in ("judge", "check", "traffic", "genome", "work"):
        path = BENCH / "yardstick" / f"{name}.py"
        for mod in _imports(path):
            assert mod.split(".")[0] not in (
                "vacmap_tpu_torch", "vacmap_tpu", "jax", "torch"), (path, mod)


def test_benchmark_imports_no_jax_nor_the_jax_package():
    """Whole top-level names: ``vacmap_tpu_torch`` begins with
    ``vacmap_tpu`` and is allowed."""
    for path in BENCH.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in (
                "jax", "jaxlib", "flax", "vacmap_tpu"), (path, mod)
