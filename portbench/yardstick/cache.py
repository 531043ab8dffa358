"""The configuration's reference genome and the program's index of it,
built once into a fixed directory inside the checkout and loaded by every
later run, the way users pre-build the ``.vmi``.

``<root>/genome-<key>/`` holds ``genome.npy`` (the codes, made by the
frozen generator from the configuration's genome seed) and ``port.vmi/``
(the program's index, built by the program's own index builder: part of
the system under test).  The key hashes the genome's parameters, the
k-mer and window sizes and the generator's source, so a changed
configuration never loads a stale index, and configurations with the
same genome share one directory.  A missing directory is built in a child
process, so that its memory never counts in the run's peak.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
DEFAULT_ROOT = BENCH / ".cache"
CONTIG = "chr1"


def genome_spec(cfg: dict) -> dict:
    return {"length": cfg["genome_length"], **cfg["genome"],
            "k": cfg["k"], "w": cfg["w"]}


def key(cfg: dict) -> str:
    h = hashlib.sha256(json.dumps(genome_spec(cfg), sort_keys=True).encode())
    h.update((HERE / "genome.py").read_bytes())
    return h.hexdigest()[:16]


def directory(cfg: dict, root=DEFAULT_ROOT) -> Path:
    return Path(root) / f"genome-{key(cfg)}"


def ensure(cfg: dict, root=DEFAULT_ROOT) -> tuple:
    """(cache directory, seconds spent building it: 0 when it was there)."""
    d = directory(cfg, root)
    if (d / "done.json").exists():
        return d, 0.0
    t0 = time.perf_counter()
    d.parent.mkdir(parents=True, exist_ok=True)
    tmp = d.with_name(d.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    code = ("import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from yardstick import cache; "
            "cache.build(json.loads(sys.argv[3]), sys.argv[4])")
    subprocess.run([sys.executable, "-c", code, str(BENCH), str(BENCH.parent),
                    json.dumps(cfg), str(tmp)], check=True)
    shutil.rmtree(d, ignore_errors=True)
    os.replace(tmp, d)
    return d, time.perf_counter() - t0


def build(cfg: dict, out: str) -> None:
    """Make the genome and the program's index into ``out`` (a child
    process)."""
    import numpy as np

    from yardstick.genome import codes_to_str, make_genome_codes

    spec = genome_spec(cfg)
    n = int(spec["length"])
    rng = np.random.default_rng(int(spec["seed"]))
    codes = make_genome_codes(
        rng, n, round(spec["tandem_arrays_per_100mb"] * n / 1e8),
        max(1, round(spec["segdups_per_100mb"] * n / 1e8)))
    os.makedirs(out, exist_ok=True)
    np.save(os.path.join(out, "genome.npy"), codes)
    seq = codes_to_str(codes)
    del codes
    from vacmap_tpu_torch.index.index import ReferenceIndex

    idx = ReferenceIndex.build({CONTIG: seq}, k=int(spec["k"]),
                               w=int(spec["w"]))
    idx.save(os.path.join(out, "port.vmi"))
    del idx
    with open(os.path.join(out, "done.json"), "w") as f:
        json.dump(spec, f)
