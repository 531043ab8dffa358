#!/usr/bin/env python3
"""Time the Myers edit-distance kernel on one CUDA card: this checkout's
csrc/myers.cu beside another tree's copy of it.

    python3 probe_myers.py [--other [NAME=]DIR ...]
                           [--shapes 256x2048,64x8192,32x20480,3x2048,3x8192,3x20480]
                           [--reps 5]

DIR holds another tree's ``vacmap_tpu_torch/csrc`` (for example a parent
commit's, from ``git archive <commit> vacmap_tpu_torch/csrc | tar -x -C
DIR``); without ``--other`` only this checkout is timed.  Each tree's
``myers.cu`` is built with the package's nvcc flags into
``build/probe_myers/TREE/``, and its machine code (cuobjdump -sass) goes
to ``myers.sass`` there, its instruction count printed.  The shapes are
chip_smoke.py's: B pairs of one bucket (T = 2048, 8192 or 20480 text
columns, patterns up to 1.4 T) from chip_smoke.myers_pairs; the B = 3
shapes, the divergence filter's launch size, from the seed of
chip_smoke's B = 3 phases, in their order (on the probe's own 4 Mb
genome, so not the same pairs).  Every build's distances are held to
the plain PyTorch version (on the pairs chip_smoke holds: texts up to T,
or T / 2 at T = 20480 with B > 3) and to the native Myers on the pairs
without N, exactly.  Each build is timed as device ms per call (CUDA
events around calls queued behind a GPU sleep), every build once in
order and once in reverse, and the two means are printed with ns a
column of the longest text.  Every line carries the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs
import probe_fill as pf

HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "probe_myers"
BUCKET_WD = {2048: 128, 8192: 384, 20480: 896}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="[NAME=]DIR", help="a directory holding another "
                    "tree's vacmap_tpu_torch/csrc (repeatable; NAME labels "
                    "it, default other)")
    ap.add_argument("--shapes",
                    default="256x2048,64x8192,32x20480,3x2048,3x8192,3x20480",
                    help="comma-separated BxT launch shapes")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: no CUDA card")
    from vacmap_tpu_torch import _build, native
    from vacmap_tpu_torch.ops import myers

    card = subprocess.run(cs.SMI_QUERY, capture_output=True, text=True,
                          timeout=60).stdout.strip()
    cs.say(card)
    trees = {"this": HERE / "vacmap_tpu_torch" / "csrc"}
    for spec in args.other:
        name, _, d = spec.rpartition("=")
        trees[name or "other"] = Path(d).resolve() / "vacmap_tpu_torch" / "csrc"
    builds = {}
    for tree, csrc in trees.items():
        cs.say(f"{tree}: {csrc}")
        builds[tree] = {"myers.cu": (csrc / "myers.cu").read_text()}
    libs, failed = pf.build_all(builds, ("myers.cu",), ("myers_launch",), OUT)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    for label in libs:  # the kernel's machine code, for a count a step
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(OUT / label / "myers.o")],
                              capture_output=True, text=True).stdout
        (OUT / label / "myers.sass").write_text(sass)
        count = len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s", sass, re.M))
        cs.say(f"{label}: {count} SASS instructions in myers.o")

    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(cs.SEED + 10)
    rng_b3 = np.random.default_rng(cs.SEED + 9)  # chip_smoke's B = 3 pairs
    gcodes = cs.make_genome_codes(rng, 4_000_000)
    wrong = []
    for shape in args.shapes.split(","):
        B, T = map(int, shape.split("x"))
        Wd = BUCKET_WD[T]
        pairs = cs.myers_pairs(rng_b3 if B == 3 else rng, gcodes, T, Wd * 32, B)
        x = [torch.from_numpy(a).to(dev) for a in myers.pack_jobs(pairs, T, Wd)]
        W = x[1].shape[2]
        dist = torch.empty((B,), dtype=torch.int32, device=dev)
        n_max = T if (T <= 8192 or B == 3) else T // 2
        sub = [i for i, (t, _) in enumerate(pairs) if len(t) <= n_max]
        idx = torch.as_tensor(sub, device=dev)
        want = myers.myers_distances_ref(*(a[idx] for a in x)).cpu().numpy()
        clean = [i for i, (t, q) in enumerate(pairs)
                 if not ((t == 4).any() or (q == 4).any())]
        nat = [native.edit_distance_native(*pairs[i]) for i in clean]
        longest = max(len(t) for t, _ in pairs)
        words = sum(len(t) * ((len(q) + 63) // 64) for t, q in pairs)
        cs.say(f"B={B} T={T}: longest text {longest}, {words} word-steps, "
               f"{len(sub)} pairs held to the plain version, {len(clean)} to "
               f"the native Myers [{card}]")

        def launch(lib):
            return lib.myers_launch(*(a.data_ptr() for a in x),
                                    dist.data_ptr(), B, T, W, stream)

        order = []
        for label, lib in libs.items():
            rc = launch(lib)
            torch.cuda.synchronize()
            if rc:
                cs.say(f"  {label} B={B} T={T}: launch refused, cudaError {rc}")
                wrong.append(f"{label} B={B} T={T}")
                continue
            got = dist.cpu().numpy()
            same = (np.array_equal(got[sub], want)
                    and [int(got[i]) for i in clean] == nat)
            cs.say(f"  {label} B={B} T={T}: "
                   f"{'equal to' if same else 'DIFFERS from'} the plain "
                   "version and the native Myers")
            if not same:
                wrong.append(f"{label} B={B} T={T}")
            order.append(label)
        times = pf.time_in_turns(
            torch, {label: (lambda lib=libs[label]: launch(lib))
                    for label in order}, args.reps)
        for label in order:
            t = times[label]
            ms = sum(t) / len(t)
            cs.say(f"  {label:8s} B={B} T={T}: {ms:.4f} ms ({t[0]:.4f}, "
                   f"{t[1]:.4f}); {ms * 1e6 / longest:.1f} ns a column of "
                   f"the longest text [{card}]")
    if failed or wrong:
        cs.fail(f"builds that failed: {failed}; wrong results: {wrong}")
    print('{"ok": true}')
    return 0


if __name__ == "__main__":
    sys.exit(main())
