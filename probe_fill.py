#!/usr/bin/env python3
"""Time the full-width fill kernels on one CUDA card, whole and split:
this checkout's csrc/fill_full.cu and csrc/fill_scan.cu (with their
shared csrc/fill_rows.cuh) beside another tree's copies of them.

    python3 probe_fill.py [--other [NAME=]DIR ...] [--shapes 256x256,256x512]
                          [--reps 5]

DIR holds another tree's ``vacmap_tpu_torch/csrc`` (for example a parent
commit's, from ``git archive <commit> vacmap_tpu_torch/csrc | tar -x -C
DIR``); without ``--other`` only this checkout is timed.  For each tree
the two kernels are built, with the package's nvcc flags, into
``build/probe_fill/`` once as they are ("whole") and once per split or
alternative below that applies to the tree's design.  Each is a text
patch of a copy of the sources; the script stops if one does not apply
to this checkout, and leaves it out for another tree.  A split (no walk;
no walk and no cell bytes) gives wrong planes and op streams: it is a
timing only.  The other builds are held byte for byte to the plain
PyTorch versions at every shape.  Inputs are chip_smoke.py's realistic
fill jobs (a quarter to all of N long, 30% with a 96-200 bp indel, 5%
unrelated).  Each build is timed as device ms per call (CUDA events
around calls queued behind a GPU sleep), every build once in order and
once in reverse, and the two means are printed.  Every line carries the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs

HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "probe_fill"
SOURCES = ("fill_full.cu", "fill_scan.cu", "fill_rows.cuh")
# a line of fill_rows.cuh that names each design
DESIGNS = {"column_threads": "one thread per column",
           "wavefront": "anti-diagonal wavefront"}
# name -> {design: [(file, old text, new text), ...]}
VARIANTS = {
    "nowalk": {
        "column_threads": [
            ("fill_full.cu", "  if (t == 0) {\n    // row-run traceback",
             "  if (false) {\n    // row-run traceback"),
            ("fill_scan.cu", "  if (t == 0) {\n    int i = tl, j = ql, state = 0;",
             "  if (false) {\n    int i = tl, j = ql, state = 0;"),
        ],
        "wavefront": [
            ("fill_full.cu", "walk_rowruns(ring, tl", "if (0) walk_rowruns(ring, tl"),
            ("fill_scan.cu", "walk_ops(bitsb, tl", "if (0) walk_ops(bitsb, tl"),
        ],
    },
    "chain": {  # without the walk and without the cell bytes
        "column_threads": [
            ("fill_full.cu", "  if (t == 0) {\n    // row-run traceback",
             "  if (false) {\n    // row-run traceback"),
            ("fill_scan.cu", "  if (t == 0) {\n    int i = tl, j = ql, state = 0;",
             "  if (false) {\n    int i = tl, j = ql, state = 0;"),
            ("fill_rows.cuh", "    bitsb[(size_t)(i - 1) * N + t] = (uint8_t)bb;\n",
             ""),
        ],
        "wavefront": [
            ("fill_full.cu", "walk_rowruns(ring, tl", "if (0) walk_rowruns(ring, tl"),
            ("fill_scan.cu", "walk_ops(bitsb, tl", "if (0) walk_ops(bitsb, tl"),
            ("fill_rows.cuh", "  store_bytes<C>(tab + (i - 1) * N + j0, w,",
             "  if (0) store_bytes<C>(tab + (i - 1) * N + j0, w,"),
        ],
    },
    # alternatives of the wavefront design (outputs exact)
    "cols2": {  # two columns a lane: a warp per 64 columns
        "wavefront": [("fill_rows.cuh", "constexpr int kMaxCols = 4;",
                       "constexpr int kMaxCols = 2;")],
    },
}


SPLITS = ("nowalk", "chain")  # timings only: their outputs are wrong


def design_of(csrc: Path) -> str:
    text = (csrc / "fill_rows.cuh").read_text()
    found = [d for d, mark in DESIGNS.items() if mark in text]
    if len(found) != 1:
        cs.fail(f"{csrc}: fill_rows.cuh names no known design")
    return found[0]


def sources_of(tree: str, csrc: Path, variant: str, design: str):
    """{file: text} of one build, or None where the variant does not
    apply to the design."""
    texts = {f: (csrc / f).read_text() for f in SOURCES}
    if variant == "whole":
        return texts
    patches = VARIANTS[variant].get(design)
    if patches is None:
        return None
    for f, old, new in patches:
        if texts[f].count(old) != 1:
            if tree == "this":
                cs.fail(f"{tree} {variant}: patch does not apply to {f}: {old!r}")
            cs.say(f"{tree} {variant}: does not apply to {f}, not built")
            return None
        texts[f] = texts[f].replace(old, new)
    return texts


def build_all(builds, units=("fill_full.cu", "fill_scan.cu"),
              entries=("fill_full_launch", "fill_scan_launch"), out=OUT):
    """builds: {label: {file: text}} -> ({label: loaded ctypes library},
    [labels that failed to build]).  Every unit of every build compiles
    at once (one nvcc each, with the package's flags) under out/label,
    and each build's objects link into one library with ``entries``
    bound by their C signatures."""
    from vacmap_tpu_torch import _build

    shutil.rmtree(out, ignore_errors=True)
    nvcc = _build._nvcc()
    procs = {}
    for label, texts in builds.items():
        d = out / label
        d.mkdir(parents=True)
        for f, text in texts.items():
            (d / f).write_text(text)
        for f in units:
            procs[(label, f)] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(d / (f[:-3] + ".o")),
                 str(d / f)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {k: (p.communicate()[0], p.returncode) for k, p in procs.items()}
    libs, failed = {}, []
    for label in builds:
        bad = [(f, log) for f in units
               for log, rc in [logs[(label, f)]] if rc]
        if bad:  # the other builds are still timed; the run fails at its end
            cs.say(f"BUILD FAILED {label}/{bad[0][0]}:\n{bad[0][1][-3000:]}")
            failed.append(label)
            continue
        for f in units:
            for line in logs[(label, f)][0].splitlines():
                if "registers" in line or "spill" in line:
                    cs.say(f"ptxas {label}/{f}: {line.strip()}")
        d = out / label
        so = d / "libprobe.so"
        r = subprocess.run([nvcc, "-shared", "-o", str(so),
                            *(str(d / (f[:-3] + ".o")) for f in units)],
                           capture_output=True, text=True)
        if r.returncode:
            cs.fail(f"link failed for {label}: {r.stderr[-2000:]}")
        lib = ctypes.CDLL(str(so))
        for name in entries:
            getattr(lib, name).argtypes = _build._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        libs[label] = lib
    return libs, failed


def time_in_turns(torch, calls, reps):
    """calls: {label: fn} -> {label: [device ms a call, first pass, then
    the reverse pass]}: every call timed once in order and once in reverse
    (device ms per call, CUDA events around calls queued behind a GPU
    sleep), each after one warm-up call."""
    order = list(calls)
    times = {label: [] for label in order}
    for label in order + order[::-1]:
        calls[label]()  # warm-up
        times[label].append(cs.device_ms(torch, calls[label], reps))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="[NAME=]DIR", help="a directory holding another "
                    "tree's vacmap_tpu_torch/csrc (repeatable; NAME labels "
                    "it, default other)")
    ap.add_argument("--shapes", default="256x256,256x512",
                    help="comma-separated BxN launch shapes")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: no CUDA card")
    from vacmap_tpu_torch.ops import affine_fill as af

    card = subprocess.run(cs.SMI_QUERY, capture_output=True, text=True,
                          timeout=60).stdout.strip()
    cs.say(card)
    trees = {"this": HERE / "vacmap_tpu_torch" / "csrc"}
    for spec in args.other:
        name, _, d = spec.rpartition("=")
        trees[name or "other"] = Path(d).resolve() / "vacmap_tpu_torch" / "csrc"
    builds = {}
    for tree, csrc in trees.items():
        design = design_of(csrc)
        cs.say(f"{tree}: {csrc} ({design})")
        for variant in ("whole", *VARIANTS):
            texts = sources_of(tree, csrc, variant, design)
            if texts is not None:
                builds[f"{tree}_{variant}"] = texts
    libs, failed = build_all(builds)

    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    sc = (2, -4, 4, 2, 24, 1)
    rng = np.random.default_rng(cs.SEED + 8)
    gcodes = cs.make_genome_codes(rng, 4_000_000)
    wrong = []
    for shape in args.shapes.split(","):
        B, N = map(int, shape.split("x"))
        pairs = cs.fill_pairs(rng, gcodes, B, N // 4, N, big_indel=0.3,
                              random_frac=0.05)
        tT, tQ, lens = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in cs.padded(pairs, N))
        tl, ql = lens[:, 0].contiguous(), lens[:, 1].contiguous()
        bits = torch.empty((B, N, N), dtype=torch.uint8, device=dev)
        planes = torch.empty((B, 2 * N), dtype=torch.uint8, device=dev)
        packed = torch.empty((N // 2, B), dtype=torch.uint8, device=dev)

        def full(lib):
            return lib.fill_full_launch(tT.data_ptr(), tQ.data_ptr(),
                                        lens.data_ptr(), bits.data_ptr(),
                                        planes.data_ptr(), B, N, *sc, stream)

        def scan(lib):
            return lib.fill_scan_launch(tT.data_ptr(), tQ.data_ptr(),
                                        tl.data_ptr(), ql.data_ptr(),
                                        bits.data_ptr(), packed.data_ptr(), B,
                                        N, B, *sc, stream)

        want_planes = af.fill_rowruns_ref(tT, tQ, lens).cpu()
        want_packed = af.fill_traceback_ref(tT, tQ, tl, ql).cpu()
        cells = int((lens[:, 0].long() * lens[:, 1].long()).sum())
        cs.say(f"B={B} N={N}: {cells} cells [{card}]")
        for kname, fn, out, want in (("fill_full", full, planes, want_planes),
                                     ("fill_scan", scan, packed, want_packed)):
            order = []
            for label, lib in libs.items():
                rc = fn(lib)
                torch.cuda.synchronize()
                if rc:  # e.g. more shared memory than a block may have
                    cs.say(f"  {kname} {label} B={B} N={N}: launch refused, "
                           f"cudaError {rc}")
                    continue
                order.append(label)
                if label.split("_", 1)[1] not in SPLITS:
                    same = torch.equal(out.cpu(), want)
                    cs.say(f"  {kname} {label} B={B} N={N}: "
                           f"{'byte-identical to' if same else 'DIFFERS from'}"
                           " the plain version")
                    if not same:
                        wrong.append(f"{kname} {label} B={B} N={N}")
            times = time_in_turns(
                torch, {label: (lambda lib=libs[label]: fn(lib))
                        for label in order}, args.reps)
            for label in order:
                t = times[label]
                cs.say(f"  {kname} {label:20s} B={B} N={N}: "
                       f"{sum(t) / len(t):.4f} ms ({t[0]:.4f}, {t[1]:.4f}) "
                       f"[{card}]")
    if failed or wrong:
        cs.fail(f"builds that failed: {failed}; wrong results: {wrong}")
    print('{"ok": true}')
    return 0


if __name__ == "__main__":
    sys.exit(main())
