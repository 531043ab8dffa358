#!/usr/bin/env python3
"""Time the banded affine DP kernel on one CUDA card: this checkout's
csrc/affine_band.cu beside another tree's copy of it.

    python3 probe_affine.py [--other [NAME=]DIR ...]
                            [--shapes g64x512x128,g64x4096x256,e64x8192x512,e64x32768x512,g16x128x32]
                            [--reps 5]

DIR holds another tree's ``vacmap_tpu_torch/csrc`` (for example a parent
commit's, from ``git archive <commit> vacmap_tpu_torch/csrc | tar -x -C
DIR``); without ``--other`` only this checkout is timed.  This checkout
is built twice: as it is ("this", the plane flushed by the bulk copy
engine) and with the flush patched to 16-byte stores by the warp
("this-st16").  Each build of ``affine_band.cu`` goes into
``build/probe_affine/TREE/`` with the package's nvcc flags (the ptxas
register and spill lines printed), and its machine code (cuobjdump
-sass) to ``affine_band.sass`` there (``--sass-dir`` copies it out), its
instruction count printed and, for each kernel instance, each loop's
instruction count, the issue stall cycles its control bits add up to
and its count of maxima, compares and selects (the half-rate pipe).
``--variants`` adds timing-only builds of this checkout (text patches;
their results are not held to anything).  A tree whose source takes dlo
as an input (before the kernel computed it) gets dlo from
``band_start``.  Shapes are ``{g|e}BxTxW`` (global, or
extension with chip_smoke.EXT_KW), from chip_smoke.band_pairs on the
probe's own 4 Mb genome.  Every build's six outputs are held to the plain
PyTorch version, planes byte for byte, at each shape and on
chip_smoke.band_edge_batches at each W.  Each build is timed as device
ms per call (CUDA events around calls queued behind a GPU sleep), every
build once in order and once in reverse, and the two means are printed.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs
import probe_fill as pf

HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "probe_affine"
SHAPES = "g64x512x128,g64x4096x256,e64x8192x512,e64x32768x512,g16x128x32"
# the plane's blocks leave the ring by 16-byte stores of the whole warp
# instead of the bulk copy engine (a build held to the plain version)
PLAIN_STORES = [
    ("""    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (t == 0) {""", """    __syncwarp();
    for (int o = 16 * t; o < n; o += 16 * 32)
      *reinterpret_cast<uint4*>(dst + o) =
          *reinterpret_cast<const uint4*>(src + o);
    if (false) {"""),
    ("    if (GLOB && t == 0)\n", "    if (false)\n"),
]
# timing-only variants of this checkout (wrong results): name -> text
# patches of affine_band.cu
VARIANTS = {
    # no hand-over between threads: each shuffle returns its own value,
    # so the time is the cells' issue alone, without the chain through
    # the shuffles
    "noshfl": [("namespace {\n",
                "namespace {\n#define __shfl_up_sync(m, v, d) (v)\n"
                "#define __shfl_down_sync(m, v, d) (v)\n")],
}
CLOCKS = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
          "--format=csv,noheader"]


def patched(text, patches):
    """text with each (old, new) replaced once; stops if one is missing."""
    for old, new in patches:
        if old not in text:
            cs.fail(f"patch does not apply to affine_band.cu: {old[:60]!r}")
        text = text.replace(old, new, 1)
    return text


def sass_loops(sass, min_len=60):
    """{kernel instance (K, glob): [(instructions, issue stall cycles,
    {opcode: count}), ...]} for the loops of each function in a
    ``cuobjdump -sass`` listing (a backward branch over at least min_len
    instructions), in address order.  The stall cycles are the
    scheduler's fixed waits, read from each instruction's control bits
    (bits 41-44 of its second word): a lower bound of a loop pass's
    cycles before any wait on a shuffle or a load."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        m = re.search(r"affine_band_kernelILi(\d+)ELb(\d)E", part)
        if not m:
            continue
        ins = []
        for a, text, ctrl in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+(.*?);\s*/\* 0x[0-9a-f]+ \*/\s*\n"
                r"\s*/\* (0x[0-9a-f]+) \*/", part):
            op = text.split()[1] if text.startswith("@") else text.split()[0]
            stall = (int(ctrl, 16) >> 41) & 15
            ins.append((int(a, 16), op.split(".")[0], stall, text))
        loops = []
        for a, op, _, text in ins:
            b = re.search(r"BRA\s+(?:!?U?P\d,\s*)?(0x[0-9a-f]+)", text)
            if op == "BRA" and b and int(b.group(1), 16) < a:
                body = [x for x in ins if int(b.group(1), 16) <= x[0] <= a]
                if len(body) >= min_len:
                    counts = {}
                    for x in body:
                        counts[x[1]] = counts.get(x[1], 0) + 1
                    loops.append((len(body), sum(x[2] for x in body), counts))
        out[(int(m.group(1)), m.group(2) == "1")] = loops
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="[NAME=]DIR", help="a directory holding another "
                    "tree's vacmap_tpu_torch/csrc (repeatable; NAME labels "
                    "it, default other)")
    ap.add_argument("--shapes", default=SHAPES,
                    help="comma-separated {g|e}BxTxW launch shapes")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", default="",
                    help="comma-separated timing-only variants of this "
                    f"checkout ({', '.join(VARIANTS)})")
    ap.add_argument("--sass-dir", default=None,
                    help="also copy each build's SASS listing here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: no CUDA card")
    from vacmap_tpu_torch import _build
    from vacmap_tpu_torch.ops import affine_batch as ab

    card = subprocess.run(cs.SMI_QUERY, capture_output=True, text=True,
                          timeout=60).stdout.strip()
    cs.say(card)
    this = (HERE / "vacmap_tpu_torch" / "csrc" / "affine_band.cu").read_text()
    builds = {"this": {"affine_band.cu": this},
              "this-st16": {"affine_band.cu": patched(this, PLAIN_STORES)}}
    timing_only = set()
    for name in filter(None, args.variants.split(",")):
        builds[name] = {"affine_band.cu": patched(this, VARIANTS[name])}
        timing_only.add(name)
    for spec in args.other:
        name, _, d = spec.rpartition("=")
        src = Path(d).resolve() / "vacmap_tpu_torch" / "csrc" / "affine_band.cu"
        cs.say(f"{name or 'other'}: {src}")
        builds[name or "other"] = {"affine_band.cu": src.read_text()}
    # a tree before the kernel computed dlo takes it as an input
    takes_dlo = {label: "dlo_out" not in texts["affine_band.cu"]
                 for label, texts in builds.items()}
    for label, texts in builds.items():
        digest = hashlib.sha256(texts["affine_band.cu"].encode()).hexdigest()
        cs.say(f"{label}: affine_band.cu sha256 {digest[:12]}")
    libs, failed = pf.build_all(builds, ("affine_band.cu",),
                                ("affine_band_launch",), OUT)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    for label in libs:
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(OUT / label / "affine_band.o")],
                              capture_output=True, text=True).stdout
        (OUT / label / "affine_band.sass").write_text(sass)
        if args.sass_dir:
            Path(args.sass_dir).mkdir(parents=True, exist_ok=True)
            (Path(args.sass_dir) / f"{label}.sass").write_text(sass)
        count = len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s", sass, re.M))
        cs.say(f"{label}: {count} SASS instructions in affine_band.o")
        alu = ("FMNMX", "FSEL", "FSETP", "SEL", "ISETP", "LOP3")
        for (K, glob), loops in sorted(sass_loops(sass).items()):
            cs.say(f"  {label} K={K} {'global' if glob else 'extension'}: "
                   "loops (instructions / issue stall cycles a pass; "
                   "maxima, compares, selects): " + ", ".join(
                       f"{n}/{st} ({sum(c.get(o, 0) for o in alu)})"
                       for n, st, c in loops))

    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    names = ("tb", "best", "best_i", "best_j", "dead", "dlo")

    def runner(lib, label, x, kw):
        """A launch of one build on x (targets, queries, t_len, q_len) with
        the call's keywords, and its six outputs."""
        B, T = x[0].shape
        Q = x[1].shape[1]
        W, glob = kw["W"], kw["glob"]
        sc = {k: kw.get(k, d) for k, d in (("match", 2), ("mismatch", -4),
                                            ("o1", 4), ("e1", 2), ("o2", 24),
                                            ("e2", 1), ("zdrop", -1))}
        tb = (torch.empty((B, T, W), dtype=torch.uint8, device=dev) if glob
              else torch.zeros(T, dtype=torch.uint8, device=dev))
        best = torch.empty(B, dtype=torch.float32, device=dev)
        bi, bj, dlo = (torch.empty(B, dtype=torch.int32, device=dev)
                       for _ in range(3))
        dead = torch.empty(B, dtype=torch.bool, device=dev)
        if takes_dlo[label]:
            dlo = ab.band_start(x[2], x[3], W)
            ptrs = (dlo, tb, best, bi, bj, dead)
        else:
            ptrs = (tb, best, bi, bj, dlo, dead)
        scores = [sc[k] for k in ("match", "mismatch", "o1", "e1", "o2", "e2",
                                  "zdrop")]

        def launch():
            return lib.affine_band_launch(
                *(a.data_ptr() for a in x), *(a.data_ptr() for a in ptrs),
                B, T, Q, W, int(glob), *scores, stream)

        return launch, (tb, best, bi, bj, dead, dlo)

    wrong = []

    def check(label, what, x, kw, want):
        launch, got = runner(libs[label], label, x, kw)
        rc = launch()
        torch.cuda.synchronize()
        if label in timing_only and not rc:
            return launch, []
        differ = ([f"cudaError {rc}"] if rc else
                  [n for n, g, w in zip(names, got, want)
                   if g.shape != w.shape or not torch.equal(g, w)])
        if differ:
            wrong.append(f"{label} {what}: {differ}")
        return launch, differ

    for W in ab.BAND_WIDTHS:
        for mode, (xn, kw, _) in cs.band_edge_batches(W).items():
            x = [torch.from_numpy(a).to(dev) for a in xn]
            want = ab.affine_batch_ref(*x, **kw)
            verdicts = [
                f"{label} " + ("DIFFERS" if check(
                    label, f"edge W={W} {mode}", x, kw, want)[1] else "equal")
                for label in libs if label not in timing_only]
            cs.say(f"edge W={W} {mode} ({len(xn[2])} pairs): "
                   f"{', '.join(verdicts)} [{card}]")

    rng = np.random.default_rng(cs.SEED + 12)
    gcodes = cs.make_genome_codes(rng, 4_000_000)
    for shape in args.shapes.split(","):
        glob = shape[0] == "g"
        B, T, W = map(int, shape[1:].split("x"))
        kw = (dict(W=W, glob=True, zdrop=-1) if glob
              else dict(cs.EXT_KW, W=W, glob=False))
        pairs = cs.band_pairs(rng, gcodes, B, T, W, not glob)
        tT, tQ, lens = cs.padded(pairs, T)
        x = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (tT, tQ, lens[:, 0], lens[:, 1])]
        want = ab.affine_batch_ref(*x, **kw)
        dead = want[4].cpu().numpy()
        rows = (np.full(B, T) if glob else np.where(
            dead, want[2].cpu().numpy() + 1, np.minimum(lens[:, 0], T)))
        cs.say(f"{shape}: {int(dead.sum())} pairs dropped, longest run "
               f"{int(rows.max())} rows [{card}]")
        calls = {}
        for label in libs:
            launch, differ = check(label, shape, x, kw, want)
            cs.say(f"  {label} {shape}: " + (
                "timing only" if label in timing_only else
                f"{'equal to' if not differ else 'DIFFERS from'} the plain "
                f"version{'' if not differ else f' in {differ}'}"))
            if not differ:
                calls[label] = launch
        times = pf.time_in_turns(torch, calls, args.reps)
        if calls:  # the card's clocks while this shape's launches run
            for _ in range(3 * args.reps):
                next(iter(calls.values()))()
            clocks = subprocess.run(CLOCKS, capture_output=True, text=True,
                                    timeout=60).stdout.strip()
            torch.cuda.synchronize()
            cs.say(f"  clocks.sm, clocks.max.sm under load: {clocks}")
        for label, t in times.items():
            ms = sum(t) / len(t)
            cs.say(f"  {label:10s} {shape}: {ms:.4f} ms ({t[0]:.4f}, "
                   f"{t[1]:.4f}); {ms * 1e6 / int(rows.max()):.1f} ns a row "
                   f"of the longest run [{card}]")
    if failed or wrong:
        cs.fail(f"builds that failed: {failed}; wrong results: {wrong}")
    print('{"ok": true}')
    return 0


if __name__ == "__main__":
    sys.exit(main())
