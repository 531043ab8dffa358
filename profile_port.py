#!/usr/bin/env python3
"""Where the time goes on the vacmap_tpu_torch paths (mode H and asm), on one CUDA card.

    python3 profile_port.py [--runs 3] [--other DIR] [--startup-only]

On chip_smoke.py's corpus (the 100 Mb benchmark genome and its 272 reads
of 20 kb), after building the index once:
  1. throughput: five CLIs, each run as a process of its own and timed
     from its start to its exit, in turns for --runs rounds (the order
     reversed every other round): the port's host path (--backend
     numpy --device-fills off), the port's executor (--backend jax) and
     the port's default deployment (-t 4 fork workers, one CUDA fill
     service process, --device-fills on, its service stats line), and
     the last two again with VACMAP_TPU_EDIT_DEVICE=1 (the divergence
     filter's spans through the service's edit kind to the Myers kernel);
     and the start-up part of that window: processes that only import torch,
     only set the port up (torch import, CUDA context, kernel library),
     or only import the host path (which imports no torch); then
     chip_smoke.py's start-up processes (`import torch` alone, the host
     path, the asm host path and the fork pool with --device-fills on,
     each timed from start to exit with its torch imports recorded) and
     the executor (--backend jax) for --runs rounds, and with --other
     DIR the same processes of the checkout under DIR (e.g. the parent
     commit unpacked with `git archive` under build/) in turns with this
     one's: DIR, this, this, DIR for two rounds.  --startup-only stops
     there;
  2. breakdown: one more executor run in this process under
     torch.profiler with the stage trace on (--debug): device time by
     kernel and copy (in all and per launch), the device's busy share
     of that run's wall time, the chain kernel's launches by (variant,
     B, N), the banded and full-width fill kernels' launches by (B, T)
     and (B, N) with their device time a launch, and the host stage spans summed over the finishing
     threads; then
     the same with VACMAP_TPU_EDIT_DEVICE=1: device time by kernel, and
     the Myers kernel's launches by (B, T) with its device time a launch
     and each dispatch's longest text and largest pattern in 64-bit words;
  3. asm: chip_smoke.py's two contigs (2 Mb streaming, 480 kb per call)
     mapped by `-mode asm` as processes of their own for --runs rounds,
     host path and `--backend jax --device cuda` in turns (with --other
     DIR also DIR's `--backend jax --device cuda`, DIR, this, this, DIR),
     each with its chain device stats line (stream_device_s and, where
     the tree has them, its set-up, prepare, copy and kernel parts), then
     once in this process under torch.profiler: device time of the tiled
     chain kernel (in all and per launch) and of the copies, and its
     launches by (variant, B, N).
Every result line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import chip_smoke as cs


def device_events(torch, prof):
    """[(name, count, device us)] of the device-side events (kernels,
    copies, memsets) a torch.profiler run recorded."""
    out = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        out.append((ev.key, ev.count, us))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3,
                    help="port/host pairs of timed CLI processes")
    ap.add_argument("--other", help="a checkout whose start-up processes "
                    "are timed in turns with this one's")
    ap.add_argument("--startup-only", action="store_true",
                    help="stop after the start-up processes")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: no CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from vacmap_tpu_torch import _build, cli, trace
    from vacmap_tpu_torch.ops import affine_fill, chain, myers

    card = subprocess.run(cs.SMI_QUERY, capture_output=True, text=True,
                          timeout=60).stdout.strip()
    cs.say(card)
    _build.library()
    gcodes, reads = cs.make_corpus()
    bases = sum(len(c) for _, c in reads)
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")

    with tempfile.TemporaryDirectory(prefix="vacmap_profile_") as wd:
        ref, rds = os.path.join(wd, "ref.fa"), os.path.join(wd, "reads.fa")
        cs.write_fasta(ref, [("chr1", gcodes)])
        cs.write_fasta(rds, reads)
        cli.load_or_build_index(ref, 15, 10, True)
        common = ["-ref", ref, "-read", rds, "-mode", "H", "--force"]
        sides = {
            "host": ["-m", "vacmap_tpu_torch.cli", *common, "--backend", "numpy",
                     "--device-fills", "off"],
            "executor": ["-m", "vacmap_tpu_torch.cli", *common, "--backend",
                         "jax", "--device", "cuda"],
            "fork_pool": ["-m", "vacmap_tpu_torch.cli", *common, "-t", "4",
                          "--device", "cuda", "--device-fills", "on"],
        }
        startup = {
            "torch import": "import torch",
            "port": "import torch; torch.zeros(1, device='cuda'); "
                    "from vacmap_tpu_torch import _build, cli; _build.library()",
            "host": "import vacmap_tpu_torch.cli\n"
                    "assert 'torch' not in sys.modules",
        }
        for side, code in startup.items():
            dt, p = cs.cli_process(["-c", "import sys\n" + code], env)
            if p.returncode != 0:
                cs.fail(f"{side} start-up exited {p.returncode}: {p.stderr[-2000:]}")
            cs.say(f"start-up {side}: {dt:.3f} s [{card}]")
        contigs = cs.asm_contigs(np.random.default_rng(cs.SEED + 2), gcodes)
        ctg = os.path.join(wd, "contigs.fa")
        cs.write_fasta(ctg, contigs)
        trees = [("this tree", here)]
        other = None
        if args.other:
            other = os.path.abspath(args.other)
            # its own libraries, built before anything is timed
            p = subprocess.run(
                [sys.executable, "-c", "from vacmap_tpu_torch import _build, "
                 "native; _build.library(); assert native.available()"],
                cwd=other, env=dict(env, PYTHONPATH=other), capture_output=True,
                text=True, timeout=900)
            if p.returncode != 0:
                cs.fail(f"{other}: libraries did not build: {p.stderr[-2000:]}")
            trees.insert(0, ("other tree", other))
        # the executor too: its path changed only where the kernels launch
        procs = cs.STARTUP + (("executor", ["-mode", "H", "--backend", "jax",
                                            "--device", "cuda"],
                               ["MainProcess"]),)
        windows = cs.startup_windows(wd, ref, rds, ctg, env, card, trees,
                                     runs=args.runs, procs=procs)
        for name, argv, want in procs:
            for label, _ in trees:
                got = windows[(label, name)]
                cs.say(f"start-up windows, {label}, {name}: "
                       + " / ".join(f"{dt:.3f}" for dt, _ in got) + " s; torch "
                       f"imported by {got[0][1] or 'no process'} [{card}]")
            if any(loaded != want for _, loaded in windows[("this tree", name)]):
                cs.fail(f"start-up: {name} imported torch in "
                        f"{windows[('this tree', name)]}, expected "
                        f"{want or 'no process'}")
            if len(trees) > 1 and argv is not None:
                # the records, sorted (the fork pool writes them as its
                # workers finish); the header's @PG names the -o path
                recs = [sorted(ln for ln in open(cs.startup_sam(wd, lb, name))
                               if not ln.startswith("@")) for lb, _ in trees]
                cs.say(f"start-up {name}: {len(recs[-1])} records, equal in "
                       f"both trees: {recs[0] == recs[-1]}")
                if recs[0] != recs[-1]:
                    cs.fail(f"start-up {name}: the trees' records differ")
        if args.startup_only:
            return 0
        for side in ("executor", "fork_pool"):
            sides[f"{side}_edit"] = sides[side]
        order = [s for r in range(args.runs)
                 for s in (list(sides) if r % 2 == 0 else list(sides)[::-1])]
        stats_path = os.path.join(wd, "fill_stats.txt")
        for k, side in enumerate(order):
            penv = dict(env, VACMAP_TPU_FILL_STATS=stats_path)
            if side.endswith("_edit"):
                penv["VACMAP_TPU_EDIT_DEVICE"] = "1"
            dt, p = cs.cli_process(
                [*sides[side], "-o", os.path.join(wd, f"{side}{k}.sam")], penv)
            if p.returncode != 0:
                cs.fail(f"{side} CLI exited {p.returncode}: {p.stderr[-2000:]}")
            extra = ""
            if side != "host":  # both port deployments write the line
                extra = " service: " + open(stats_path).read().strip()
                extra += "".join(f"\n    {ln}" for ln in p.stderr.splitlines()
                                 if "fill service" in ln or "Done" in ln)
            cs.say(f"process {side}: {dt:.3f} s = {bases / dt / 1e6:.4f} Mbp/s "
                   f"({len(reads)} reads, {bases} bp) [{card}]{extra}")

        trace.reset()
        chain.chain_scores_batch.shapes.clear()
        affine_fill.fill_rowruns_banded.shapes.clear()
        affine_fill.fill_rowruns.shapes.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rc = cli.main([*common, "--backend", "jax", "--device", "cuda",
                           "--debug",
                           "-o", os.path.join(wd, "profiled.sam")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if rc != 0:
            cs.fail(f"profiled port run exited {rc}")
        spans = trace.summary()
        trace.enable(False)
        executor_shapes = dict(chain.chain_scores_batch.shapes)
        banded_shapes = dict(affine_fill.fill_rowruns_banded.shapes)
        full_shapes = dict(affine_fill.fill_rowruns.shapes)
        os.environ["VACMAP_TPU_EDIT_DEVICE"] = "1"
        # each edit launch's longest text and largest pattern in words
        edit_sizes = []
        dispatch = myers.TorchMyersAligner.dispatch_jobs

        def logged_dispatch(self, jobs, T, Wd):
            edit_sizes.append((len(jobs), T, max(len(t) for t, _ in jobs),
                               max((len(q) + 63) // 64 for _, q in jobs)))
            return dispatch(self, jobs, T, Wd)

        myers.TorchMyersAligner.dispatch_jobs = logged_dispatch
        myers.myers_distances.shapes.clear()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as edit_prof:
                t0 = time.perf_counter()
                rc = cli.main([*common, "--backend", "jax", "--device", "cuda",
                               "-o", os.path.join(wd, "profiled_edit.sam")])
                torch.cuda.synchronize()
                edit_wall = time.perf_counter() - t0
        finally:
            os.environ.pop("VACMAP_TPU_EDIT_DEVICE", None)
            myers.TorchMyersAligner.dispatch_jobs = dispatch
        edit_shapes = dict(myers.myers_distances.shapes)
        if rc != 0:
            cs.fail(f"profiled port run with the edit route exited {rc}")

        cbases = sum(len(c) for _, c in contigs)
        asm = ["-ref", ref, "-read", ctg, "-mode", "asm", "--force"]
        cuda = ["--backend", "jax", "--device", "cuda"]
        asm_sides = {"asm host": (here, ["--backend", "numpy"]),
                     "asm cuda": (here, cuda)}
        if other:
            asm_sides = {"asm cuda, other tree": (other, cuda), **asm_sides}
        asm_lines = []
        for r in range(args.runs):
            for side in (list(asm_sides) if r % 2 == 0 else list(asm_sides)[::-1]):
                root, argv = asm_sides[side]
                dt, p = cs.cli_process(
                    ["-m", "vacmap_tpu_torch.cli", *asm, *argv, "-o",
                     os.path.join(wd, f"asm{r}.sam")],
                    dict(env, PYTHONPATH=root), cwd=root)
                if p.returncode != 0:
                    cs.fail(f"{side} CLI exited {p.returncode}: {p.stderr[-2000:]}")
                stats = cs.log_stats(p.stderr, "asm chain device stats")
                asm_lines.append(
                    f"process {side}: {dt:.3f} s = {cbases / dt / 1e6:.4f} Mbp/s "
                    f"(mapping alone {cs.mapping_seconds(p.stderr):.1f} s; "
                    f"{len(contigs)} contigs, {cbases} bp) [{card}]"
                    + (f" {stats}" if stats else ""))
        for w in (chain.chain_scores_batch, chain.chain_scores_batch_warm):
            w.shapes.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as asm_prof:
            t0 = time.perf_counter()
            rc = cli.main([*asm, "--backend", "jax", "--device", "cuda",
                           "-o", os.path.join(wd, "asm_profiled.sam")])
            torch.cuda.synchronize()
            asm_wall = time.perf_counter() - t0
        if rc != 0:
            cs.fail(f"profiled asm run exited {rc}")
    cs.say(f"profiled in-process executor run: wall {wall:.3f} s = "
           f"{bases / wall / 1e6:.4f} Mbp/s [{card}]")
    rows = sorted(device_events(torch, prof), key=lambda r: -r[2])
    busy = sum(us for _, _, us in rows) / 1e3
    for key, n, us in rows[:15]:
        cs.say(f"  device {us / 1e3:10.3f} ms  n={n:6d}  "
               f"{us / 1e3 / max(n, 1):8.4f} ms a launch  {key[:90]}")
    cs.say(f"device time (kernels and copies) {busy:.1f} ms of wall "
           f"{wall * 1e3:.1f} ms: busy share {busy / (wall * 1e3):.4f}")
    cs.say(f"chain_dp launches by (variant, B, N), "
           f"{sum(executor_shapes.values())} in all: "
           + "; ".join(f"{v} B={b} N={n}: {k}" for (v, b, n), k
                       in sorted(executor_shapes.items())))
    for name, shapes, dim in (("fill_banded", banded_shapes, "T"),
                              ("fill_full", full_shapes, "N")):
        n = sum(shapes.values())
        us = sum(us for key, _, us in rows if name in key)
        cs.say(f"{name} launches by (B, {dim}), {n} in all, "
               f"{sum(b * k for (b, _), k in shapes.items())} jobs; device "
               f"{us / 1e3:.3f} ms, {us / 1e3 / max(n, 1):.4f} ms a launch: "
               + "; ".join(f"B={b} {dim}={t}: {k}" for (b, t), k
                           in sorted(shapes.items())))
    cs.say("host stage spans (summed over threads):\n" + spans)
    rows = sorted(device_events(torch, edit_prof), key=lambda r: -r[2])
    busy = sum(us for _, _, us in rows) / 1e3
    cs.say(f"profiled in-process executor run with the edit route: wall "
           f"{edit_wall:.3f} s [{card}]")
    for key, n, us in rows[:8]:
        cs.say(f"  device {us / 1e3:10.3f} ms  n={n:6d}  {key[:90]}")
    cs.say(f"device time (kernels and copies) {busy:.1f} ms of wall "
           f"{edit_wall * 1e3:.1f} ms: busy share {busy / (edit_wall * 1e3):.4f}")
    n = sum(edit_shapes.values())
    us = sum(us for key, _, us in rows if "myers" in key)
    cs.say(f"myers launches by (B, T), {n} in all (the service's prewarm "
           f"included), {sum(b * k for (b, _), k in edit_shapes.items())} "
           f"pairs; device {us / 1e3:.3f} ms, {us / 1e3 / max(n, 1):.4f} ms a "
           "launch: " + "; ".join(f"B={b} T={t}: {k}" for (b, t), k
                                   in sorted(edit_shapes.items())))
    for T in sorted({t for _, t, _, _ in edit_sizes}):
        sizes = sorted((n, w) for _, t, n, w in edit_sizes if t == T)
        cs.say(f"  T={T}: (longest text, largest pattern in 64-bit words) of "
               f"each of its {len(sizes)} dispatches: "
               + " ".join(f"({n},{w})" for n, w in sizes))
    for line in asm_lines:
        cs.say(line)
    rows = sorted(device_events(torch, asm_prof), key=lambda r: -r[2])
    busy = sum(us for _, _, us in rows) / 1e3
    cs.say(f"profiled in-process asm run: wall {asm_wall:.3f} s [{card}]")
    for key, n, us in rows[:8]:
        cs.say(f"  device {us / 1e3:10.3f} ms  n={n:6d}  "
               f"{us / 1e3 / max(n, 1):8.4f} ms a launch  {key[:90]}")
    cs.say(f"device time (kernels and copies) {busy:.1f} ms of wall "
           f"{asm_wall * 1e3:.1f} ms: busy share {busy / (asm_wall * 1e3):.4f}")
    for name, w in (("chain_dp", chain.chain_scores_batch),
                    ("chain_dp_large", chain.chain_scores_batch_warm)):
        cs.say(f"asm {name} launches by (variant, B, N), "
               f"{sum(w.shapes.values())} in all: "
               + "; ".join(f"{v} B={b} N={n}: {k}" for (v, b, n), k
                           in sorted(w.shapes.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
