#!/usr/bin/env python3
"""Where the time goes on the vacmap_tpu_torch mode-H path, on one CUDA card.

    python3 profile_port.py [--runs 3]

On chip_smoke.py's corpus (the 100 Mb benchmark genome and its 272 reads
of 20 kb), after building the index once:
  1. throughput: the port's CLI (--device cuda) and the vacmap_tpu host
     path (--backend numpy --device-fills off), each run as a process of
     its own and timed from its start to its exit, alternating
     port, host, host, port, ... for --runs pairs; and the start-up part
     of that window: a process that only imports each side (and, for the
     port, sets up the CUDA context and loads the kernel library);
  2. breakdown: one more port run in this process under torch.profiler
     with the stage trace on (--debug): device time by kernel and copy,
     the device's busy share of that run's wall time, and the host
     stage spans summed over the finishing threads.
Every result line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

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
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: no CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from vacmap_tpu import trace
    from vacmap_tpu_torch import _build, cli

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
            "port": ["-m", "vacmap_tpu_torch.cli", *common, "--device", "cuda"],
            "host": ["-m", "vacmap_tpu.cli", *common, "--backend", "numpy",
                     "--device-fills", "off"],
        }
        startup = {
            "port": "import torch; torch.zeros(1, device='cuda'); "
                    "from vacmap_tpu_torch import _build, cli; _build.library()",
            "host": "import vacmap_tpu.cli",
        }
        for side, code in startup.items():
            dt, p = cs.cli_process(["-c", code], env)
            if p.returncode != 0:
                cs.fail(f"{side} start-up exited {p.returncode}: {p.stderr[-2000:]}")
            cs.say(f"start-up {side}: {dt:.3f} s [{card}]")
        order = [s for r in range(args.runs)
                 for s in (("port", "host") if r % 2 == 0 else ("host", "port"))]
        for k, side in enumerate(order):
            dt, p = cs.cli_process(
                [*sides[side], "-o", os.path.join(wd, f"{side}{k}.sam")], env)
            if p.returncode != 0:
                cs.fail(f"{side} CLI exited {p.returncode}: {p.stderr[-2000:]}")
            cs.say(f"process {side}: {dt:.3f} s = {bases / dt / 1e6:.4f} Mbp/s "
                   f"({len(reads)} reads, {bases} bp) [{card}]")

        trace.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rc = cli.main([*common, "--device", "cuda", "--debug",
                           "-o", os.path.join(wd, "profiled.sam")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if rc != 0:
            cs.fail(f"profiled port run exited {rc}")
    cs.say(f"profiled in-process run: wall {wall:.3f} s = "
           f"{bases / wall / 1e6:.4f} Mbp/s [{card}]")
    rows = sorted(device_events(torch, prof), key=lambda r: -r[2])
    busy = sum(us for _, _, us in rows) / 1e3
    for key, n, us in rows[:15]:
        cs.say(f"  device {us / 1e3:10.3f} ms  n={n:6d}  {key[:90]}")
    cs.say(f"device time (kernels and copies) {busy:.1f} ms of wall "
           f"{wall * 1e3:.1f} ms: busy share {busy / (wall * 1e3):.4f}")
    cs.say("host stage spans (summed over threads):\n" + trace.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
