"""Run one cell several times, each run a process of its own, and print
each metric's median and spread (the distance between the first and
third quartiles as ``statistics.quantiles(values, n=4)`` gives them, as a
share of the median), and each run's checks.

    python3 portbench/spread.py --workload <name> --seeds 11,12,13 \
        --seconds 30 [--trace 0] [--out chiprun_out/<file>.jsonl]

It measures the spreads that set the bounds in BENCHMARK.json; the
benchmark's own runs never call it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    m = statistics.median(values)
    return (q3 - q1) / m if m else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", args.workload,
             "--seed", str(seed), "--seconds", str(args.seconds),
             "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.time() - t0
        err_tail = p.stderr.strip().splitlines()[-8:]
        try:
            res = json.loads(p.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            res = None
        rows.append({"seed": seed, "rc": p.returncode, "wall_s": wall,
                     "result": res, "stderr_tail": err_tail})
        vals = {k: v["value"] for k, v in (res or {}).get("metrics", {}).items()}
        print(f"seed {seed} rc {p.returncode} wall {wall:.1f} s "
              f"correct {res and res['correct']} "
              f"attempted {res and res['attempted']} {vals} "
              f"checks {res and res.get('checks')}", flush=True)
        for line in p.stderr.splitlines():
            if line.startswith(("window:", "reference:", "judge:",
                                "harness inputs")):
                print("  " + line, flush=True)
        if p.returncode or res is None:
            print("\n".join(p.stderr.strip().splitlines()[-40:]), flush=True)
        if args.out:
            with open(ROOT / args.out, "a") as f:
                f.write(json.dumps(rows[-1]) + "\n")
    ok = [r["result"] for r in rows if r["result"]]
    names = sorted({k for r in ok for k in r["metrics"]})
    for k in names:
        v = [r["metrics"][k]["value"] for r in ok if k in r["metrics"]]
        s = spread(v)
        print(f"{k}: n={len(v)} median={statistics.median(v)!r} "
              f"spread={s!r} values={v}")
    return 0 if len(ok) == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
