"""Readings that set the limits of ``correct``: for each seed, one run of
the cell on the card (set-up, a window of ``--seconds`` at the cell's own
load, the judged sample), its numbers as the benchmark's runs read them,
and the control's on the same sample: the plain DP put in the program's
place in bfloat16 on every judged piece, its path scored exactly
(``control_score_gap_per_kb``; it must read above the limit of
``score_gap_per_kb``).  With ``--faults`` each run instead has a fault
planted in the timed path (``plant_fault``), and must read not correct.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--seconds 20] [--faults half,stale,altered] \
        [--out chiprun_out/<file>.jsonl]

All seeds run in one process, so set-up is paid once for the card and
the library.  The benchmark's own runs never call it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as bench  # portbench/run.py: the cell's files by name


def plant_fault(name: str):
    """Break the executor's timed path one way; returns the undo.

    - ``stale``: each batch hands back the previous batch's records (a
      step that returns its state unchanged);
    - ``half``: every second read of a batch gets no records;
    - ``altered``: every record's position is one base off, as produced.
    """
    from vacmap_tpu_torch.pipeline.executor import TorchBatchExecutor

    attr = "_finish_read" if name == "altered" else "_run_prepared"
    orig = getattr(TorchBatchExecutor, attr)

    def stale(self, reads, prepped, n_threads):
        out = orig(self, reads, prepped, n_threads)
        prev = getattr(self, "_stale", [])
        self._stale = out
        return (prev + [[]] * len(out))[: len(out)]

    def half(self, reads, prepped, n_threads):
        out = orig(self, reads, prepped, n_threads)
        return [x if i % 2 == 0 else [] for i, x in enumerate(out)]

    def altered(self, *a):
        out = []
        for ln in orig(self, *a):
            f = ln.split("\t")
            f[3] = str(int(f[3]) + 1)
            out.append("\t".join(f))
        return out

    setattr(TorchBatchExecutor, attr,
            {"stale": stale, "half": half, "altered": altered}[name])
    return lambda: setattr(TorchBatchExecutor, attr, orig)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    spec = bench.cell_spec(args.workload)
    from yardstick.cell import prepare, run_cell

    limit = spec["config"]["check"]["limits"]["score_gap_per_kb"]
    faults = [f for f in args.faults.split(",") if f] or [None]
    for fault in faults:
        for seed in [int(s) for s in args.seeds.split(",")]:
            t0 = time.time()
            log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
            prepared = prepare(spec["config"], spec["mix"], seed=seed,
                               seconds=args.seconds, log=log)
            undo = plant_fault(fault) if fault else (lambda: None)
            try:
                result, checks = run_cell(
                    spec["config"], spec["mix"], seed=seed,
                    seconds=args.seconds, trace=False, device="cuda",
                    prepared=prepared, log=log, control=fault is None)
            finally:
                undo()
            line = {"workload": args.workload, "seed": seed, "fault": fault,
                    "correct": result["correct"],
                    "attempted": result["attempted"],
                    "judged": result["judged"], "seconds": time.time() - t0}
            if fault is None:
                line["control_fails"] = (
                    result["judged"]["control_score_gap_per_kb"] > limit)
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
