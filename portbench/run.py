"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  The cell, its configuration file, its
traffic mix (``portbench/traffic/<traffic>.json``) and its metrics are
read from ``BENCHMARK.json`` by name; a per-layer metric is the reader
``portbench/metrics/<name>.py``.  With ``--trace 0`` the last line of
standard output is the result with the cell's end-to-end metrics; with
``--trace 1`` the per-layer metrics, from a window under torch.profiler
and the benchmark's own spans.  The numbers that decide ``correct`` are
the last lines of standard error, each beside its limit.

Exits non-zero with no result when no CUDA card (or fewer than the cell
asks for) is visible, when the program is not beside ``portbench/``,
when the read pool runs dry, or when the JAX package, ``jax``,
``jaxlib`` or ``flax`` was loaded.  Every cache stays inside the
checkout (``portbench/.cache/``, ``build/``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def cell_spec(workload: str):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])

    def of_cell(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "cell": cell,
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "mix": json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                          .read_text()),
        "end_to_end": [m for m in spec["end_to_end"] if of_cell(m)],
        "per_layer": [m for m in spec["per_layer"] if of_cell(m)],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    import vacmap_tpu_torch  # noqa: F401  (the program, beside portbench/)
    # the caches of every kernel build, inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / ".cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BENCH / ".cache" / "triton")

    from yardstick.cell import forbidden_modules, prepare, run_cell

    prepared = prepare(spec["config"], spec["mix"], seed=args.seed,
                       seconds=args.seconds,
                       log=lambda m: print(m, file=sys.stderr, flush=True))
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    metrics = spec["end_to_end"] if not args.trace else spec["per_layer"]
    result, checks = run_cell(
        spec["config"], spec["mix"], seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device="cuda", prepared=prepared,
        per_layer=[m["name"] for m in spec["per_layer"]])
    units = {m["name"]: m["unit"] for m in metrics}
    out = {
        "correct": result["correct"],
        "attempted": result["attempted"],
        "failed": result["failed"],
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in result["metrics"].items() if k in units},
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": chips, **result["device"]},
    }
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["checks"] = checks  # last: the numbers compared, each beside its limit
    bad = forbidden_modules()  # the readers and the reference ran since
    if bad:
        print(f"modules loaded that the benchmark forbids: {bad}",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
