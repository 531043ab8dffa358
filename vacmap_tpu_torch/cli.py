"""vacmap-tpu-torch command line: the batched mapping executor on one
torch device (counterpart of the ``--backend jax`` branch of
``vacmap_tpu/cli.py``).

Same flags as ``vacmap-tpu`` plus ``--device {cuda,cpu}``.  Reads stream
through ``TorchBatchExecutor``: host seeding, the chain DPs and the
base-level fills on the device, SAM written in input order.  The index
is ``vacmap_tpu``'s own (built or loaded the same way, so one ``.vmi``
serves both packages).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import time
from typing import List, Optional

from vacmap_tpu.cli import (
    _dedup_records, build_parser, config_from_args, expand_read_paths,
    load_or_build_index,
)
from vacmap_tpu.io.sam_writer import OutputWriter
from vacmap_tpu.pipeline.mapper import Mapper

from .device import resolve_device

log = logging.getLogger("vacmap_tpu_torch")

NOT_PORTED = "not yet ported to vacmap_tpu_torch (see ROADMAP.md)"


def parser():
    p = build_parser()
    p.prog = "vacmap-tpu-torch"
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device for the chain DP and fill kernels "
                        "(cuda: the hand-written kernels; cpu: their plain "
                        "PyTorch versions)")
    return p


def _unported(args) -> Optional[str]:
    if args.mode == "asm":
        return "-mode asm"
    if args.num_processes is not None and args.num_processes > 1:
        return "--num-processes > 1"
    if args.coordinator:
        return "--coordinator"
    return None


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        format="%(levelname)s: %(asctime)s %(message)s",
        datefmt="%m/%d/%Y %I:%M:%S %p",
        level=logging.INFO,
    )
    raw = list(sys.argv[1:] if argv is None else argv)
    if "--prewarm" in raw:
        raise SystemExit(f"ERROR: --prewarm is {NOT_PORTED}")
    args = parser().parse_args(raw)
    what = _unported(args)
    if what is not None:
        raise SystemExit(f"ERROR: {what} is {NOT_PORTED}")
    device = resolve_device(args.device)
    if args.debug:
        from vacmap_tpu import trace

        trace.enable()
    # the Mapper's own "jax" hooks must stay off: the chain and fill
    # backends are this package's
    cfg = dataclasses.replace(config_from_args(args), backend="numpy")
    read_paths = expand_read_paths(args.read)
    for f in read_paths:
        if not os.path.isfile(f):
            log.error("Read file not found: %s", f)
            return 1
    if not os.path.isfile(args.ref) and not os.path.isdir(args.ref):
        log.error("Reference file not found: %s", args.ref)
        return 1
    if args.o != "-":
        if not (args.o.endswith(".sam") or args.o.endswith(".bam")):
            raise ValueError("Output must end with .sam/.bam/.sorted.bam or '-'")
        if os.path.isfile(args.o) and not args.force:
            raise ValueError("Output file exists; use --force to overwrite")

    from .pipeline.executor import TorchBatchExecutor

    index = load_or_build_index(args.ref, args.k, args.w,
                                not args.nowriteindex, lowmem=args.lowmem)
    mapper = Mapper(index, cfg)
    header = mapper.header_lines(cli=" ".join(sys.argv))
    ex = TorchBatchExecutor(mapper, device,
                            device_fills=args.device_fills != "off")
    st = time.time()
    count = 0

    def counted():
        nonlocal count
        for rec in _dedup_records(read_paths, cfg):
            count += 1
            yield rec

    writer = OutputWriter(args.o, header)
    try:
        for lines in ex.map_stream(counted(), cfg.batch_reads,
                                   n_threads=cfg.threads):
            if lines:
                writer.write_lines(lines)
    finally:
        writer.close()
    dt = max(time.time() - st, 1e-3)
    log.info("Done: %d sequences on %s in %.1fs (%.1f/s)", count, device, dt,
             count / dt)
    if args.debug:
        from vacmap_tpu import trace

        log.info("stage timing:\n%s", trace.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
