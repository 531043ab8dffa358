"""vacmap-tpu-torch command line (counterpart of ``vacmap_tpu/cli.py``).

Same flags as ``vacmap-tpu`` plus ``--device {cuda,cpu}``, routed by
``--backend`` as the reference routes them:

* ``--backend jax``: ``TorchBatchExecutor`` in this process.  Host
  seeding, then the chain DPs on the device and the base-level fills
  through the in-process fill service; SAM written in input order.
* otherwise (``auto``, the default, or ``numpy``) with ``-t 1``: one
  mapping loop in this process with a window of deferred reads, its fills
  sent to a device-owning fill service process.
* otherwise, ``-t N``: N forked mapping workers (``vacmap_tpu.cli``'s
  ``_worker`` and ``_writer``) share ONE device-owning fill service
  process, forked before them.  Only that process sets CUDA up.

``--device-fills off`` keeps every fill on the host (those two paths then
use no device); ``auto`` runs the service's start-up calibration and
stays on host fills when the device cannot beat them; ``on`` forces the
service.  A device error ends the run with a non-zero exit.  The index
is ``vacmap_tpu``'s own (built or loaded the same way, so one ``.vmi``
serves both packages).
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing as mp
import os
import queue
import sys
import time
from collections import deque
from typing import List, Optional

from vacmap_tpu.cli import (
    _dedup_records, _worker, _writer, build_parser, config_from_args,
    expand_read_paths, load_or_build_index,
)
from vacmap_tpu.io.sam_writer import OutputWriter
from vacmap_tpu.pipeline.extend import HostBatchFillAligner
from vacmap_tpu.pipeline.mapper import Mapper, PendingLines

from .device import DeviceKernelError, resolve_device

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


def _records(read_paths, cfg):
    for rec in _dedup_records(read_paths, cfg):
        yield (rec[0], rec[1], rec[2] if len(rec) > 2 else None,
               rec[3] if len(rec) > 3 else None)


def _service_error(handle) -> None:
    msg = handle.error() if handle is not None else None
    if msg is not None:
        raise DeviceKernelError(f"device fill service: {msg}")


def _run_executor(args, cfg, mapper, header, read_paths, device) -> int:
    from .pipeline.executor import TorchBatchExecutor

    ex = TorchBatchExecutor(mapper, device,
                            device_fills=args.device_fills != "off")
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
        ex.close()
    return count


def _run_single(args, cfg, mapper, header, read_paths, handle) -> int:
    """One mapping loop with a deferred window (the reference's -t 1)."""
    if handle is not None:
        mapper.global_aligner = handle.client(0)
    else:  # host deferred window: cross-read striped fill batches
        mapper.global_aligner = HostBatchFillAligner()
    window: deque = deque()
    max_window = int(os.environ.get("VACMAP_TPU_FILL_WINDOW", "32"))
    writer = OutputWriter(args.o, header)
    count = 0
    try:
        for name, seq, qual, comment in _records(read_paths, cfg):
            _service_error(handle)
            r = mapper.map_read_deferred(name, seq, qual, comment)
            if isinstance(r, PendingLines):
                window.append(r)
                r = window.popleft().finish() if len(window) >= max_window else None
            if r:
                writer.write_lines(r)
            count += 1
        while window:
            lines = window.popleft().finish()
            if lines:
                writer.write_lines(lines)
    finally:
        writer.close()
    return count


def _run_pool(args, cfg, index, header, read_paths, handle) -> int:
    """N forked mapping workers sharing one fill service process."""
    n_workers = max(cfg.threads, 1)
    ctx = mp.get_context("fork")
    raw_q = ctx.Queue(maxsize=n_workers * 200)
    cooked_q = ctx.Queue(maxsize=n_workers * 200)
    procs = [
        ctx.Process(target=_worker, name=f"worker-{i}",
                    args=(raw_q, cooked_q, index, cfg,
                          handle.client(i) if handle else None))
        for i in range(n_workers)
    ]
    procs.append(ctx.Process(target=_writer, name="writer",
                             args=(cooked_q, args.o, header, n_workers)))
    for p in procs:
        p.start()

    def check():
        _service_error(handle)
        for p in procs:
            if p.exitcode not in (None, 0):
                raise RuntimeError(f"{p.name} exited with code {p.exitcode}")

    def put(item):
        while True:
            try:
                raw_q.put(item, timeout=0.5)
                return
            except queue.Full:
                check()

    st = time.time()
    count = 0
    try:
        for rec in _records(read_paths, cfg):
            put(rec)
            count += 1
            check()
            if count % 100_000 == 0:
                log.info("%d reads queued (%.0f/s)", count,
                         count / max(time.time() - st, 1e-3))
        for _ in range(n_workers):
            put(0)
        for p in procs:
            while p.is_alive():
                p.join(timeout=0.5)
                check()
        check()
    except BaseException:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
        raise
    return count


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
    executor = args.backend == "jax"
    # the executor runs its kernels here; the other paths use the device
    # only in the fill service's process (resolve_device does not set
    # CUDA up, so the service can still do so after the fork)
    device = None
    if executor or args.device_fills != "off":
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

    handle = None
    if device is not None and not executor:
        # forked first, so its start-up overlaps the index load; until it
        # is ready the clients fill on the host (--device-fills on waits)
        from .parallel.fill_service import start_fill_server

        n_clients = max(cfg.threads, 1)
        handle = start_fill_server(n_clients, device, wait_ready=False,
                                   force=args.device_fills == "on")
        log.info("device fill service starting on %s (%d clients)", device,
                 n_clients)
    try:
        index = load_or_build_index(args.ref, args.k, args.w,
                                    not args.nowriteindex, lowmem=args.lowmem)
        mapper = Mapper(index, cfg)
        header = mapper.header_lines(cli=" ".join(sys.argv))
        st = time.time()
        if handle is not None and args.device_fills == "on":
            handle.wait_ready()
            log.info("device fill service ready %.1fs after the index load",
                     time.time() - st)
        if executor:
            how = f"the batched executor on {device}"
            count = _run_executor(args, cfg, mapper, header, read_paths, device)
        elif cfg.threads <= 1:
            how = "one worker"
            count = _run_single(args, cfg, mapper, header, read_paths, handle)
        else:
            how = f"{cfg.threads} fork workers"
            count = _run_pool(args, cfg, index, header, read_paths, handle)
    finally:
        msg = handle.stop() if handle is not None else None
    if msg is not None:
        raise DeviceKernelError(f"device fill service: {msg}")
    if handle is not None:
        how += f", fills served on {device}"
    dt = max(time.time() - st, 1e-3)
    log.info("Done: %d sequences with %s in %.1fs (%.1f/s)", count, how, dt,
             count / dt)
    if args.debug:
        from vacmap_tpu import trace

        log.info("stage timing:\n%s", trace.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
