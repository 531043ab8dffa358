"""vacmap-tpu-torch command line (counterpart of ``vacmap_tpu/cli.py``).

Same flags as ``vacmap-tpu`` plus ``--device {cuda,cpu}``, routed by
``--backend`` as the reference routes them:

* ``--backend jax``: ``TorchBatchExecutor`` in this process.  Host
  seeding, then the chain DPs on the device and the base-level fills
  through the in-process fill service; SAM written in input order.
* otherwise (``auto``, the default, or ``numpy``) with ``-t 1``: one
  mapping loop in this process with a window of deferred reads, its fills
  sent to a device-owning fill service process.
* otherwise, ``-t N``: N forked mapping workers share ONE device-owning
  fill service process, forked before them.  Only that process sets CUDA
  up.
* ``-mode asm``: one worker and no fill service (contigs are huge and
  their fills stay on the host).  With ``--backend jax`` the chain DPs
  run on the device: per call for contigs under 500 kb, and per 100 kb
  anchor block with the carried frontier for the streaming chain of
  larger ones; otherwise the host DP.

``--num-processes N --process-id i``: process i maps every N-th read
(after de-duplication; whole files when there are at least N of them)
into ``<out>.part{i}``, and process 0 merges the parts into ``-o`` once
every part is done.  ``--coordinator host:port`` also joins the
processes in a gloo process group first (``parallel/mesh.py``).

``--device-fills off`` keeps every fill on the host (the non-executor
read paths then use no device); ``auto`` runs the service's start-up
calibration and stays on host fills when the device cannot beat them;
``on`` forces the service.  A device error ends the run with a non-zero
exit.  The index format is the reference's, so one ``.vmi`` serves both
packages.

As the reference's CLI imports only host modules at its top, this one
loads torch only in the processes that launch a kernel: the executor,
asm with ``--backend jax``, and the fill service's own process.  The
host path, the asm host path and the fork pool's parent and workers
never import it; ``--coordinator`` does (the gloo group is
``torch.distributed``).
"""

from __future__ import annotations

import argparse
import glob as globmod
from hashlib import blake2b as _blake2b
import logging
import multiprocessing as mp
import os
import queue
import shutil
import sys
import threading
import time
from collections import deque
from typing import List, Optional

from . import trace
from .config import AlignerConfig
from .errors import DeviceKernelError
from .index.index import ReferenceIndex
from .io.fastx import fastx_read
from .io.merge_parts import finish_multihost
from .io.sam_writer import OutputWriter
from .pipeline.extend import HostBatchFillAligner
from .pipeline.mapper import Mapper, PendingLines

log = logging.getLogger("vacmap_tpu_torch")

RG_TAGS = ["id", "sm", "lb", "pl", "ds", "dt", "pu", "pi", "pg", "cn", "fo", "ks", "pm", "bc"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vacmap-tpu-torch",
        description="vacmap-tpu on PyTorch and CUDA: long-read aligner for "
        "structural variation discovery",
        formatter_class=argparse.RawTextHelpFormatter,
    )
    req = p.add_argument_group("Required Arguments")
    req.add_argument("-ref", required=True, help="Reference FASTA or .vmi index")
    req.add_argument("-read", required=True, nargs="+", action="append",
                     help="Read file(s); wildcards supported")
    req.add_argument("-mode", required=True, choices=["H", "L", "S", "R", "asm"],
                     help="H: noisy long reads (ONT/CLR)\nL: HiFi\nS: sensitive\n"
                          "R: no-prefer-closer\nasm: assembly")
    out = p.add_argument_group("Output Arguments")
    out.add_argument("-o", default="-", help="Output (- | .sam | .bam | .sorted.bam)")
    out.add_argument("--force", action="store_true")
    out.add_argument("--nowriteindex", action="store_true")
    out.add_argument("--lowmem", action="store_true",
                     help="force the bounded-memory external-sort "
                          "index build (auto for references >= 1 Gb)")
    out.add_argument("--prewarm", action="store_true",
                     help="build the kernel and host libraries and launch "
                          "every kernel once per shape family on --device, "
                          "then exit")
    par = p.add_argument_group("Alignment Parameters")
    par.add_argument("-t", type=int, default=4, help="Threads (default 4)")
    par.add_argument("-k", type=int, default=15)
    par.add_argument("-w", type=int, default=10)
    par.add_argument("-c", type=int, default=100, help="Top N clusters")
    par.add_argument("-maxdivergence", type=float)
    pen = p.add_argument_group("Penalties")
    pen.add_argument("-globalpenalty", type=float)
    pen.add_argument("-localpenalty", type=float)
    pen.add_argument("-globalmaxdiff", type=int, default=50)
    pen.add_argument("-localmaxdiff", type=int, default=30)
    fl = p.add_argument_group("Flags")
    fl.add_argument("--eqx", action="store_true")
    fl.add_argument("--MD", action="store_true")
    fl.add_argument("--cs", nargs="?", const="short", default=None)
    fl.add_argument("--L", action="store_true", dest="cigar2cg")
    fl.add_argument("--markunbalancetra", action="store_true", default=None)
    fl.add_argument("--nodiscard", action="store_true", default=None)
    fl.add_argument("--copycomments", action="store_true")
    fl.add_argument("--H", action="store_true", dest="hardclip")
    fl.add_argument("--fakecigar", action="store_true")
    fl.add_argument("--Q", action="store_true", dest="ignore_quals")
    fl.add_argument("--debug", action="store_true")
    fl.add_argument("-workdir", help="Working directory (asm mode)")
    fl.add_argument("--backend", choices=["auto", "jax", "numpy"], default="auto",
                    help="jax (the reference's name for its device "
                         "deployment): the batched executor, in -mode asm "
                         "the chain DP kernels, on --device; otherwise the "
                         "host chain DP")
    fl.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="torch device for the chain DP and fill kernels "
                         "(cuda: the hand-written kernels; cpu: their plain "
                         "PyTorch versions)")
    fl.add_argument("--batch-reads", type=int, default=64)
    fl.add_argument("--device-fills", nargs="?", const="on",
                    choices=["auto", "on", "off"], default="auto",
                    help="run base-level CIGAR fills on the device (async "
                         "pipelined fill service). auto (default): the "
                         "service's start-up calibration decides; on: "
                         "always; off: host C++ kernels only")
    mh = p.add_argument_group("Multi-host")
    mh.add_argument("--coordinator",
                    help="host:port of process 0: join a gloo process group "
                         "before mapping")
    mh.add_argument("--num-processes", type=int)
    mh.add_argument("--process-id", type=int)
    rg = p.add_argument_group("Read-group (RG) metadata")
    for tag in RG_TAGS:
        rg.add_argument(f"--rg-{tag}", dest=f"rg_{tag}")
    return p


def config_from_args(args) -> AlignerConfig:
    rg_extra = {t: getattr(args, f"rg_{t}") for t in RG_TAGS if getattr(args, f"rg_{t}", None)}
    if rg_extra and "id" not in rg_extra:
        raise ValueError("--rg-id is required when any other --rg-* option is supplied")
    return AlignerConfig(
        mode=args.mode,
        kmersize=args.k,
        window=args.w,
        check_num=args.c,
        global_maxdiff=args.globalmaxdiff,
        local_maxdiff=args.localmaxdiff,
        global_skipcost=args.globalpenalty,
        local_skipcost=args.localpenalty,
        max_divergence=args.maxdivergence,
        markunbalancetra=args.markunbalancetra,
        nodiscard=args.nodiscard,
        eqx=args.eqx,
        md=args.MD,
        cs=args.cs is not None,
        shortcs=args.cs != "long",
        cigar2cg=args.cigar2cg,
        hardclip=args.hardclip,
        fakecigar=args.fakecigar,
        copycomments=args.copycomments,
        ignore_quals=args.ignore_quals,
        rg_id=rg_extra.get("id", "1") if (rg_extra or True) else None,
        threads=args.t,
        batch_reads=args.batch_reads,
        backend=args.backend,
        debug=args.debug,
        workdir=args.workdir,
    )


def expand_read_paths(read_args) -> List[str]:
    raw = [x for sub in read_args for x in sub]
    out = []
    for s in raw:
        if any(ch in s for ch in "*?[]"):
            hits = globmod.glob(s)
            out.extend(hits if hits else [s])
        else:
            out.append(s)
    return out


def load_or_build_index(refpath: str, k: int, w: int, write_index: bool,
                        lowmem: bool = False) -> ReferenceIndex:
    if refpath.endswith(".vmi.npz") or refpath.endswith(".vmi"):
        try:
            return ReferenceIndex.load(refpath,
                                       in_ram=False if lowmem else None)
        except (FileNotFoundError, ValueError) as e:
            raise SystemExit(f"ERROR: not a valid .vmi index: {refpath} ({e})")
    index_name = f"{refpath}.w{w}_k{k}.vmi"
    if os.path.isdir(index_name) or os.path.isfile(index_name + ".npz"):
        log.info("Loading index %s", index_name)
        return ReferenceIndex.load(
            index_name if os.path.isdir(index_name) else index_name + ".npz",
            in_ram=False if lowmem else None,
        )
    log.info("Building index for %s (k=%d w=%d)", refpath, k, w)
    # genome-scale references: stream contigs through the external-sort
    # build straight into the .vmi directory — the genome is never held
    # in Python strings and peak RSS stays bounded by the sketch chunk.
    # Heuristic: on-disk FASTA size (gz assumed ~4x compressed).
    fsize = os.path.getsize(refpath)
    approx = fsize * 4 if refpath.endswith(".gz") else fsize
    # in-RAM native build peak is ~8 B/bp (strings + codes + int64 table
    # temporaries); take the external bounded-memory build only when
    # that wouldn't comfortably fit, or on explicit --lowmem
    try:
        avail = (os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError):
        avail = 0
    fits_ram = approx * 8 < avail // 2
    if write_index and (lowmem or (approx >= (1 << 30) and not fits_ram)):
        idx = ReferenceIndex.build_external(
            ((r[0], r[1]) for r in fastx_read(refpath)), index_name, k=k, w=w
        )
        log.info("Saved index to %s (external build)", index_name)
        return idx
    contigs = {}
    for rec in fastx_read(refpath):
        contigs[rec[0]] = rec[1]
    idx = ReferenceIndex.build(contigs, k=k, w=w)
    if write_index:
        idx.save(index_name)
        log.info("Saved index to %s", index_name)
    return idx


def _read_records(path: str, cfg):
    """Dispatch FASTX vs BAM input (io.bam_reader for the latter)."""
    if path.endswith(".bam"):
        from .io.bam_reader import read_bam

        yield from read_bam(path)
    else:
        yield from fastx_read(path, read_comment=cfg.copycomments)


def _dedup_records(paths, cfg, shard=(0, 1)):
    """Records across all read files, de-duplicated by name hash exactly
    like the reference main loop (vacmap:430-517) — shared by every
    execution branch (single-worker, multiprocess, and batched executor).

    ``shard = (process_id, num_processes)``: in a multi-host run every
    process reads the same inputs; de-duplication happens first (it is
    input-order deterministic, so consistent across processes) and the
    surviving records round-robin over processes — the multi-host analog
    of the reference's queue-pull data parallelism (vacmap:390-420)."""
    pid, n_proc = shard
    if n_proc > 1 and len(paths) >= n_proc:
        # enough input files: shard whole FILES so each host parses only
        # ~1/N of the input bytes (a multi-host run over the reference's
        # own 170 GB workload otherwise parses everything N times).
        # Dedup is per-process here; duplicate read names split across
        # different hosts' files are not cross-deduplicated (the
        # round-robin path below keeps the reference's global-dedup
        # semantics when that matters).
        mine = paths[pid::n_proc]
        log.info("process %d/%d reads %d/%d input files", pid, n_proc,
                 len(mine), len(paths))
        paths, pid, n_proc = mine, 0, 1
    seen = set()
    i = 0
    for path in paths:
        log.info("Reading %s", path)
        for rec in _read_records(path, cfg):
            # process-stable 64-bit hash: builtin hash() is randomized per
            # process (PYTHONHASHSEED), so a collision would be process-
            # specific and silently desynchronize the multi-host
            # round-robin counter — blake2b keys identically everywhere
            h = _blake2b(rec[0].encode(), digest_size=8).digest()
            if h in seen:
                continue
            seen.add(h)
            take = (i % n_proc) == pid
            i += 1
            if take:
                yield rec


def _worker_loop(raw_q, cooked_q, mapper, cfg, use_async: bool):
    """One mapping thread: pulls reads, emits SAM line batches."""
    map_fn = mapper.map_contig if cfg.mode == "asm" else mapper.map_read
    batch: List[str] = []
    chars = 0

    def emit(lines):
        nonlocal batch, chars
        for l in lines:
            chars += len(l)
        batch.extend(lines)
        if chars > 2_000_000:
            cooked_q.put(batch)
            batch, chars = [], 0

    # async deployment: keep a window of reads whose device fill batches
    # are in flight; host stages of later reads overlap the device round
    # trips
    window = deque()
    max_window = int(os.environ.get("VACMAP_TPU_FILL_WINDOW", "32"))
    while True:
        item = raw_q.get()
        if isinstance(item, int):
            raw_q.put(item)  # release sibling threads of this worker
            break
        name, seq, qual, comment = item
        if use_async:
            r = mapper.map_read_deferred(name, seq, qual, comment)
            if isinstance(r, PendingLines):
                window.append(r)
                if len(window) >= max_window:
                    emit(window.popleft().finish())
            else:
                emit(r)
        else:
            emit(map_fn(name, seq, qual, comment))
    while window:
        emit(window.popleft().finish())
    if batch:
        cooked_q.put(batch)


def _worker(raw_q, cooked_q, index, cfg, fill_client=None):
    use_async = fill_client is not None and cfg.mode != "asm"
    host_defer = fill_client is None and cfg.mode != "asm"
    # with the device service attached, each worker process runs a
    # second mapping thread: blocking device waits (divergence edit
    # batches, non-deferred fills) overlap the sibling's host stages.
    # Host-only workers stay single-threaded (GIL: no host win) but use
    # the same deferred window so the striped fill kernel sees
    # cross-read batches (HostBatchFillAligner).
    n_threads = int(os.environ.get(
        "VACMAP_TPU_WORKER_THREADS", "2" if use_async else "1"
    ))
    mappers = []
    for _ in range(max(n_threads, 1)):
        m = Mapper(index, cfg)
        if use_async:
            m.global_aligner = fill_client
        elif host_defer:
            m.global_aligner = HostBatchFillAligner()
        mappers.append(m)
    use_async = use_async or host_defer
    if len(mappers) == 1:
        _worker_loop(raw_q, cooked_q, mappers[0], cfg, use_async)
    else:
        ts = [
            threading.Thread(
                target=_worker_loop,
                args=(raw_q, cooked_q, m, cfg, use_async),
            )
            for m in mappers
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    cooked_q.put(1)  # per-worker done sentinel


def _writer(cooked_q, path, header, n_workers: int):
    # the writer is constructed HERE, in the writer process: building it
    # pre-fork leaves the header in a buffered handle that every forked
    # process flushes at exit (duplicate headers in the output)
    writer = OutputWriter(path, header)
    done = 0
    while done < n_workers:
        item = cooked_q.get()
        if isinstance(item, int):
            done += 1
            continue
        if item:
            writer.write_lines(item)
    writer.close()


def _records(read_paths, cfg, shard):
    for rec in _dedup_records(read_paths, cfg, shard=shard):
        yield (rec[0], rec[1], rec[2] if len(rec) > 2 else None,
               rec[3] if len(rec) > 3 else None)


def _service_error(handle) -> None:
    msg = handle.error() if handle is not None else None
    if msg is not None:
        raise DeviceKernelError(f"device fill service: {msg}")


def _run_executor(args, cfg, mapper, header, read_paths, device,
                  shard) -> int:
    from .ops.chain import chain_scores_batch
    from .pipeline.executor import TorchBatchExecutor

    ex = TorchBatchExecutor(mapper, device,
                            device_fills=args.device_fills != "off")
    count = 0

    def counted():
        nonlocal count
        for rec in _dedup_records(read_paths, cfg, shard=shard):
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
    # the global chains the executor launched or left to the host, and
    # the jobs of its aggregating backend (local re-chains, and the
    # global chains of the reads the executor left)
    counts = " ".join(
        f"{name}_chained={c.chained} " + " ".join(
            f"{name}_declined_{why}={n}" for why, n in c.declined.items())
        for name, c in (("global", ex), ("backend", mapper.chain_backend)))
    log.info("executor chain device stats: chain_launches=%d "
             "refund_launches=%d %s", chain_scores_batch.launches,
             sum(k for (v, _, _), k in chain_scores_batch.shapes.items()
                 if v == "refund"), counts)
    return count


def _run_single(args, cfg, mapper, header, read_paths, handle,
                shard) -> int:
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
        for name, seq, qual, comment in _records(read_paths, cfg, shard):
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


def _run_pool(args, cfg, index, header, read_paths, handle, shard) -> int:
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
        for rec in _records(read_paths, cfg, shard):
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


def _run_asm(args, mapper, header, read_paths, shard) -> int:
    """-mode asm: one worker, contig by contig, fills on the host."""
    cfg = mapper.config
    writer = OutputWriter(args.o, header)
    count = 0
    try:
        for name, seq, qual, comment in _records(read_paths, cfg, shard):
            lines = mapper.map_contig(name, seq, qual, comment)
            if lines:
                writer.write_lines(lines)
            count += 1
    finally:
        writer.close()
    be = mapper.stream_backend
    if be is not None:
        from .ops.chain import chain_scores_batch, chain_scores_batch_warm

        log.info(
            "asm chain device stats: stream_calls=%d stream_engaged=%d "
            "stream_rows=%d stream_max_rows=%d "
            "declined_variant=%d declined_size=%d declined_coords=%d "
            "stream_device_s=%.6f setup_s=%.6f prep_s=%.6f copy_s=%.6f "
            "kernel_s=%.6f chain_launches=%d warm_launches=%d",
            be.calls, be.engaged, be.rows, be.max_rows,
            be.declined["variant"],
            be.declined["size"], be.declined["coords"], be.device_s,
            be.setup_s, be.prep_s, be.copy_s, be.kernel_s,
            chain_scores_batch.launches, chain_scores_batch_warm.launches)
    return count


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        format="%(levelname)s: %(asctime)s %(message)s",
        datefmt="%m/%d/%Y %I:%M:%S %p",
        level=logging.INFO,
    )
    raw = list(sys.argv[1:] if argv is None else argv)
    if "--prewarm" in raw:
        # build the libraries and launch every kernel once per shape
        # family on --device, then exit (python -m vacmap_tpu_torch.prewarm)
        from . import prewarm

        dev = raw[raw.index("--device") + 1] if "--device" in raw[:-1] else "cuda"
        return prewarm.main(["--all", "--device", dev])
    args = build_parser().parse_args(raw)
    # multi-host read sharding works with or without a process group
    n_proc = args.num_processes or 1
    proc_id = args.process_id or 0
    if not 0 <= proc_id < n_proc:
        raise SystemExit(f"ERROR: --process-id {proc_id} is not in "
                         f"[0, --num-processes {n_proc})")
    shard = (proc_id, n_proc)
    final_out = args.o
    if n_proc > 1 and args.o != "-":
        # per-process parts on the shared output directory; process 0
        # merges them into the single file once every part's .done
        # sentinel appears (io/merge_parts.py)
        base, ext = args.o, ""
        for suffix in (".sorted.bam", ".sam", ".bam"):
            if args.o.endswith(suffix):
                base, ext = args.o[: -len(suffix)], suffix
                break
        args.o = f"{base}.part{proc_id}{ext}"
        log.info("process %d/%d writes %s", proc_id, n_proc, args.o)
    asm = args.mode == "asm"
    executor = args.backend == "jax" and not asm
    want_fills = args.device_fills != "off" and not asm
    # the executor and the asm chain backends run their kernels here, and
    # resolve the device in this process; the other paths use the device
    # only in the fill service's process, which resolves it itself (a
    # missing card fails the service, and with it the run)
    device = args.device
    if args.backend == "jax":
        from .device import resolve_device

        device = resolve_device(args.device)
    if args.debug:
        trace.enable()
    cfg = config_from_args(args)
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
    created_workdir = None
    if asm and cfg.workdir:
        # refuse a pre-existing workdir exactly like the reference
        # (mammap_asm.py:23208-23210): protects user data from the
        # end-of-run cleanup
        if os.path.exists(cfg.workdir):
            log.error(
                "Working directory %s already exists; refusing to reuse it",
                cfg.workdir,
            )
            return 1
        os.makedirs(cfg.workdir)
        created_workdir = cfg.workdir

    handle = None
    if want_fills and not executor:
        # forked first, so its start-up overlaps the index load; until it
        # is ready the clients fill on the host (--device-fills on waits)
        from .parallel.fill_service import start_fill_server

        n_clients = max(cfg.threads, 1)
        handle = start_fill_server(n_clients, device, wait_ready=False,
                                   force=args.device_fills == "on")
        log.info("device fill service starting on %s (%d clients)", device,
                 n_clients)
    try:
        # the process group (if any) before the index load, as the
        # reference boots jax.distributed
        if args.coordinator:
            from .parallel.mesh import initialize_distributed

            initialize_distributed(args.coordinator, n_proc, proc_id)
            log.info("process %d/%d joined the gloo group at %s", proc_id,
                     n_proc, args.coordinator)
        index = load_or_build_index(args.ref, args.k, args.w,
                                    not args.nowriteindex, lowmem=args.lowmem)
        mapper = Mapper(index, cfg, device=device)
        header = mapper.header_lines(cli=" ".join(sys.argv))
        st = time.time()
        if handle is not None and args.device_fills == "on":
            handle.wait_ready()
            log.info("device fill service ready %.1fs after the index load",
                     time.time() - st)
        if asm:
            how = "one asm worker" + (
                f", chain DPs on {device}" if cfg.backend == "jax" else "")
            count = _run_asm(args, mapper, header, read_paths, shard)
        elif executor:
            how = f"the batched executor on {device}"
            count = _run_executor(args, cfg, mapper, header, read_paths,
                                  device, shard)
        elif cfg.threads <= 1:
            how = "one worker"
            count = _run_single(args, cfg, mapper, header, read_paths,
                                handle, shard)
        else:
            how = f"{cfg.threads} fork workers"
            count = _run_pool(args, cfg, index, header, read_paths, handle,
                              shard)
    finally:
        msg = handle.stop() if handle is not None else None
        if args.coordinator:
            from .parallel.mesh import shutdown_distributed

            shutdown_distributed()
        if created_workdir is not None:
            shutil.rmtree(created_workdir, ignore_errors=True)
    if msg is not None:
        raise DeviceKernelError(f"device fill service: {msg}")
    if handle is not None:
        how += f", fills served on {device}"
    if n_proc > 1 and final_out != "-":
        finish_multihost(final_out, args.o, proc_id, n_proc)
        if proc_id == 0:
            log.info("merged %d parts into %s", n_proc, final_out)
    dt = max(time.time() - st, 1e-3)
    log.info("Done: %d sequences with %s in %.1fs (%.1f/s)", count, how, dt,
             count / dt)
    if args.debug:
        log.info("stage timing:\n%s", trace.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
