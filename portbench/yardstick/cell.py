"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result.

Set-up (``setup_s``, from the process's start to the window's first
read): the configuration's cache (built in a child process when missing),
the sample haplotype and the read pool from the seed, ``import torch``
and the CUDA context (``run.py``), the program's index, a
``TorchBatchExecutor`` with device fills and the kernel library, warmed
on one batch of the cell's own reads.

The window: ``TorchBatchExecutor.map_stream`` (the entry that the CLI's
``--backend jax`` drives) takes the pool as a closed loop, for
``seconds``, and stops at the first batch boundary past it; every read
handed over before then has its records.  A pool that runs dry fails the
run.  ``map_mbps`` is the bases of those reads over the window's seconds.

Then the program's state is freed and a sample of those reads is judged
(``check.py``); its time is not set-up and not the window.
"""

from __future__ import annotations

import gc
import importlib.util
import os
import resource
import sys
import time
from pathlib import Path

import numpy as np

from . import cache, check, devtrace, traffic
from .spans import Recorder

BENCH = Path(__file__).resolve().parents[1]
METRICS = BENCH / "metrics"
FORBIDDEN = ("jax", "jaxlib", "flax", "vacmap_tpu")


class RunError(RuntimeError):
    """A run that can give no result (the pool ran dry, a module it may
    not load was loaded)."""


def process_age() -> float:
    """Seconds since this process started (its start time from /proc, in
    the boot clock)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start / os.sysconf(
        "SC_CLK_TCK")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(name: str, metrics_dir=METRICS):
    path = Path(metrics_dir) / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _counters(ex, mapper):
    from vacmap_tpu_torch.ops import affine_fill, chain

    be = mapper.chain_backend
    return {
        "global_chained": ex.chained,
        "global_declined": sum(ex.declined.values()),
        "local_chained": getattr(be, "chained", 0),
        "local_declined": sum(getattr(be, "declined", {}).values()),
        "chain_dp_launches": chain.chain_scores_batch.launches,
        "fill_banded_launches": affine_fill.fill_rowruns_banded.launches,
        "fill_full_launches": affine_fill.fill_traceback.launches
        + affine_fill.fill_rowruns.launches,
    }


def prepare(cfg: dict, mix: dict, *, seed: int, seconds: float,
            cache_root=cache.DEFAULT_ROOT, gen_workers: int = 6, log=print):
    """The set-up that needs no card, made before torch is imported (its
    workers are forked): the cache directory, the warm-up reads and the
    pool."""
    cdir, built_s = cache.ensure(cfg, cache_root)
    if built_s:
        log(f"built the cache {cdir.name} in {built_s:.1f} s")
    genome = np.load(cdir / "genome.npy", mmap_mode="r")
    warm, pool = traffic.generate(genome, mix, seed, seconds, gen_workers)
    log(f"harness inputs: pool {len(pool.reads)} reads {pool.bases} bases, "
        f"warm-up {len(warm.reads)} reads (held as str: about "
        f"{(pool.bases + warm.bases) / 1e9:.3f} GB)")
    return cdir, warm, pool


def run_cell(cfg: dict, mix: dict, *, seed: int, seconds: float, trace: bool,
             device: str, per_layer=(), cache_root=cache.DEFAULT_ROOT,
             metrics_dir=METRICS, gen_workers: int = 6, prepared=None,
             log=None, control: bool = False):
    """Returns (result dict without ``device``'s card fields, checks).
    ``prepared`` is ``prepare``'s result when the caller made it;
    ``control`` adds the bfloat16 control's reading to the judged
    numbers (``control.py``)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cdir, warm, pool = prepared or prepare(
        cfg, mix, seed=seed, seconds=seconds, cache_root=cache_root,
        gen_workers=gen_workers, log=log)
    import torch

    from vacmap_tpu_torch import trace as port_trace
    from vacmap_tpu_torch.config import AlignerConfig
    from vacmap_tpu_torch.index.index import ReferenceIndex
    from vacmap_tpu_torch.pipeline.executor import TorchBatchExecutor
    from vacmap_tpu_torch.pipeline.mapper import Mapper

    batch, threads = int(cfg["batch_reads"]), int(cfg["threads"])
    index = ReferenceIndex.load(str(cdir / "port.vmi"))
    conf = AlignerConfig(mode=cfg["mode"], kmersize=cfg["k"], window=cfg["w"],
                         check_num=cfg["c"], rg_id="1", threads=threads,
                         batch_reads=batch, backend="jax")
    mapper = Mapper(index, conf, device=device)
    ex = TorchBatchExecutor(mapper, device,
                            device_fills=bool(cfg["device_fills"]))
    cuda = torch.device(device).type == "cuda"
    rec = prof = None
    try:
        ex.map_batch(warm.reads, n_threads=threads)
        if cuda:
            torch.cuda.synchronize()
        if trace:
            rec = Recorder()
            rec.install(ex)
            port_trace.reset()
            port_trace.enable()
        c0 = _counters(ex, mapper)
        if trace and cuda:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        t_prof = time.perf_counter()
        setup_s = process_age()
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        out = []
        stream = ex.map_stream(iter(pool.reads), batch, n_threads=threads)
        deadline, drained, marks = t0 + seconds, True, [t0]
        for lines in stream:
            out.append(lines)
            if len(out) % batch == 0:
                marks.append(time.perf_counter())
                if marks[-1] >= deadline:
                    drained = False
                    break
        t1 = time.perf_counter()
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        stream.close()
        if prof is not None:
            prof.__exit__(None, None, None)
        if trace:
            port_trace.enable(False)
            rec.remove()
            work_done = rec.work_totals()
        c1 = _counters(ex, mapper)
    finally:
        ex.close()
    if drained:
        raise RunError(f"the pool of {len(pool.reads)} reads ran dry before "
                       f"{seconds} s: raise pool_mbp_per_s of the mix")
    window_s = t1 - t0
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    rss_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    bad = forbidden_modules()
    if bad:
        raise RunError(f"modules loaded that the benchmark forbids: {bad}")

    n = len(out)
    bases = sum(len(s) for _, s in pool.reads[:n])
    fifths = np.array_split(np.diff(marks), 5)
    log(f"window: {len(marks) - 1} batches in {window_s:.3f} s; mean s a "
        f"batch by fifth of the window: "
        f"{[round(float(f.mean()), 4) for f in fifths if len(f)]}; "
        f"process user {(ru1.ru_utime - ru0.ru_utime) / window_s:.3f} and "
        f"system {(ru1.ru_stime - ru0.ru_stime) / window_s:.3f} cores")
    result = {"attempted": n, "failed": sum(1 for x in out if not x)}
    e2e = {"map_mbps": bases / window_s / 1e6, "peak_rss_gb": rss_peak / 1e9,
           "setup_s": setup_s}
    device_info = {"memory_peak_bytes": int(mem_peak)}
    metrics = {}
    if trace:
        ctx = {
            "window_s": window_s, "reads": n, "mbp": bases / 1e6,
            "spans": {k: rec.total(k, t0, t1) for k in list(rec.spans)},
            "batch_s": [b - a for a, b in rec.spans.get("batch", ())
                        if a >= t0 and b <= t1],
            "port_trace": dict(port_trace._times),
            "counters": {k: c1[k] - c0[k] for k in c0},
            "work": work_done,
        }
        if prof is not None:
            iv = devtrace.device_intervals(torch, prof)
            if not iv:
                raise RunError("the profiler recorded no device event")
            lo, hi = t0 - t_prof, t1 - t_prof
            busy = devtrace.union(iv, lo, hi)
            ctx["kernels"] = devtrace.by_name(iv)
            ctx["busy_s"] = sum(b - a for a, b in busy)
            device_info.update(busy_s=ctx["busy_s"], window_s=window_s)
            gaps = sorted(devtrace.idle_gaps(busy, lo, hi),
                          key=lambda g: g[0] - g[1])[:10]
            result["breakdown"] = {
                "device_ops": sorted(([k, s] for k, (_, s) in
                                      ctx["kernels"].items()),
                                     key=lambda x: -x[1])[:10],
                "idle_gaps": [[
                    ("+".join(rec.open_at(t_prof + (a + b) / 2)) or "no span")
                    + f" at {a - lo:.6f} s", b - a] for a, b in gaps],
            }
        for name in per_layer:
            v = load_reader(name, metrics_dir)(ctx)
            if v is not None:
                metrics[name] = v
    else:
        metrics = e2e

    del ex, mapper, index
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the plain reference, once the window has closed and the program's
    # state is freed; never counted in set-up
    t_ref = time.perf_counter()
    genome = np.load(cdir / "genome.npy", mmap_mode="r")
    checks, got = check.compare(pool, out, seed, cfg["check"], genome,
                                cache.CONTIG, control=control, log=log)
    log(f"reference: {got['pieces']} pieces judged in "
        f"{time.perf_counter() - t_ref:.1f} s: " + ", ".join(
            f"{k} {v!r}" for k, v in got.items()))
    result["correct"] = check.passed(checks)
    result["judged"] = got
    result["metrics"] = metrics
    result["device"] = device_info
    return result, checks
