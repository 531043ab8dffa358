"""Async pipelined device fill service (counterpart of
``vacmap_tpu/parallel/fill_service.py``).

The base-level fills of many mapping threads or processes go to one
owner of the device:

  dispatcher thread:  drain the request queue -> group jobs by length
      bucket (and banded pseudo-bucket) -> pad -> launch (the kernels run
      asynchronously; the result's copy to pinned host memory is queued
      behind them) -> push the handles into a bounded in-flight queue
      (depth 2: double buffering, so dispatch N+1 overlaps download N)
  downloader thread:  pop handles -> wait for the copy -> route the
      row-run planes or packed op columns back to each requester

CIGAR decode stays on the requester's side (the C++ decoders).

Two transports share the server core:

  * in-process (``AsyncFillAligner``): queue.Queue, for the batched
    executor (``--backend jax``);
  * cross-process (``start_fill_server`` / ``FillClient``):
    multiprocessing queues, so the CLI's fork workers all send their
    fills to ONE device-owning process.  Only that process touches CUDA,
    and only it imports torch and the kernel wrappers: it is forked
    before the workers, from a parent that has imported neither, and the
    queues carry numpy arrays only.  The client side (``FillClient``,
    ``FillServerHandle``, ``start_fill_server``, ``decode_response``,
    ``pack_pairs``) imports without torch; the functions that run in the
    device's process import it where they start, as the reference's
    import jax.

Routes to the host, as in the reference: jobs over the largest bucket,
with an empty side or with an ambiguous base (code 4); band escalations;
requests made before the service is ready, over the in-flight job cap or
while the latency governor is closed; and every request after a
calibrated no-go (``force=False``, ``--device-fills auto``).  The
clients count these routes (shared counters), and the stats line reports
them beside the jobs the kernels served.  A device error is not routed
to the host: the waiting client raises DeviceKernelError, and the
cross-process service reports it to its parent.  Neither is a late
response: a request sent to the service is waited for, and one with no
answer within the wait's bound raises.

A second job kind, exact edit distances for the divergence filter
(``edit_batch``), runs when the service was given an edit aligner
(``ops/myers.py``; ``VACMAP_TPU_EDIT_DEVICE=1`` plugs it in, the default
deployment has none and ``edit_batch`` answers all-None at once).  Edit
jobs are routed largest bucket first; a job over every bucket, with an
empty side or with a code 4 comes back as None, which the caller
resolves on its host ladder.  Edit requests pass the same gate, raise
the same errors and have route counters of their own (``edit_routes``).
"""

from __future__ import annotations

import ctypes
import logging
import multiprocessing as mp
import os
import pickle
import queue
import resource
import sys
import threading
import time
import traceback
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..errors import DeviceKernelError
from ..ops.affine_ref import AlignResult
from ..pipeline.extend import HostBatchFillAligner, _host_global_batch

if TYPE_CHECKING:  # the device process's classes; they import torch
    from ..ops.affine_fill import TorchFillAligner
    from ..ops.myers import TorchMyersAligner

log = logging.getLogger("vacmap_tpu_torch")

# The service's knobs keep the reference's values: they were measured
# with these (PERF.md), and changing one needs a benchmark.
DEFAULT_BUCKETS = (256, 512)
# cap on the jobs of one launch, per length bucket
DEFAULT_SHAPE_B = {256: 1024, 512: 256}
MAX_JOBS = 4096
# accumulation window: under load the dispatcher batches up to this long
# (bigger calls amortize the per-call pad and dispatch CPU that the
# service takes from the mapping cores); a quiescence check (no new
# request for QUIESCENT_S) dispatches early so that trickle traffic keeps
# low latency
MAX_WAIT_MS = float(os.environ.get("VACMAP_TPU_FILL_WAIT_MS", "15.0"))
QUIESCENT_S = 0.004
# in-flight pipeline: depth 2 makes the batcher self-clocking.  The
# dispatcher blocks on inflight.put while the device works, so incoming
# requests pile into ONE next batch: occupancy rises under load and
# latency stays one small window when idle
DEPTH = int(os.environ.get("VACMAP_TPU_FILL_DEPTH", "2"))
N_DOWNLOADERS = 1
# adaptive partial offload: clients keep a SHARED count of jobs in flight
# to the service and submit only while it is below this cap; overflow
# jobs run on the host at once instead of queueing behind the service
MAX_INFLIGHT_JOBS = int(os.environ.get("VACMAP_TPU_FILL_MAX_INFLIGHT",
                                       "3072"))
# latency governor: clients keep an EMA of the request round trip and
# stop admitting new work while it exceeds this bound (the deferred
# window of 32 reads hides about that much device latency).  The cap
# above bounds memory and queue growth; this bounds waiting
MAX_LAT_S = float(os.environ.get("VACMAP_TPU_FILL_LAT_S", "0.25"))

# cross-process service status (shared ctypes int)
STARTING, SERVING, DECLINED, FAILED = 0, 1, 2, 3
# clients' route counters (shared ctypes array, in jobs): every job
# submitted, those sent to the service, and those the admission gate
# bounced to host fills, by the in-flight cap (capped) or by the latency
# governor (governed); the rest were submitted before the service was
# ready or after a calibrated no-go
SUBMITTED, OFFLOADED, CAPPED, GOVERNED = range(4)
# the edit kind's counters (a second shared array, same slots) and one
# more: jobs answered None at once because no edit kernel is live (no
# edit aligner, before ready, after a calibrated no-go)
NOT_LIVE = 4
WAIT_S = 600.0  # bound on one wait for the service's response
# bound on a stop's wait for the service's card check (see _card_missing)
CARD_CHECK_S = 60.0


def launch_counts() -> Dict[str, int]:
    """Launches of the fill kernels in this process so far."""
    from ..ops import affine_fill

    return {"fill_full": affine_fill.fill_rowruns.launches,
            "fill_banded": affine_fill.fill_rowruns_banded.launches,
            "fill_scan": affine_fill.fill_traceback.launches}


def _edit_launches() -> int:
    """Launches of the Myers kernel in this process so far."""
    from ..ops.myers import myers_distances

    return myers_distances.launches


def _make_edit_aligner(device) -> Optional["TorchMyersAligner"]:
    """The service's edit aligner: none by default, as in the reference
    (``edit_batch`` then answers all-None and the divergence filter keeps
    to its window-bound pass and host ladder); the Myers kernel's aligner
    on ``device`` under ``VACMAP_TPU_EDIT_DEVICE=1``."""
    if os.environ.get("VACMAP_TPU_EDIT_DEVICE") == "1":
        from ..ops.myers import TorchMyersAligner

        return TorchMyersAligner(device)
    return None


def _card_missing(device: str) -> Optional[str]:
    """Why ``device`` ("cuda", "cuda:N" or "cpu") names no visible card,
    as the CUDA driver counts them (it honours CUDA_VISIBLE_DEVICES), or
    None.  The service asks this first, in well under a second, and
    imports torch (seconds) only after, so that a run which ends before
    the service is ready still fails on a missing card."""
    kind, _, index = device.partition(":")
    if kind != "cuda":
        return None
    n = ctypes.c_int(0)
    try:
        drv = ctypes.CDLL("libcuda.so.1")
        if drv.cuInit(0) != 0 or drv.cuDeviceGetCount(ctypes.byref(n)) != 0:
            n.value = 0
    except OSError:  # no driver
        n.value = 0
    if n.value < 1:
        return f"device {device!r} requested but the CUDA driver sees no CUDA card"
    if index.isdigit() and int(index) >= n.value:
        return (f"device {device!r} requested but the CUDA driver sees "
                f"{n.value} CUDA card{'s' if n.value > 1 else ''}")
    return None


def _error_text(err: BaseException) -> str:
    return f"{type(err).__name__}: {err}"


def _count(routes, kind: int, n: int) -> None:
    with routes.get_lock():
        routes[kind] += n


# ---------------------------------------------------------------------------
# request packing (both transports)
# ---------------------------------------------------------------------------


def pack_pairs(pairs: Sequence[Tuple[np.ndarray, np.ndarray]]):
    """(lens int32 (n,2), concat uint8 buffer): one small message per
    request instead of 2n pickled arrays."""
    n = len(pairs)
    lens = np.empty((n, 2), np.int32)
    total = 0
    for i, (t, q) in enumerate(pairs):
        lens[i, 0] = len(t)
        lens[i, 1] = len(q)
        total += len(t) + len(q)
    buf = np.empty(total, np.uint8)
    off = 0
    for t, q in pairs:
        buf[off : off + len(t)] = t
        off += len(t)
        buf[off : off + len(q)] = q
        off += len(q)
    return lens, buf


def unpack_pairs(lens: np.ndarray, buf: np.ndarray):
    """Inverse of pack_pairs: the (t, q) views into ``buf``."""
    out = []
    off = 0
    for i in range(len(lens)):
        lt, lq = int(lens[i, 0]), int(lens[i, 1])
        out.append((buf[off : off + lt], buf[off + lt : off + lt + lq]))
        off += lt + lq
    return out


# ---------------------------------------------------------------------------
# server core (transport-agnostic)
# ---------------------------------------------------------------------------


class _ServerCore:
    """Dispatcher + downloader pipeline around a ``TorchFillAligner``
    (``dispatch_padded(tT, tQ, t_len, q_len, bucket)`` -> handle,
    ``fetch(handle)``).  DEFAULT_SHAPE_B caps the jobs of one launch per
    bucket; a launch carries exactly the jobs of its chunk.

    ``on_error(msg)`` is called once, at the first failed dispatch or
    download; every request of that batch, and of every later one, is
    answered with an error slot.  ``routes`` holds the clients' route
    counters (SUBMITTED, OFFLOADED, CAPPED, GOVERNED), ``edit_routes``
    those of the edit kind (and NOT_LIVE).

    ``edit_aligner`` (``buckets`` of (T, Wd), ``shape_b``, ``prewarm``,
    ``dispatch_jobs(jobs, T, Wd)`` -> handle, ``fetch(handle)``) serves
    requests whose fifth field is "edit"; ``edit_ready`` holds the
    buckets that take traffic and ``edit_ready_cb`` is called when it
    is filled."""

    def __init__(self, aligner, buckets=DEFAULT_BUCKETS,
                 max_wait_ms=MAX_WAIT_MS, force: bool = False,
                 n_clients: int = 1, on_error=None, routes=None,
                 edit_aligner=None, edit_ready_cb=None, edit_routes=None):
        self.aligner = aligner
        self.routes = routes if routes is not None else mp.Array("q", 4)
        self.edit_aligner = edit_aligner
        self.edit_ready: frozenset = frozenset()
        self._edit_ready_cb = edit_ready_cb
        self.edit_routes = (edit_routes if edit_routes is not None
                            else mp.Array("q", 5))
        # calibrated auto: offload pays only when the device's best-case
        # pipelined fill rate beats the whole host's fill rate; measured
        # at start-up.  force=True (--device-fills on) skips the gate.
        self.force = force
        self.n_clients = max(n_clients, 1)
        self.competitive = True
        self.calib = None  # (device_jobs_per_s, host_1core_jobs_per_s)
        self.buckets = tuple(sorted(buckets))
        self.shape_b = dict(DEFAULT_SHAPE_B)
        for b in self.buckets:  # every bucket needs a chunk cap
            self.shape_b.setdefault(b, 256)
        # banded pseudo-buckets: band-eligible jobs take the banded
        # kernel; jobs it flags (band-edge escalation) go back to the
        # requester's host fill path via the "host" slot
        from ..ops.affine_fill import BANDED

        self.band_ids = ()
        if getattr(aligner, "banded", False):
            self.band_ids = tuple(b | BANDED for b in self.buckets)
            for bid in self.band_ids:
                self.shape_b.setdefault(bid, self.shape_b[bid & ~BANDED])
        self.max_wait = max_wait_ms / 1e3
        self.inflight: "queue.Queue" = queue.Queue(maxsize=DEPTH)
        self.error: Optional[str] = None
        self._on_error = on_error
        self._stats_lock = threading.Lock()
        self._stats = {"calls": 0, "reqs": 0, "jobs": 0, "fetch_s": 0.0,
                       "disp_cpu": 0.0, "dl_cpu": 0.0, "escal": 0,
                       "host_slot": 0, "edit_calls": 0, "edit_served": 0,
                       "edit_unrouted": 0}
        self._mark_launches()  # reset once traffic may start

    def _mark_launches(self):
        self._launch0 = launch_counts()
        self._edit_launch0 = _edit_launches()

    def prewarm(self):
        """One warm launch per route, then (unless forced) the calibrated
        go/no-go: ``competitive`` False means the device cannot beat the
        host's own fill kernels here, and the deployment stays on host
        fills.  The edit buckets are warmed and marked ready last."""
        for b in self.band_ids + self.buckets:
            self.aligner.prewarm(batch_sizes=(self.shape_b[b],), buckets=(b,))
        if not self.force:
            self.competitive = self._calibrate()
        self.ready_edit(warm=True)
        self._mark_launches()

    def ready_edit(self, warm: bool) -> None:
        """Open the edit aligner's buckets to traffic (after one warm
        launch each with ``warm``).  There is nothing to compile per
        shape, so this happens before the service reports ready, not in
        idle gaps as in the reference."""
        ea = self.edit_aligner
        if ea is None:
            return
        if warm:
            ea.prewarm()
        self.edit_ready = frozenset(ea.buckets)
        if self._edit_ready_cb is not None:
            self._edit_ready_cb()

    def _calibrate(self) -> bool:
        """Measured go/no-go for the offload: the device's best-case
        pipelined fill rate (4 back-to-back dispatches, fetches at the
        end) against the host striped kernel's single-core rate on the
        same jobs, times the number of clients (x0.75 margin: the
        service's own host work is taken from the same cores)."""
        from ..ops.affine_fill import BANDED

        b_id = self.band_ids[0] if self.band_ids else self.buckets[0]
        b = b_id & ~BANDED
        B = self.shape_b[b_id]
        n = max(b * 3 // 4, 16)
        rng = np.random.default_rng(0)
        t_plane = rng.integers(0, 4, (B, b)).astype(np.uint8)
        q_plane = t_plane.copy()
        m = rng.random((B, b)) < 0.05
        q_plane[m] = rng.integers(0, 4, int(m.sum())).astype(np.uint8)
        t_plane[:, n:] = 4
        q_plane[:, n:] = 4
        lens = np.full(B, n, np.int32)

        def dispatch():
            return self.aligner.dispatch_padded(t_plane, q_plane, lens, lens,
                                                b_id)

        self.aligner.fetch(dispatch())  # warm
        t0 = time.monotonic()
        hs = [dispatch() for _ in range(4)]
        for h in hs:
            self.aligner.fetch(h)
        dev_rate = 4 * B / max(time.monotonic() - t0, 1e-9)
        jobs = [(t_plane[i, :n], q_plane[i, :n]) for i in range(min(B, 256))]
        t0 = time.monotonic()
        host_res = native.align2p_batch_native(jobs, eqx=False)
        host_rate = len(jobs) / max(time.monotonic() - t0, 1e-9)
        self.calib = (dev_rate, host_rate)
        if host_res is None:
            return True  # no native lib: host fills are the slow oracle
        return dev_rate > host_rate * self.n_clients * 0.75

    def fail(self, msg: str) -> None:
        """Enter the error state (first message wins) and report it."""
        first = self.error is None
        if first:
            self.error = msg
        print(f"vacmap_tpu_torch fill service: device error: {msg}",
              file=sys.stderr, flush=True)
        if first and self._on_error is not None:
            self._on_error(msg)

    def _answer_error(self, pending, resp_put):
        for client_id, req_id, *_ in pending:
            try:
                resp_put(client_id, (req_id, {"error": ("error", self.error)}))
            except Exception:  # noqa: BLE001  a gone client waits no more
                pass

    # -- dispatcher ----------------------------------------------------
    def run_dispatch(self, req_get, resp_put):
        """req_get(timeout) -> (client_id, req_id, lens, buf[, "edit"]) |
        None (stop); resp_put(client_id, msg).  Blocks until the stop
        sentinel."""
        pending = []
        while True:
            try:
                item = req_get(0.05)
            except queue.Empty:
                continue
            if item is None:
                break
            pending.append(item)
            # accumulation window: let peers pile on (quiescence check:
            # dispatch early when no new request arrives for a while)
            deadline = time.monotonic() + self.max_wait
            last_new = time.monotonic()
            njobs = len(pending[0][2])
            stop = False
            while njobs < MAX_JOBS and time.monotonic() < deadline:
                try:
                    item = req_get(0.002)
                except queue.Empty:
                    if time.monotonic() - last_new >= QUIESCENT_S:
                        break
                    continue
                if item is None:
                    stop = True
                    break
                pending.append(item)
                last_new = time.monotonic()
                njobs += len(item[2])
            self._dispatch_batch(pending, resp_put)
            pending = []
            if stop:
                break
        self.inflight.put(None)  # the downloader drains, then stops

    def _dispatch_batch(self, pending, resp_put):
        """A failed dispatch answers its requests with the error (and the
        dispatcher lives on, so no client waits forever)."""
        if self.error is None:
            try:
                self._dispatch_batch_inner(pending, resp_put)
                return
            except Exception as err:  # noqa: BLE001  reported to clients
                traceback.print_exc(limit=6, file=sys.stderr)
                self.fail(_error_text(err))
        self._answer_error(pending, resp_put)

    def _dispatch_batch_inner(self, pending, resp_put):
        """Flatten requests -> bucket groups -> padded device dispatches,
        in bulk numpy over the concatenated request buffers (no per-job
        Python: the service's host CPU is taken from the mapping cores)."""
        from ..ops.affine_fill import BANDED, band_eligible

        cpu0 = time.thread_time()
        bufs = [p[3] for p in pending]
        all_buf = bufs[0] if len(bufs) == 1 else np.concatenate(bufs)
        lens_all = np.concatenate([p[2] for p in pending])  # (M, 2) int32
        n_jobs_per_req = np.array([len(p[2]) for p in pending], np.int64)
        job_req = np.repeat(np.arange(len(pending)), n_jobs_per_req)
        is_edit = np.array([len(p) > 4 and p[4] == "edit" for p in pending],
                           bool)[job_req]
        job_ji = np.arange(len(job_req)) - np.repeat(
            np.cumsum(n_jobs_per_req) - n_jobs_per_req, n_jobs_per_req)
        t_lens = lens_all[:, 0].astype(np.int64)
        q_lens = lens_all[:, 1].astype(np.int64)
        pair_sz = t_lens + q_lens
        t_offs = np.cumsum(pair_sz) - pair_sz  # start of each job's t
        q_offs = t_offs + t_lens
        # bucket of each fill job (-1 = host)
        mx = np.maximum(t_lens, q_lens)
        bucket_arr = np.full(len(mx), -1, np.int64)
        for b in reversed(self.buckets):
            bucket_arr[mx <= b] = b
        bucket_arr[(t_lens == 0) | (q_lens == 0) | is_edit] = -1
        # jobs holding an ambiguous base (code 4) go to the host, as in
        # the reference.  Nonzero jobs' byte spans tile all_buf, so one
        # reduceat over their starts gives every job's largest code.
        nz = pair_sz > 0
        amb = np.zeros(len(mx), bool)
        if len(all_buf) and nz.any():
            seg_max = np.maximum.reduceat(all_buf, t_offs[nz])
            amb[nz] = seg_max >= 4
            bucket_arr[amb] = -1
        if self.band_ids:
            elig = band_eligible(t_lens, q_lens) & (bucket_arr > 0)
            bucket_arr[elig] |= BANDED
        handles = []  # (bucket, handle, job indices, kind)
        # edit jobs: largest ready bucket first, so that the last fitting
        # (smallest) one wins; a job over every bucket, with an empty
        # side or with a code 4 (the kernel's rule for it is not the host
        # ladder's) stays unrouted and is answered None
        ea = self.edit_aligner
        edit_idx = np.flatnonzero(is_edit)
        if len(edit_idx) and ea is not None:
            tl, ql = t_lens[edit_idx], q_lens[edit_idx]
            fits = (tl > 0) & (ql > 0) & ~amb[edit_idx]
            eb = np.full(len(edit_idx), -1, np.int64)
            ebuckets = sorted(self.edit_ready, reverse=True)
            for k, (T, Wd) in enumerate(ebuckets):
                eb[fits & (tl <= T) & (ql <= Wd * 32)] = k
            for k, (T, Wd) in enumerate(ebuckets):
                idxs = edit_idx[eb == k]
                for cs in range(0, len(idxs), ea.shape_b[T]):
                    chunk = idxs[cs : cs + ea.shape_b[T]]
                    jobs = [(all_buf[t_offs[j] : t_offs[j] + t_lens[j]],
                             all_buf[q_offs[j] : q_offs[j] + q_lens[j]])
                            for j in chunk]
                    handles.append(((T, Wd), ea.dispatch_jobs(jobs, T, Wd),
                                    chunk, "edit"))
            edit_idx = edit_idx[eb < 0]
        overflow = np.flatnonzero((bucket_arr < 0) & ~is_edit)
        for b in self.band_ids + self.buckets:
            idxs = np.flatnonzero(bucket_arr == b)
            w = b & ~BANDED  # plane width
            for cs in range(0, len(idxs), self.shape_b[b]):
                chunk = idxs[cs : cs + self.shape_b[b]]
                B = len(chunk)
                tl = t_lens[chunk]
                ql = q_lens[chunk]
                tT = np.full((B, w), 4, np.uint8)
                tQ = np.full((B, w), 4, np.uint8)
                # bulk scatter: all chunk jobs' bytes in two fancy writes
                rows = np.repeat(np.arange(B), tl)
                within = np.arange(int(tl.sum())) - np.repeat(np.cumsum(tl) - tl, tl)
                tT[rows, within] = all_buf[np.repeat(t_offs[chunk], tl) + within]
                rows = np.repeat(np.arange(B), ql)
                within = np.arange(int(ql.sum())) - np.repeat(np.cumsum(ql) - ql, ql)
                tQ[rows, within] = all_buf[np.repeat(q_offs[chunk], ql) + within]
                h = self.aligner.dispatch_padded(tT, tQ, tl.astype(np.int32),
                                                 ql.astype(np.int32), b)
                handles.append((b, h, chunk, "fill"))
        with self._stats_lock:
            if self._stats is not None:
                self._stats["disp_cpu"] += time.thread_time() - cpu0
        self.inflight.put((pending, (job_req, job_ji), handles,
                           (overflow, len(edit_idx)), resp_put))

    # -- downloader ----------------------------------------------------
    def run_download(self):
        """Downloader loop.  At the stop sentinel it writes the stats line
        to ``$VACMAP_TPU_FILL_STATS`` when that is set: calls, jobs,
        fetch time, escalations, the clients' routes and the fill
        kernels' launches since the service became ready."""
        stats_path = os.environ.get("VACMAP_TPU_FILL_STATS")
        t_start = time.monotonic()
        while True:
            item = self.inflight.get()
            if item is None:
                self.inflight.put(None)  # release any other downloader
                with self._stats_lock:
                    st, self._stats = self._stats, None
                if stats_path and st is not None:
                    self._write_stats(stats_path, st, t_start)
                break
            pending, (job_req, job_ji), handles, unrouted, resp_put = item
            if self.error is None:
                try:
                    self._download_item(pending, job_req, job_ji, handles,
                                        unrouted, resp_put)
                    continue
                except Exception as err:  # noqa: BLE001  reported to clients
                    traceback.print_exc(limit=6, file=sys.stderr)
                    self.fail(_error_text(err))
            self._answer_error(pending, resp_put)

    def _write_stats(self, path, st, t_start):
        """jobs: sent to a kernel; escal: of those, returned to the
        host; host_slot: sent to the service but routed to the host
        (code 4, oversize, empty side); submitted / offloaded / capped /
        governed / not_ready: the clients' routes (see SUBMITTED);
        device_share: jobs the kernels answered over jobs submitted.
        The edit kind: edit_submitted = edit_sent + edit_not_live +
        edit_capped + edit_governed at the clients; of those sent,
        edit_served by the edit aligner in edit_calls batches and
        edit_unrouted answered None; edit_launches: the Myers kernel's
        launches since the service became ready."""
        ru = resource.getrusage(resource.RUSAGE_SELF)
        dt = max(time.monotonic() - t_start, 1e-9)
        now = launch_counts()
        launches = ",".join(f"{k}:{now[k] - self._launch0[k]}" for k in now)
        sub, off, capped, governed = self.routes[:]
        e_sub, e_sent, e_capped, e_governed, e_not_live = self.edit_routes[:]
        with open(path, "w") as fh:
            fh.write(
                "calls=%d reqs=%d jobs=%d jobs/call=%.1f fetch_ms/call=%.1f "
                "wall_s=%.1f cpu_s=%.1f disp_cpu=%.1f dl_cpu=%.1f escal=%d "
                "host_slot=%d submitted=%d offloaded=%d capped=%d "
                "governed=%d not_ready=%d device_share=%.4f launches=%s "
                "edit_submitted=%d edit_sent=%d edit_not_live=%d "
                "edit_capped=%d edit_governed=%d edit_served=%d "
                "edit_unrouted=%d edit_calls=%d edit_launches=%d\n"
                % (st["calls"], st["reqs"], st["jobs"],
                   st["jobs"] / max(st["calls"], 1),
                   st["fetch_s"] * 1e3 / max(st["calls"], 1), dt,
                   ru.ru_utime + ru.ru_stime, st["disp_cpu"], st["dl_cpu"],
                   st["escal"], st["host_slot"], sub, off, capped, governed,
                   sub - off - capped - governed,
                   (st["jobs"] - st["escal"]) / max(sub, 1), launches,
                   e_sub, e_sent, e_not_live, e_capped, e_governed,
                   st["edit_served"], st["edit_unrouted"], st["edit_calls"],
                   _edit_launches() - self._edit_launch0))

    def _download_item(self, pending, job_req, job_ji, handles, unrouted,
                       resp_put):
        cpu0 = time.thread_time()
        overflow, n_edit_unrouted = unrouted
        # per-request routing tables: req -> {(bucket, chunk#): slot}
        # (chunk# keys stop two same-bucket chunks from merging)
        per_req = [dict() for _ in pending]
        host_extra = {}
        n_escal = n_jobs = n_edit = n_edit_calls = 0
        fetch_s = 0.0

        def req_groups(chunk):
            # chunk rows grouped by requester: [(ri, rows)]
            rks = job_req[chunk]
            order = np.argsort(rks, kind="stable")
            srk = rks[order]
            cuts = np.flatnonzero(srk[1:] != srk[:-1]) + 1
            for g in np.split(order, cuts):
                yield int(rks[g[0]]), g

        for ci, (b, h, chunk, kind) in enumerate(handles):
            t0 = time.monotonic()
            if kind == "edit":
                dists = self.edit_aligner.fetch(h)
                fetch_s += time.monotonic() - t0
                n_edit += len(chunk)
                n_edit_calls += 1
                for ri, rows in req_groups(chunk):
                    per_req[ri][(b, ci)] = ("edist", dists[rows],
                                            job_ji[chunk[rows]].tolist())
                continue
            n_jobs += len(chunk)
            res = self.aligner.fetch(h)  # blocks until the copy landed
            fetch_s += time.monotonic() - t0
            if res[0] == "rrb":
                # banded planes + escalation flags: flagged jobs go back
                # to the requester's host fill path
                lo, ex, flags = res[1], res[2], res[3]
                for ri, rows in req_groups(chunk):
                    fl = flags[rows]
                    okr = rows[~fl]
                    if len(okr):
                        per_req[ri][(b, ci)] = (
                            "rrB", lo[okr], ex[okr],
                            job_ji[chunk[okr]].tolist())
                    bad = rows[fl]
                    if len(bad):
                        host_extra.setdefault(ri, []).extend(
                            job_ji[chunk[bad]].tolist())
                        n_escal += len(bad)
            elif res[0] == "rr":
                lo, ex = res[1], res[2]
                for ri, rows in req_groups(chunk):
                    per_req[ri][(b, ci)] = ("rr", lo[rows], ex[rows],
                                            job_ji[chunk[rows]].tolist())
            else:
                packed = res[1]
                for ri, rows in req_groups(chunk):
                    per_req[ri][(b, ci)] = ("packed", packed[:, rows],
                                            job_ji[chunk[rows]].tolist())
        if len(overflow):
            for ri, rows in req_groups(overflow):
                host_extra.setdefault(ri, []).extend(
                    job_ji[overflow[rows]].tolist())
        for ri, extra in host_extra.items():
            per_req[ri][(-1, 0)] = ("host", extra)
        with self._stats_lock:
            if self._stats is not None:
                self._stats["calls"] += len(handles) - n_edit_calls
                self._stats["edit_calls"] += n_edit_calls
                self._stats["edit_served"] += n_edit
                self._stats["edit_unrouted"] += n_edit_unrouted
                self._stats["jobs"] += n_jobs
                self._stats["reqs"] += len(pending)
                self._stats["fetch_s"] += fetch_s
                self._stats["escal"] += n_escal
                self._stats["host_slot"] += len(overflow)
                self._stats["dl_cpu"] += time.thread_time() - cpu0
        for ri, (client_id, req_id, *_rest) in enumerate(pending):
            resp_put(client_id, (req_id, per_req[ri]))


# ---------------------------------------------------------------------------
# client-side decode (shared by both transports)
# ---------------------------------------------------------------------------


def decode_response(msg, pairs, eqx: bool):
    """Tagged per-chunk slots ({key: ("rr" | "rrB", lo, ex, jidxs) |
    ("packed", cols, jidxs) | ("host", jidxs) | ("error", text)}) + the
    original pairs -> AlignResult list (host-aligning the jobs the
    service routed to the host).  An error slot raises
    DeviceKernelError."""
    for slot in msg.values():
        if slot[0] == "error":
            raise DeviceKernelError(f"device fill service: {slot[1]}")
    results: List[Optional[AlignResult]] = [None] * len(pairs)
    for slot in msg.values():
        if slot[0] == "host":
            sub = [pairs[ji] for ji in slot[1]]
            for ji, r in zip(slot[1], _host_global_batch(sub, eqx)):
                results[ji] = r
            continue
        if slot[0] in ("rr", "rrB"):  # rrB: banded, escalations removed
            _, lo, ex, jidxs = slot
            sub = [pairs[ji] for ji in jidxs]
            decoded = native.decode_rowruns(lo, ex, sub, eqx=eqx)
            if decoded is None:  # native lib unavailable
                from ..ops.affine_fill import (
                    _decode_packed_python, rowruns_to_packed)

                t_len = np.array([len(t) for t, _ in sub], np.int64)
                q_len = np.array([len(q) for _, q in sub], np.int64)
                packed = rowruns_to_packed(lo, ex, t_len, q_len, lo.shape[1])
                decoded = _decode_packed_python(packed, sub, eqx=eqx)
        else:
            _, packed, jidxs = slot
            sub = [pairs[ji] for ji in jidxs]
            decoded = native.decode_tb_ops(packed, sub, eqx=eqx)
            if decoded is None:
                from ..ops.affine_fill import _decode_packed_python

                decoded = _decode_packed_python(packed, sub, eqx=eqx)
        for col, ji in enumerate(jidxs):
            t, q = pairs[ji]
            results[ji] = AlignResult(native.ops_to_cigar(decoded[col]), False,
                                      len(q), len(t), 0, 0, 0)
    return results


def decode_edit_response(msg, n_pairs: int) -> List[Optional[int]]:
    """Edit-kind response -> the exact distance of every routed job, None
    for the unrouted ones.  An error slot raises DeviceKernelError."""
    results: List[Optional[int]] = [None] * n_pairs
    for slot in msg.values():
        if slot[0] == "error":
            raise DeviceKernelError(f"device fill service: {slot[1]}")
        if slot[0] == "edist":
            for d, ji in zip(slot[1], slot[2]):
                results[ji] = int(d)
    return results


# ---------------------------------------------------------------------------
# in-process transport (batched executor)
# ---------------------------------------------------------------------------


class AsyncFillAligner:
    """In-process pipelined fill aligner: the blocking ``align_batch(pairs,
    eqx)`` of an aggregating aligner, plus ``submit``/``wait``, with
    dispatch N+1 overlapping download N."""

    # refine_chain ships the divergence window-bound batch here too
    wants_window_jobs = True

    def __init__(self, aligner, buckets=DEFAULT_BUCKETS,
                 max_wait_ms=MAX_WAIT_MS, prewarm: bool = True,
                 force: bool = True, edit_aligner=None):
        self.core = _ServerCore(aligner, buckets=buckets,
                                max_wait_ms=max_wait_ms, force=force,
                                edit_aligner=edit_aligner)
        self.req_q: "queue.Queue" = queue.Queue()
        self._events: Dict[int, dict] = {}
        self._lock = threading.Lock()
        self._next_id = 0
        self._pending_n = 0  # in-flight jobs (backpressure, under _lock)
        # submits route to host fills until the dispatcher thread has
        # warmed the device, and for good after a calibrated no-go
        self.ready = threading.Event()
        self.failed = False
        self._do_prewarm = prewarm
        self._threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True),
        ] + [
            threading.Thread(target=self.core.run_download, daemon=True)
            for _ in range(N_DOWNLOADERS)
        ]
        for t in self._threads:
            t.start()

    def _dispatch_loop(self):
        try:
            if self._do_prewarm:
                self.core.prewarm()
            else:
                self.core.ready_edit(warm=False)
            if not self.core.competitive:
                self.failed = True  # calibrated no-go: stay on host fills
        except Exception as err:  # noqa: BLE001  raised by every submit
            traceback.print_exc(limit=6, file=sys.stderr)
            self.core.fail(_error_text(err))
        finally:
            self.ready.set()
        self.core.run_dispatch(lambda tmo: self.req_q.get(timeout=tmo),
                               self._resp_put)

    def _resp_put(self, client_id, resp):
        req_id, msg = resp
        with self._lock:
            box = self._events.pop(req_id, None)
            if box is not None:
                self._pending_n -= box["n"]
        if box is not None:
            box["msg"] = msg
            box["event"].set()

    def _check(self):
        if self.core.error is not None:
            raise DeviceKernelError(f"device fill service: {self.core.error}")

    # the refine_chain aligner interface
    def __call__(self, pairs, eqx: bool = False):
        return self.align_batch(pairs, eqx)

    def align_batch(self, pairs, eqx: bool = False):
        return self.wait(self.submit(pairs, eqx))

    def accepting(self) -> bool:
        """Non-reserving saturation peek (see FillClient.accepting)."""
        if self.failed or not self.ready.is_set():
            return False
        return self._pending_n < MAX_INFLIGHT_JOBS

    def submit(self, pairs, eqx: bool = False):
        """Enqueue a fill batch; returns a handle for wait().  Before the
        service is ready, after a calibrated no-go and while the in-flight
        backlog is at the cap, the handle routes to host fills instead.
        Raises DeviceKernelError once the device has failed."""
        self._check()
        if not pairs:
            return (None, pairs, eqx)
        routes = self.core.routes
        _count(routes, SUBMITTED, len(pairs))
        if self.failed or not self.ready.is_set():
            return ("host", pairs, eqx)
        box = {"event": threading.Event(), "msg": None, "n": len(pairs)}
        with self._lock:
            admit = self._pending_n < MAX_INFLIGHT_JOBS
            if admit:
                self._pending_n += len(pairs)
                req_id = self._next_id
                self._next_id += 1
                self._events[req_id] = box
        _count(routes, OFFLOADED if admit else CAPPED, len(pairs))
        if not admit:
            return ("host", pairs, eqx)
        self.req_q.put((0, req_id, *pack_pairs(pairs)))
        return (box, pairs, eqx)

    def wait(self, handle, timeout: float = WAIT_S):
        box, pairs, eqx = handle
        if box is None:
            return []
        if box == "host":
            return _host_global_batch(pairs, eqx)
        if not box["event"].wait(timeout=timeout):
            self._check()
            raise DeviceKernelError(
                f"device fill service: no response in {timeout:.0f} s")
        return decode_response(box["msg"], pairs, eqx)

    def edit_batch(self, pairs, timeout: float = WAIT_S):
        """Exact edit distances from the service's edit kernel; a None
        entry is the caller's to resolve on the host.  All None at once,
        with no round trip, while no edit kernel is live or the in-flight
        backlog is at the cap.  A request that was sent is waited for:
        an error response or none within ``timeout`` raises
        DeviceKernelError."""
        self._check()
        n = len(pairs)
        if not n:
            return []
        routes = self.core.edit_routes
        _count(routes, SUBMITTED, n)
        if self.failed or not self.ready.is_set() or not self.core.edit_ready:
            _count(routes, NOT_LIVE, n)
            return [None] * n
        box = {"event": threading.Event(), "msg": None, "n": n}
        with self._lock:
            admit = self._pending_n < MAX_INFLIGHT_JOBS
            if admit:
                self._pending_n += n
                req_id = self._next_id
                self._next_id += 1
                self._events[req_id] = box
        _count(routes, OFFLOADED if admit else CAPPED, n)
        if not admit:
            return [None] * n
        self.req_q.put((0, req_id, *pack_pairs(pairs), "edit"))
        if not box["event"].wait(timeout=timeout):
            self._check()
            raise DeviceKernelError(
                f"device fill service: no edit response in {timeout:.0f} s")
        return decode_edit_response(box["msg"], n)

    def stop(self, timeout: float = 10.0) -> Optional[str]:
        """Drain and join the pipeline threads, so none is inside a device
        call when the process tears CUDA down.  Returns an error message
        when a thread is still running after ``timeout`` (a device call
        that does not return), else None."""
        self.req_q.put(None)
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))
        if any(t.is_alive() for t in self._threads):
            return f"fill service threads still running {timeout:.0f} s after stop"
        return None


def _make_aligner(buckets, device) -> "TorchFillAligner":
    """The service's device aligner on ``device``."""
    from ..ops.affine_fill import TorchFillAligner

    return TorchFillAligner(buckets=buckets, device=device)


def async_fill_aligner(device, buckets=DEFAULT_BUCKETS, force: bool = True,
                       **kw) -> AsyncFillAligner:
    """The in-process service on ``device``.  force=False runs the
    start-up calibration and stays on host fills when the device's
    best-case rate cannot beat the host's own fill kernels."""
    kw.setdefault("edit_aligner", _make_edit_aligner(device))
    return AsyncFillAligner(_make_aligner(buckets, device), buckets=buckets,
                            force=force, **kw)


# ---------------------------------------------------------------------------
# cross-process transport (fork-worker CLI deployment)
# ---------------------------------------------------------------------------


def _server_main(req_q, resp_qs, buckets, device, ready_evt, status, err_buf,
                 routes, prewarm: bool, force: bool, edit_val=None,
                 edit_routes=None, card_checked=None):
    """Entry point of the device-owning service process: the only process
    of the fork pool that imports torch.  ``edit_val`` is set to 1 once
    the edit kernel takes traffic; ``card_checked`` is set once the
    driver has shown ``device``'s card, or the service has failed."""

    def report(msg):
        err_buf.value = msg.encode("utf-8", "replace")[: len(err_buf) - 1]
        status.value = FAILED
        if card_checked is not None:
            card_checked.set()

    def edit_live():
        if edit_val is not None:
            edit_val.value = 1

    try:
        missing = _card_missing(str(device))
        if missing is not None:
            raise DeviceKernelError(missing)
        if card_checked is not None:
            card_checked.set()
        import torch

        from ..device import resolve_device

        dev = resolve_device(str(device))
        if dev.type == "cpu":
            # one thread: the mapping workers have the other cores
            torch.set_num_threads(1)
        core = _ServerCore(_make_aligner(buckets, dev), buckets=buckets,
                           force=force, n_clients=len(resp_qs),
                           on_error=report, routes=routes,
                           edit_aligner=_make_edit_aligner(dev),
                           edit_ready_cb=edit_live, edit_routes=edit_routes)
        if prewarm:
            core.prewarm()
        else:
            core.ready_edit(warm=False)
    except Exception as err:  # noqa: BLE001  the parent reports it
        report(_error_text(err))
        ready_evt.set()
        raise
    if not core.competitive:
        c = core.calib or (0.0, 0.0)
        log.info("device fill offload declined by calibration: device %.0f "
                 "jobs/s best-case vs host %.0f jobs/s/core x %d workers "
                 "(--device-fills on overrides)", c[0], c[1], len(resp_qs))
        status.value = DECLINED
        ready_evt.set()
        return
    status.value = SERVING
    ready_evt.set()

    def resp_put(client_id, resp):
        # stamped with the send time (see FillClient._recv_one)
        resp_qs[client_id].put((*resp, time.monotonic()))

    dls = [threading.Thread(target=core.run_download, daemon=True)
           for _ in range(N_DOWNLOADERS)]
    for dl in dls:
        dl.start()
    core.run_dispatch(lambda tmo: req_q.get(timeout=tmo), resp_put)
    for dl in dls:
        dl.join()
    # responses no client will drain any more (a worker that was stopped
    # after an error) must not hold this process's exit on a full pipe
    for q in resp_qs:
        q.cancel_join_thread()


def _status_error(status, err_buf) -> Optional[str]:
    if status.value == FAILED:
        return err_buf.value.decode("utf-8", "replace") or "unknown error"
    return None


class FillServerHandle:
    def __init__(self, proc, req_q, resp_qs, ready_evt, status, err_buf,
                 pending_ctr, lat_sh, routes, edit_val=None,
                 edit_routes=None, card_checked=None):
        self.proc = proc
        self.req_q = req_q
        self.resp_qs = resp_qs
        self.ready_evt = ready_evt
        self.status = status
        self.err_buf = err_buf
        self.pending_ctr = pending_ctr
        self.lat_sh = lat_sh
        self.routes = routes
        self.edit_val = edit_val  # shared flag: 1 = an edit kernel is live
        self.edit_routes = edit_routes
        self.card_checked = card_checked  # shared flag: see _server_main
        self._stopped = False

    def client(self, worker_id: int) -> "FillClient":
        return FillClient(worker_id, self.req_q, self.resp_qs[worker_id],
                          ready_evt=self.ready_evt, status=self.status,
                          err_buf=self.err_buf, pending_ctr=self.pending_ctr,
                          lat_sh=self.lat_sh, routes=self.routes,
                          edit_val=self.edit_val,
                          edit_routes=self.edit_routes)

    def wait_ready(self, timeout: float = 900.0) -> bool:
        """Block until the service is warm; False after a calibrated
        no-go.  Raises DeviceKernelError when it fails to start."""
        if not self.ready_evt.wait(timeout=timeout):
            raise DeviceKernelError(
                f"fill service did not come up in {timeout:.0f} s")
        msg = self.error()
        if msg is not None:
            raise DeviceKernelError(f"fill service failed to start: {msg}")
        return self.status.value == SERVING

    def error(self) -> Optional[str]:
        """The service's device error, or its death while it should be
        serving; None while all is well."""
        msg = _status_error(self.status, self.err_buf)
        if msg is not None:
            return msg
        code = self.proc.exitcode
        if (code is not None and not self._stopped
                and self.status.value in (STARTING, SERVING)):
            return f"fill service process exited with code {code}"
        return None

    def stop(self, timeout: float = 30.0) -> Optional[str]:
        """Drain and stop the service process; returns ``error()`` as it
        stood before the stop, or the process's own failure to exit
        cleanly within ``timeout`` (then it is terminated).  A service
        that is not serving is terminated at once, once it has checked
        for its card (``_card_missing``: no torch import is waited for),
        so that a missing card is reported however early the stop."""
        if (self.card_checked is not None and self.status.value == STARTING
                and self.proc.is_alive()):
            self.card_checked.wait(timeout=CARD_CHECK_S)
        msg = self.error()
        self._stopped = True
        try:
            if self.status.value == SERVING and self.proc.is_alive():
                self.req_q.put(None)
                self.proc.join(timeout=timeout)
                if msg is None and self.proc.is_alive():
                    msg = (f"fill service process did not exit within "
                           f"{timeout:.0f} s of its stop")
                elif msg is None and self.proc.exitcode != 0:
                    msg = f"fill service process exited with code {self.proc.exitcode}"
        finally:
            if self.proc.is_alive():
                self.proc.terminate()
            self.proc.join(timeout=10)
        return msg


def start_fill_server(n_clients: int, device, buckets=DEFAULT_BUCKETS,
                      prewarm: bool = True, wait_ready: bool = True,
                      ready_timeout: float = 900.0, force: bool = False):
    """Fork the device-owning fill server for ``n_clients`` clients on
    ``device`` ("cuda", "cuda:N" or "cpu"); returns a FillServerHandle, or
    None after a calibrated no-go when ``wait_ready``.

    Call it BEFORE the mapping workers fork (they inherit the queues),
    from a process that has not set CUDA up: only the service process
    touches the device.  With ``wait_ready``, a service that fails to
    start raises DeviceKernelError here; without it, the clients and
    ``FillServerHandle.error`` report the failure."""
    ctx = mp.get_context("fork")
    req_q = ctx.Queue()
    resp_qs = [ctx.Queue() for _ in range(n_clients)]
    ready = ctx.Event()
    status = ctx.Value("i", STARTING)
    err_buf = ctx.Array("c", 2048)
    pending = ctx.Value("l", 0)  # jobs in flight, shared by all clients
    # shared round-trip EMA (<0 = no data), shared so that it survives
    # worker fork generations
    lat_sh = ctx.Value("d", -1.0)
    routes = ctx.Array("q", 4)  # the clients' route counters
    edit_val = ctx.Value("i", 0)  # 1 once the service's edit kernel is live
    edit_routes = ctx.Array("q", 5)  # the edit kind's route counters
    card_checked = ctx.Event()
    proc = ctx.Process(
        target=_server_main, name="fill-service",
        args=(req_q, resp_qs, buckets, str(device), ready, status, err_buf,
              routes, prewarm, force, edit_val, edit_routes, card_checked),
        daemon=True,
    )
    proc.start()
    handle = FillServerHandle(proc, req_q, resp_qs, ready, status, err_buf,
                              pending, lat_sh, routes, edit_val, edit_routes,
                              card_checked)
    if wait_ready:
        try:
            serving = handle.wait_ready(ready_timeout)
        except DeviceKernelError:
            handle.stop()
            raise
        if not serving:
            handle.stop()
            return None
    return handle


class FillClient:
    """Worker-side handle: thread-safe ``submit``/``wait`` (and the
    blocking ``align_batch``), so that many mapping threads can have
    fills in flight at once.  Submits pass an admission gate (the shared
    in-flight cap and the latency governor); bounced jobs join a
    cross-read host batch.  The service's status is checked on every
    call, and a failed service raises DeviceKernelError; ``wait`` never
    recomputes on the host a request that was sent to the service.

    Response draining happens INSIDE ``wait()`` (one drainer at a time,
    poll-then-recv), NOT in a parked reader thread: mp.Queue.get holds
    the queue's cross-process _rlock while blocked in recv, so a daemon
    router thread parked in get() at process exit leaves that shared
    lock acquired FOREVER, and the next fork generation of workers then
    deadlocks on acquire.  The drain pattern holds _rlock only across a
    short poll + one message read."""

    wants_window_jobs = True  # see AsyncFillAligner

    def __init__(self, worker_id: int, req_q, resp_q, ready_evt, status,
                 err_buf, pending_ctr=None, lat_sh=None, routes=None,
                 edit_val=None, edit_routes=None):
        self.worker_id = worker_id
        self.req_q = req_q
        self.resp_q = resp_q
        self._events: Dict[int, dict] = {}
        self._lock = threading.Lock()
        self._drain_lock = threading.Lock()  # one drainer at a time
        self._next_id = 0
        self.failed = False  # a calibrated no-go: host fills for good
        self._ready_evt = ready_evt
        self._ready_cache = ready_evt is None  # no gate -> trust caller
        self._pending = pending_ctr  # shared in-flight job counter
        self._lat_sh = lat_sh  # shared round-trip EMA (survives forks)
        self._status = status
        self._err_buf = err_buf
        self._routes = routes if routes is not None else mp.Array("q", 4)
        self._edit_val = edit_val  # shared flag: an edit kernel is live
        self._edit_routes = (edit_routes if edit_routes is not None
                             else mp.Array("q", 5))
        self.offloaded_jobs = 0  # accepted by the gate (this client)
        self.bounced_jobs = 0    # host-filled by the gate (this client)
        # gate-bounced jobs join a CROSS-READ host batch (the host
        # deployment's HostBatchFillAligner) instead of filling per read:
        # per-read residue batches lose the striped kernel's cross-read
        # lane packing
        self._hb = None
        self._hb_lock = threading.Lock()

    def _check(self):
        msg = _status_error(self._status, self._err_buf)
        if msg is not None:
            raise DeviceKernelError(f"device fill service: {msg}")

    def _gate_open(self) -> bool:
        """Latency-governor half of the admission gate (no reservation):
        False while the round-trip EMA says responses come back slower
        than the deferred window can hide.  Shared across forks/workers;
        decays on rejected peeks so a recovered service gets retried."""
        v = self._lat_sh.value if self._lat_sh is not None else -1.0
        if 0 <= v <= MAX_LAT_S:
            return True
        if v > MAX_LAT_S:
            with self._lat_sh.get_lock():
                self._lat_sh.value *= 0.995
            return False
        # no estimate yet (service fresh): admit conservatively so the
        # first deferred windows cannot pile a seconds-deep backlog
        # before the first round-trip measurement lands
        ctr = self._pending
        return ctr is None or ctr.value < min(512, MAX_INFLIGHT_JOBS)

    def _reserve(self, n: int) -> bool:
        if not self._gate_open():
            return False
        ctr = self._pending
        if ctr is None:
            return True
        with ctr.get_lock():
            if ctr.value >= MAX_INFLIGHT_JOBS:
                return False
            ctr.value += n
        return True

    def _admit(self, n: int, routes=None) -> bool:
        """Backpressure gate: reserve n in-flight job slots, or report
        the service saturated (the caller host-fills instead of
        queueing).  Applies BOTH halves, the latency governor and the
        in-flight cap, and counts the route in ``routes`` (default: the
        fill kind's)."""
        # the governor closes on this estimate; below it (or with no
        # estimate yet) a refusal is the in-flight cap's
        lat = self._lat_sh.value if self._lat_sh is not None else -1.0
        admitted = self._reserve(n)
        if admitted:
            self.offloaded_jobs += n
        else:
            self.bounced_jobs += n
        kind = (OFFLOADED if admitted else
                GOVERNED if lat > MAX_LAT_S else CAPPED)
        _count(self._routes if routes is None else routes, kind, n)
        return admitted

    def _release(self, box) -> None:
        ctr = self._pending
        if ctr is not None and box is not None:
            n = box.get("n", 0)
            if n:
                box["n"] = 0
                with ctr.get_lock():
                    ctr.value -= n

    def accepting(self) -> bool:
        """Non-reserving saturation peek: False means a submit would be
        bounced by the in-flight cap, or is likely to come back slower
        than the deferred window can hide (latency governor), so the
        caller should take its host path up-front (refine_chain's
        window-branch gate)."""
        if self.failed or not self._server_ready():
            return False
        if not self._gate_open():
            return False
        ctr = self._pending
        return ctr is None or ctr.value < MAX_INFLIGHT_JOBS

    def _server_ready(self) -> bool:
        """Non-blocking: host fills until the service is warm, and for
        good after a calibrated no-go; raises after a service failure."""
        self._check()
        if self._ready_cache or self.failed:
            return self._ready_cache and not self.failed
        if not self._ready_evt.is_set():
            return False
        if self._status.value == DECLINED:
            self.failed = True
            return False
        self._ready_cache = True
        return True

    def _recv_one(self, poll_s: float) -> bool:
        """Read and route at most one response message, holding the
        queue's cross-process lock only while data is available.  True
        when a message was routed."""
        q = self.resp_q
        if not q._rlock.acquire(timeout=poll_s):
            return False
        try:
            if not q._reader.poll(poll_s):
                return False
            buf = q._reader.recv_bytes()
        finally:
            q._rlock.release()
        req_id, msg, t_sent = pickle.loads(buf)
        with self._lock:
            box = self._events.pop(req_id, None)
        if box is not None:
            self._release(box)
            # the round trip ends when the service sends the response (one
            # monotonic clock for all processes of this host), not when
            # this worker drains it: a response drained late, at the pop
            # of a deferred window, has kept no one waiting
            lat = t_sent - box["t0"]
            if self._lat_sh is not None:
                with self._lat_sh.get_lock():
                    v = self._lat_sh.value
                    self._lat_sh.value = lat if v < 0 else 0.7 * v + 0.3 * lat
            box["msg"] = msg
            box["event"].set()
        return True

    def _drain_until(self, box, timeout: float) -> bool:
        """Drive response draining until ``box`` resolves (True) or the
        deadline passes (False).  Concurrent waiters take turns: one
        drains, the rest park briefly on their own events."""
        deadline = time.monotonic() + timeout
        while True:
            if box["event"].is_set():
                return True
            if self._drain_lock.acquire(blocking=False):
                try:
                    if not box["event"].is_set():
                        self._recv_one(0.05)
                finally:
                    self._drain_lock.release()
            else:
                box["event"].wait(0.02)
            if box["event"].is_set():
                return True
            if time.monotonic() >= deadline:
                return False

    def __call__(self, pairs, eqx: bool = False):
        return self.align_batch(pairs, eqx)

    def align_batch(self, pairs, eqx: bool = False, timeout: float = WAIT_S):
        return self.wait(self.submit(pairs, eqx), timeout=timeout)

    # -- async interface ----------------------------------------------
    def _host_queue(self, pairs, eqx):
        with self._hb_lock:
            if self._hb is None:
                self._hb = HostBatchFillAligner()
            return self._hb.submit(pairs, eqx)

    def _host_wait(self, hq):
        with self._hb_lock:
            return self._hb.wait(hq)

    def submit(self, pairs, eqx: bool = False):
        self._check()
        if not pairs:
            return (None, None, pairs, eqx)
        _count(self._routes, SUBMITTED, len(pairs))
        if (self.failed or not self._server_ready()
                or not self._admit(len(pairs))):
            return ("hostq", self._host_queue(pairs, eqx), pairs, eqx)
        box = {"event": threading.Event(), "msg": None, "n": len(pairs),
               "t0": time.monotonic()}
        with self._lock:
            req_id = self._next_id
            self._next_id += 1
            self._events[req_id] = box
        self.req_q.put((self.worker_id, req_id, *pack_pairs(pairs)))
        return (box, req_id, pairs, eqx)

    def wait(self, handle, timeout: Optional[float] = None):
        """Resolve a submit.  An error response, a failed service, or no
        response within ``timeout`` (default WAIT_S) raises
        DeviceKernelError."""
        box, req_id, pairs, eqx = handle
        if box is None:
            return []
        if box == "hostq":
            return self._host_wait(req_id)
        timeout = WAIT_S if timeout is None else timeout
        if not self._drain_until(box, timeout):
            with self._lock:
                stale = self._events.pop(req_id, None)
            self._release(stale)
            self._check()
            raise DeviceKernelError(
                f"device fill service: no response in {timeout:.0f} s")
        return decode_response(box["msg"], pairs, eqx)

    def edit_batch(self, pairs, timeout: float = WAIT_S):
        """Exact edit distances from the service's edit kernel; a None
        entry is the caller's to resolve on the host.  This call is
        synchronous, so it answers all None at once, with no round trip,
        unless the service reports a live edit kernel and the admission
        gate is open.  A request that was sent is never redone on the
        host: an error response, a failed service or no response within
        ``timeout`` raises DeviceKernelError."""
        self._check()
        n = len(pairs)
        if not n:
            return []
        routes = self._edit_routes
        _count(routes, SUBMITTED, n)
        if (self.failed or self._edit_val is None or not self._edit_val.value
                or not self._server_ready()):
            _count(routes, NOT_LIVE, n)
            return [None] * n
        if not self._admit(n, routes):
            return [None] * n
        box = {"event": threading.Event(), "msg": None, "n": n,
               "t0": time.monotonic()}
        with self._lock:
            req_id = self._next_id
            self._next_id += 1
            self._events[req_id] = box
        self.req_q.put((self.worker_id, req_id, *pack_pairs(pairs), "edit"))
        if not self._drain_until(box, timeout):
            with self._lock:
                stale = self._events.pop(req_id, None)
            self._release(stale)
            self._check()
            raise DeviceKernelError(
                f"device fill service: no edit response in {timeout:.0f} s")
        return decode_edit_response(box["msg"], n)
