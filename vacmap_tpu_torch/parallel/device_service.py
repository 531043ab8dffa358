"""Cross-read aggregation of device calls (counterpart of
``vacmap_tpu/parallel/device_service.py``).

The finishing threads of the batched executor each ask for a few local
chain DPs per read.  ``TorchAggregatingChainBackend`` merges the chain
jobs of concurrently finishing reads into one kernel launch per
parameter group (the executor's fills go through the fill service,
``parallel/fill_service.py``); given a device list, each launch runs
split over it (``parallel/mesh.ShardedChainStep``).
``AggregatingAligner`` does the same for any ``align_batch`` aligner
(``TorchFillAligner``, ``ops/affine_batch.BatchAligner``):
``device_fill_aligner`` puts it over the fill kernels.  A device error is
raised to every waiting caller; nothing falls back to the host.
"""

from __future__ import annotations

import threading
import time
from typing import List

import torch

from .. import trace
from ..device import DeviceKernelError
from ..ops.chain import MAX_N, chain_results, device_coords
from .mesh import cached_chain_step

# a dispatcher stops waiting for peers once this many jobs queue up
MAX_JOBS = 512


class _Aggregator:
    """The dispatch protocol of the cross-thread aggregators below, as the
    reference's: the first caller becomes the dispatcher; it waits
    ``max_wait_ms`` for peers to enqueue (less once ``max_jobs`` units
    wait), then groups the queue by key and runs each group with
    ``run_group(key, payloads) -> [result]``, one result a payload.
    Callers block on an event.  A DeviceKernelError reaches every waiting
    caller (the card is at fault, so no group runs after it); another
    error reaches the callers of its own group.  Every waiter wakes, even
    when the dispatcher is interrupted.

    Traced (``<what>_agg.*``): the dispatcher's wait for peers
    (``gather``) and its groups, launched and read back (``run``); a
    caller blocked on its event (``wait``); counters ``dispatches``,
    ``jobs`` (units) and ``overlap``: dispatches whose groups start while
    another dispatcher's still run (``_dispatching`` is cleared before
    the groups run)."""

    def __init__(self, run_group, max_wait_ms: float, max_jobs: int,
                 what: str):
        self._run_group = run_group
        self._max_wait = max_wait_ms / 1e3
        self._max_jobs = max_jobs
        self._what = what
        self._lock = threading.Lock()
        self._queue: List[dict] = []
        self._queued = 0
        self._dispatching = False
        self._running = 0  # dispatchers running groups (traced only)
        self._trace = {k: f"{what}_agg.{k}" for k in (
            "gather", "run", "wait", "dispatches", "jobs", "overlap")}

    def submit(self, key, payload, units: int = 1):
        """Queue one payload under ``key`` (``units`` of the cap) and block
        until its result is there."""
        req = {"key": key, "payload": payload, "event": threading.Event(),
               "result": None, "error": None}
        with self._lock:
            self._queue.append(req)
            self._queued += units
            dispatcher = not self._dispatching
            if dispatcher:
                self._dispatching = True
        if dispatcher:
            self._dispatch()  # sets every event of its batch, this one too
        else:
            with trace.span(self._trace["wait"]):
                req["event"].wait()
        if req["error"] is not None:
            raise req["error"]
        return req["result"]

    def _dispatch(self):
        names = self._trace
        # let peers pile on: a few ms of latency for one call instead of many
        with trace.span(names["gather"]):
            deadline = time.monotonic() + self._max_wait
            while time.monotonic() < deadline:
                with self._lock:
                    if self._queued >= self._max_jobs:
                        break
                time.sleep(0.001)
        traced = trace.enabled()
        with self._lock:
            batch = self._queue
            units = self._queued
            self._queue = []
            self._queued = 0
            self._dispatching = False
            if traced:
                overlapped = self._running > 0
                self._running += 1
        if traced:
            trace.count(names["dispatches"])
            trace.count(names["jobs"], units)
            trace.count(names["overlap"], overlapped)
        try:
            with trace.span(names["run"]):
                self._run_groups(batch)
        finally:
            if traced:
                with self._lock:
                    self._running -= 1
            # even on BaseException in the dispatcher every waiter wakes,
            # else the calling threads hang
            for r in batch:
                if r["result"] is None and r["error"] is None:
                    r["error"] = DeviceKernelError(
                        f"{self._what} dispatch interrupted")
                r["event"].set()

    def _run_groups(self, batch):
        groups = {}
        for r in batch:
            groups.setdefault(r["key"], []).append(r)
        for key, reqs in groups.items():
            try:
                results = self._run_group(key, [r["payload"] for r in reqs])
            except DeviceKernelError as err:
                for r in batch:
                    if r["result"] is None:
                        r["error"] = err
                return
            except Exception as err:  # noqa: BLE001 - to its callers
                for r in reqs:
                    r["error"] = err
                continue
            for r, res in zip(reqs, results):
                r["result"] = res


class AggregatingAligner:
    """Merges the ``align_batch`` calls of concurrent threads into one
    call of the wrapped aligner per ``eqx`` value (``_Aggregator``'s
    protocol; ``max_jobs`` counts pairs)."""

    def __init__(self, aligner, max_wait_ms: float = 4.0,
                 max_jobs: int = 8192):
        self._aligner = aligner
        self._agg = _Aggregator(self._run_group, max_wait_ms, max_jobs,
                                "align")

    # the refine_chain aligner interface: (pairs, eqx) -> [AlignResult]
    def __call__(self, pairs, eqx: bool = False):
        return self.align_batch(pairs, eqx)

    def align_batch(self, pairs, eqx: bool = False):
        if not pairs:
            return []
        return self._agg.submit(eqx, pairs, units=len(pairs))

    def _run_group(self, eqx, calls):
        results = self._aligner.align_batch(
            [p for pairs in calls for p in pairs], eqx=eqx)
        out, off = [], 0
        for pairs in calls:
            out.append(results[off : off + len(pairs)])
            off += len(pairs)
        return out


def device_fill_aligner(device, max_wait_ms: float = 4.0) -> AggregatingAligner:
    """A cross-thread batching aligner over the fill kernels
    (``TorchFillAligner`` on ``device``).  A card asked for and missing
    raises DeviceKernelError: there is no CPU fallback ("cpu" runs the
    plain versions because the caller asked for them)."""
    from ..device import resolve_device
    from ..ops.affine_fill import TorchFillAligner

    return AggregatingAligner(
        TorchFillAligner(device=resolve_device(str(device))),
        max_wait_ms=max_wait_ms)


class TorchAggregatingChainBackend:
    """chain_read/chain_local-compatible device backend that merges the
    chain DP jobs of concurrently-finishing reads into ONE
    chain_scores_batch launch per parameter group.

    Call shape: backend(A, variant, kmersize, skipcost, maxdiff, maxgap)
    -> ChainResult | None (None = the caller takes the host DP), the
    declines counted in ``declined`` by cause: "variant" (host-only),
    "size" (empty or over MAX_N anchors), "coords" (anchors that do not
    fit ``device_coords``); ``chained`` counts the jobs the device took.
    Jobs group by the full parameter tuple (``_Aggregator``'s protocol; a
    failed device call raises DeviceKernelError in every waiting caller;
    ``MAX_JOBS`` counts jobs).  ``devices``: a device
    list; each group's launch then runs split over it, one cached step a
    parameter set."""

    def __init__(self, device, max_wait_ms: float = 4.0, devices=None):
        self.device = torch.device(device)
        self.devices = None if devices is None else list(devices)
        self._steps = {}
        self._agg = _Aggregator(self._run_group, max_wait_ms, MAX_JOBS,
                                "chain")
        self._lock = threading.Lock()  # the counts
        self.chained = 0
        self.declined = {"variant": 0, "size": 0, "coords": 0}

    def __call__(self, A, variant, kmersize, skipcost, maxdiff, maxgap):
        # scar, asm_fine: host-only variants (R/asm local routines)
        why = ("variant" if variant in ("scar", "asm_fine")
               else "size" if len(A) == 0 or len(A) > MAX_N else None)
        D = None if why else device_coords(A, maxdiff)
        if why is None and D is None:
            why = "coords"
        if why is not None:
            with self._lock:
                self.declined[why] += 1
            return None
        return self._agg.submit(
            (variant, kmersize, float(skipcost), int(maxdiff), int(maxgap)), D)

    def _run_group(self, key, coords):
        variant, kmersize, skipcost, maxdiff, maxgap = key
        # batch dim padded to a power of two (padded rows have n_valid = 0
        # and cost the kernel nothing)
        B2 = 8
        while B2 < len(coords):
            B2 *= 2
        res = chain_results(
            self.device, coords, variant, kmersize, skipcost, maxdiff, maxgap,
            pad_B=B2, step=cached_chain_step(self._steps, self.devices,
                                             variant, kmersize, skipcost,
                                             maxdiff, maxgap))
        with self._lock:
            self.chained += len(coords)
        return res
