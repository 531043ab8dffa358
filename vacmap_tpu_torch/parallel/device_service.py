"""Cross-read aggregation of device calls (counterpart of
``vacmap_tpu/parallel/device_service.py``).

The finishing threads of the batched executor each ask for a few local
chain DPs per read.  ``TorchAggregatingChainBackend`` merges the chain
jobs of concurrently finishing reads into one kernel launch per
parameter group (the fills go through the fill service,
``parallel/fill_service.py``); given a device list, each launch runs
split over it (``parallel/mesh.ShardedChainStep``).  A device error is
raised to every waiting caller; nothing falls back to the host.
"""

from __future__ import annotations

import threading
import time
from typing import List

import torch

from ..device import DeviceKernelError
from ..ops.chain import chain_results, device_chainable
from .mesh import cached_chain_step

# a dispatcher stops waiting for peers once this many jobs queue up
MAX_JOBS = 512


class TorchAggregatingChainBackend:
    """chain_read/chain_local-compatible device backend that merges the
    chain DP jobs of concurrently-finishing reads into ONE
    chain_scores_batch launch per parameter group.

    Call shape: backend(A, variant, kmersize, skipcost, maxdiff, maxgap)
    -> ChainResult | None (None = the caller takes the host DP:
    host-only variant, >2^31 coordinates or oversized job).  Jobs group
    by the full parameter tuple.  A failed device call raises
    DeviceKernelError in every waiting caller.  ``devices``: a device
    list; each group's launch then runs split over it, one cached step a
    parameter set."""

    def __init__(self, device, max_wait_ms: float = 4.0, devices=None):
        self.device = torch.device(device)
        self.devices = None if devices is None else list(devices)
        self._steps = {}
        self._max_wait = max_wait_ms / 1e3
        self._lock = threading.Lock()
        self._queue: List[dict] = []
        self._dispatching = False

    def __call__(self, A, variant, kmersize, skipcost, maxdiff, maxgap):
        if variant in ("scar", "asm_fine"):
            return None  # host-only variants (R/asm local routines)
        if len(A) == 0 or not device_chainable(A):
            return None
        req = {
            "A": A, "key": (variant, kmersize, float(skipcost),
                            int(maxdiff), int(maxgap)),
            "event": threading.Event(), "result": None, "error": None,
        }
        with self._lock:
            self._queue.append(req)
            dispatcher = not self._dispatching
            if dispatcher:
                self._dispatching = True
        if dispatcher:
            self._dispatch()
        req["event"].wait()
        if req["error"] is not None:
            raise req["error"]
        return req["result"]

    def _dispatch(self):
        deadline = time.monotonic() + self._max_wait
        while time.monotonic() < deadline:
            with self._lock:
                if len(self._queue) >= MAX_JOBS:
                    break
            time.sleep(0.001)
        with self._lock:
            batch = self._queue
            self._queue = []
            self._dispatching = False
        try:
            groups = {}
            for r in batch:
                groups.setdefault(r["key"], []).append(r)
            for (variant, kmersize, skipcost, maxdiff, maxgap), reqs \
                    in groups.items():
                # batch dim padded to a power of two (padded rows have
                # n_valid = 0 and cost the kernel nothing)
                B2 = 8
                while B2 < len(reqs):
                    B2 *= 2
                res = chain_results(
                    self.device, [r["A"] for r in reqs], variant, kmersize,
                    skipcost, maxdiff, maxgap, pad_B=B2,
                    step=cached_chain_step(self._steps, self.devices, variant,
                                           kmersize, skipcost, maxdiff,
                                           maxgap))
                for r, cr in zip(reqs, res):
                    r["result"] = cr
        except Exception as err:
            for r in batch:
                if r["result"] is None:
                    r["error"] = err
        finally:
            for r in batch:
                if r.get("result") is None and r.get("error") is None:
                    r["error"] = DeviceKernelError("chain dispatch interrupted")
                r["event"].set()

