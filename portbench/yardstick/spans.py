"""The traced run's own spans and launch captures, installed from outside
the program around the calls into each layer (no span is added inside
the program).

- ``seeding``: ``TorchBatchExecutor._prepare`` (the seeder thread);
- ``global_chain``: ``TorchBatchExecutor._device_chain``, read-back
  included;
- ``batch``: ``TorchBatchExecutor._run_prepared``, one batch from its
  hand-over to its records;
- the launches of ``ops.chain.chain_scores_batch`` (chain_dp.cu) and
  ``ops.affine_fill.fill_rowruns_banded`` (fill_banded.cu): each launch
  on the card takes the host arrays that its thread staged just before
  (``chain.prepare_batch``'s anchors, ``affine_fill.make_qshift``'s
  target lengths), so the capture copies nothing from the card and
  waits for nothing; the work they need (``work.py``) is counted once
  the window has closed (``work_totals``).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import numpy as np

from . import work


class Recorder:
    def __init__(self):
        self._lock = threading.Lock()
        self.spans = defaultdict(list)   # name -> [(start, end)], perf_counter
        self.work = defaultdict(list)    # kernel -> [(staged, kwargs)]
        self._staged = threading.local()
        self._undo = []

    def _add(self, name, t0, t1):
        with self._lock:
            self.spans[name].append((t0, t1))

    def wrap_method(self, obj, attr: str, name: str) -> None:
        orig = getattr(obj, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                self._add(name, t0, time.perf_counter())

        setattr(obj, attr, timed)
        self._undo.append(lambda: delattr(obj, attr))

    def wrap_staging(self, module, attr: str, keep) -> None:
        """Replace ``module.attr`` (a host function that stages a launch's
        inputs) by one that leaves ``keep(args, result)`` for the next
        launch of this thread."""
        orig = getattr(module, attr)

        def staged(*a, **kw):
            out = orig(*a, **kw)
            self._staged.last = keep(a, out)
            return out

        setattr(module, attr, staged)
        self._undo.append(lambda: setattr(module, attr, orig))

    def wrap_launch(self, module, attr: str, kernel: str) -> None:
        """Replace ``module.attr`` (a kernel wrapper that counts its own
        launches on the module's name) by one that also keeps, for a
        launch on the card, what its thread staged last; the counters
        stay those of the original."""
        orig = getattr(module, attr)

        def launch(*a, **kw):
            out = orig(*a, **kw)
            if a[0].device.type == "cuda":
                staged = getattr(self._staged, "last", None)
                self._staged.last = None
                with self._lock:
                    self.work[kernel].append((staged, kw))
            return out

        launch.launches = orig.launches
        launch.shapes = orig.shapes

        def undo():
            orig.launches = launch.launches
            setattr(module, attr, orig)

        setattr(module, attr, launch)
        self._undo.append(undo)

    def install(self, executor) -> None:
        from vacmap_tpu_torch.ops import affine_fill, chain

        self.wrap_method(executor, "_prepare", "seeding")
        self.wrap_method(executor, "_device_chain", "global_chain")
        self.wrap_method(executor, "_run_prepared", "batch")
        # prepare_batch(anchor_list, variant, ...) -> (anchors, n_valid, ...)
        self.wrap_staging(chain, "prepare_batch", lambda a, out: (
            work.barriers(out[0], a[1] in work.LOCAL_VARIANTS),
            np.array(out[1])))
        # make_qshift(tQ, t_len, q_len, T)
        self.wrap_staging(affine_fill, "make_qshift",
                          lambda a, out: (np.array(a[1], np.int64), a[3]))
        self.wrap_launch(chain, "chain_scores_batch", "chain_dp")
        self.wrap_launch(affine_fill, "fill_rowruns_banded", "fill_banded")

    def work_totals(self):
        """{kernel: (operations, bytes)} of the captured launches."""
        out = {}
        for (staged, _) in self.work.get("chain_dp", ()):
            if staged is None:
                continue
            o, b = work.chain_work_of(*staged)
            t = out.get("chain_dp", (0, 0))
            out["chain_dp"] = (t[0] + o, t[1] + b)
        for (staged, _) in self.work.get("fill_banded", ()):
            if staged is None:
                continue
            t_len, T = staged
            o, b = work.band_work(t_len, T)
            t = out.get("fill_banded", (0, 0))
            out["fill_banded"] = (t[0] + o, t[1] + b)
        return out

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def total(self, name: str, lo: float, hi: float) -> float:
        """Seconds of ``name``'s spans inside [lo, hi]."""
        return sum(max(0.0, min(b, hi) - max(a, lo))
                   for a, b in self.spans.get(name, ()))

    def open_at(self, t: float):
        """The names of the spans open at time ``t``."""
        return sorted({n for n, ss in self.spans.items()
                       if any(a <= t < b for a, b in ss)})
