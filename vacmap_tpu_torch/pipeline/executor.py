"""Batched mapping executor on one torch device (counterpart of
``vacmap_tpu/pipeline/executor.py``).

Reads are processed in batches: host seeding, then the global chain DP
of the whole batch as one kernel launch per anchor-count bucket, then the
per-read finish (backtrack, local re-chain, refinement, SAM) on host
threads.  The finishing reads' local fine/mismatch DPs merge into device
chain launches and their base-level fills into device fill launches.

Identical results to ``Mapper.map_read``.  Repeat-dense reads (anchors/bp
> 5), reads over the largest bucket and reads whose anchors reach 2^31
take the host DP.  Host errors drop the read, as in the reference; a
device error (DeviceKernelError) stops the run.
"""

from __future__ import annotations

import concurrent.futures
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vacmap_tpu.ops.chain_ref import ChainResult
from vacmap_tpu.pipeline.chaining import prepare_read_anchors
from vacmap_tpu.pipeline.mapper import Mapper
from vacmap_tpu.pipeline.sam import records_to_sam

from ..device import DeviceKernelError
from ..ops.chain import chain_results, device_chainable
from ..parallel.device_service import (
    TorchAggregatingChainBackend, device_fill_aligner,
)

# anchor-count buckets of the global chain launches (reference semantics)
N_BUCKETS = (512, 2048, 8192)


class TorchBatchExecutor:
    def __init__(self, mapper: Mapper, device="cpu",
                 max_device_batch: int = 128, device_fills: bool = True,
                 device_local_dp: bool = True):
        self.mapper = mapper
        self.device = torch.device(device)
        self.max_device_batch = max_device_batch
        if device_local_dp and mapper.chain_backend is None:
            mapper.chain_backend = TorchAggregatingChainBackend(self.device)
        if device_fills and mapper.global_aligner is None:
            mapper.global_aligner = device_fill_aligner(self.device)

    # ------------------------------------------------------------------
    def _device_chain(self, arrays: List[np.ndarray], variant: str,
                      skipcost: float, maxdiff: int, maxgap: int,
                      kmersize: int) -> List[Optional[ChainResult]]:
        """Global chain DP of many reads, one launch per anchor-count
        bucket and chunk; None for a read the kernel cannot take (the
        host DP takes it)."""
        out: List[Optional[ChainResult]] = [None] * len(arrays)
        groups = {}
        for i, a in enumerate(arrays):
            if not device_chainable(a):
                continue
            for b in N_BUCKETS:
                if len(a) <= b:
                    groups.setdefault(b, []).append(i)
                    break
        for bucket, idxs in groups.items():
            for cs in range(0, len(idxs), self.max_device_batch):
                chunk = idxs[cs : cs + self.max_device_batch]
                # N padded to the bucket so shapes stay canonical
                res = chain_results(
                    self.device, [arrays[i] for i in chunk], variant,
                    kmersize, skipcost, maxdiff, maxgap, pad_N=bucket)
                for i, r in zip(chunk, res):
                    out[i] = r
        return out

    # ------------------------------------------------------------------
    def _prepare(self, reads: Sequence[Tuple]):
        """Stage 1 (host): seeding + strand normalization for a batch."""
        m = self.mapper
        cfg = m.config
        prepped = []
        for r in reads:
            name, seq = r[0], r[1].upper()
            anchors = m.index.seeds(seq, check_num=cfg.check_num)
            if len(anchors) <= 2:
                prepped.append(None)
                continue
            need_reverse, A = prepare_read_anchors(anchors, len(seq))
            dense = len(A) / max(len(seq), 1) > 5 or len(A) > N_BUCKETS[-1]
            prepped.append((name, seq, need_reverse, A, dense))
        return prepped

    def _run_prepared(self, reads, prepped, n_threads: int) -> List[List[str]]:
        """Stages 2+3: batched device chain, then threaded host finish."""
        m = self.mapper
        cfg = m.config
        p = cfg.preset
        kmersize = m.index.k
        skip_g, maxdiff_g, maxgap_g = cfg.chain_params_global()
        variant = "refund" if p.refund_penalty else (
            "global" if p.cov_adapt else "global_nocov"
        )

        dev_idx = [
            i for i, pr in enumerate(prepped) if pr is not None and not pr[4]
        ]
        dev_results = self._device_chain(
            [prepped[i][3] for i in dev_idx], variant, skip_g, maxdiff_g,
            maxgap_g, kmersize,
        )
        res_by_read = {i: r for i, r in zip(dev_idx, dev_results)}

        def finish(i: int) -> List[str]:
            pr = prepped[i]
            if pr is None:
                return []
            name, seq, need_reverse, A, dense = pr
            r = reads[i]
            qual = r[2] if len(r) > 2 else None
            comment = r[3] if len(r) > 3 else None
            pre = None
            if not dense and res_by_read.get(i) is not None:
                pre = (need_reverse, A, res_by_read[i])
            return self._finish_read(name, seq, qual, comment, pre)

        with concurrent.futures.ThreadPoolExecutor(n_threads) as pool:
            return list(pool.map(finish, range(len(reads))))

    def map_batch(
        self, reads: Sequence[Tuple], n_threads: int = 4
    ) -> List[List[str]]:
        """reads: sequence of (name, seq[, qual[, comment]]).  Returns SAM
        lines per read (same order)."""
        return self._run_prepared(reads, self._prepare(reads), n_threads)

    def map_stream(self, records, batch_reads: int, n_threads: int = 4):
        """Pipelined mapping over a record stream: batch N+1's seeding
        runs on a background thread while batch N's device work and host
        refinement proceed.  Yields per-read SAM line lists in input
        order."""
        it = iter(records)

        def take():
            batch = list(itertools.islice(it, batch_reads))
            return batch, (self._prepare(batch) if batch else [])

        with concurrent.futures.ThreadPoolExecutor(1) as seeder:
            fut = seeder.submit(take)
            while True:
                batch, prepped = fut.result()
                if not batch:
                    break
                fut = seeder.submit(take)
                yield from self._run_prepared(batch, prepped, n_threads)

    # ------------------------------------------------------------------
    def _finish_read(self, name, seq, qual, comment, precomputed):
        """Identical to Mapper.map_read but reusing a precomputed global
        chain result.  Host errors drop the read as the reference does;
        device errors propagate."""
        m = self.mapper
        cfg = m.config
        try:
            records, _ = m.map_read_records(name, seq, precomputed=precomputed)
        except DeviceKernelError:
            raise
        except Exception:
            return []
        if not records:
            return []
        try:
            return records_to_sam(
                records, seq.upper(),
                None if cfg.ignore_quals else qual,
                m.ref_fetch_str,
                md=cfg.md, cs=cfg.cs, short_cs=cfg.shortcs,
                cigar2cg=cfg.cigar2cg,
                markunbalancetra=cfg.resolved_markunbalancetra,
                hardclip=cfg.hardclip, fakecigar=cfg.fakecigar,
                rg_id=cfg.rg_id,
                comment=comment if cfg.copycomments else None,
                collapse_eqx=not cfg.resolved_eqx,
                keep_order=cfg.preset.emit_keep_order,
                mapq_quantize=cfg.preset.emit_mapq_quantize,
            )
        except Exception:
            return []
