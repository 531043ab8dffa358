"""Per-read mapping routine: seed -> global chain -> local re-chain ->
extend/CIGAR -> SAM.

Equivalent of ``get_readmap_DP_test`` plus the worker formatting step
(mammap_clrnano.py:24023-24084, :24086-24155).
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from .. import trace
from ..config import AlignerConfig
from ..device import DeviceKernelError
from ..index.index import ReferenceIndex
from ..seq import decode, encode, revcomp_codes
from .chaining import chain_read
from .extend import PendingRefine, RefView, refine_chain
from .local import local_rechain
from .sam import paired_indel, records_to_sam

log = logging.getLogger(__name__)


class _PendingRecords:
    """map_read_records whose device fill batch is in flight."""

    __slots__ = ("_pending", "_finish")

    def __init__(self, pending, finish):
        self._pending = pending
        self._finish = finish

    def finish(self):
        return self._finish(self._pending.finish())


class PendingLines:
    """A deferred map_read: ``finish()`` -> SAM text lines."""

    __slots__ = ("_fn",)

    def __init__(self, fn):
        self._fn = fn

    def finish(self) -> List[str]:
        return self._fn()


class Mapper:
    """Maps reads against a loaded ReferenceIndex under an AlignerConfig.

    ``extension_aligner`` / ``global_aligner`` hooks allow the device
    batched aligners to replace the host reference aligner.  ``device``
    ("cuda", "cuda:N" or "cpu") is where the chain backends of
    ``config.backend == "jax"`` run; the other backends never touch it.
    """

    def __init__(
        self,
        index: ReferenceIndex,
        config: AlignerConfig,
        extension_aligner=None,
        global_aligner=None,
        chain_backend=None,
        device="cuda",
    ):
        self.index = index
        self.config = config
        self.ref = RefView(
            index.seq_codes, index.contig_starts, index.contig_lens,
            index.contig_names,
        )
        self.extension_aligner = extension_aligner
        self.global_aligner = global_aligner
        self.stream_backend = None
        if config.backend == "jax":
            # --backend jax: the chain DP kernels on ``device``, per call
            # for reads and small contigs, and per anchor block with the
            # carried frontier for the asm streaming chain.  A device that
            # was asked for and is absent raises here.
            from ..device import resolve_device
            from ..ops.chain import TorchChainBackend, TorchStreamChainBackend

            dev = resolve_device(str(device))
            if chain_backend is None:
                chain_backend = TorchChainBackend(dev)
            self.stream_backend = TorchStreamChainBackend(dev)
        # base-level alignment defaults to the native C++ kernels (the
        # batched executor and the fill service swap in the device fills)
        self.chain_backend = chain_backend

    # ------------------------------------------------------------------
    def ref_fetch_str(self, contig: str, start: int, end: int) -> str:
        g = self.index.start_of(contig)
        return decode(self.index.seq_codes[g + start : g + end])

    # ------------------------------------------------------------------
    def map_read_records(self, name: str, seq: str, precomputed=None,
                         defer_fill: bool = False):
        """Run the mapping pipeline; returns (records, filtered_redo_used)
        where records are (readid, contig, strand, q_st, q_en, r_st, r_en,
        mapq, cigar) rows.

        ``precomputed`` is an optional (need_reverse, sorted_anchors,
        ChainResult) triple from the batched executor; seeding and the
        global DP are skipped when provided.

        ``defer_fill=True`` (with an async global_aligner): when the
        pipeline reaches the device fill batch, returns a pending object
        whose ``finish()`` yields (records, redo) — the caller overlaps
        other reads with the in-flight device work.
        """
        cfg = self.config
        p = cfg.preset
        with trace.span("prep"):
            seq = seq.upper()
            read_len = len(seq)
            codes = encode(seq)
            rc_codes = revcomp_codes(codes)

        if precomputed is None:
            with trace.span("seed"):
                anchors = self.index.seeds(seq, check_num=cfg.check_num)
            if len(anchors) <= 2:
                return [], False
        else:
            anchors = precomputed[1]

        skip_g, maxdiff_g, maxgap_g = cfg.chain_params_global()
        with trace.span("global_chain"):
            gc = chain_read(
                anchors,
                read_len,
                kmersize=self.index.k,
                skipcost=skip_g,
                maxdiff=maxdiff_g,
                maxgap=maxgap_g,
                accept_score=p.accept_score,
                refund=p.refund_penalty,
                cov_adapt=p.cov_adapt,
                chain_backend=self.chain_backend,
                precomputed=precomputed,
                tie_break_seqs=(
                    (codes, rc_codes, self.ref) if p.mapq0_tie_break else None
                ),
            )
        if gc is None:
            return [], False

        # local re-chain runs in the normalized orientation: when the read
        # was strand-flipped, the "read" handed downstream is its reverse
        # complement (mammap_clrnano.py:24056-24066)
        if gc.need_reverse:
            fwd_codes, rev_codes = rc_codes, codes
        else:
            fwd_codes, rev_codes = codes, rc_codes

        skip_l, maxdiff_l, maxgap_l = cfg.chain_params_local()
        with trace.span("local_rechain"):
            score, path_desc = local_rechain(
                gc.paths,
                fwd_codes,
                rev_codes,
                self.index.seq_codes,
                self.index.contig_starts,
                self.index.contig_lens,
                kmersize=cfg.local_kmersize,
                skipcost=skip_l,
                maxdiff=maxdiff_l,
                maxgap=maxgap_l,
                guide_cap=p.guide_chain_cap,
                chain_backend=self.chain_backend,
                scar=p.local_scar,
                asm_single=p.local_single_guide,
                as_array=True,
            )
        if len(path_desc) <= 1:
            return [], False

        # always align with =/X internally: NM becomes a pure CIGAR sum
        # (no base re-comparison) and MD/cs are always computable; output
        # collapses to M unless --eqx (SURVEY.md hard part e)
        eqx_internal = True
        nodiscard = cfg.resolved_nodiscard
        path_asc = path_desc[::-1]

        def _refine(nofilt: bool, defer: bool):
            return refine_chain(
                path_asc,
                name,
                gc.mapq,
                fwd_codes,
                rev_codes,
                read_len,
                self.ref,
                maxdiff=maxdiff_l,
                need_reverse=gc.need_reverse,
                max_divergence=cfg.resolved_max_divergence,
                use_hardclip=cfg.hardclip,
                nofilter=nofilt,
                eqx=eqx_internal,
                extension_aligner=self.extension_aligner,
                global_aligner=self.global_aligner,
                simple_inv_full=p.simple_inv_full,
                rebuild_dup_overlap=p.rebuild_dup_overlap,
                rebuild_small_alignment=p.rebuild_small_alignment,
                split_force_gap=p.split_force_gap,
                defer_fill=defer,
            )

        def _finish(result):
            segs, records, filtered = result
            if not records:
                return [], False
            # paired-indel redo without the misplaced-segment filter
            # (mammap_clrnano.py:24079-24080); rare, so the redo's own
            # fill batch runs synchronously even in deferred mode
            redo = False
            if (not nodiscard and filtered
                    and paired_indel([r[-1] for r in records])):
                redo = True
                # own top-level span: in deferred mode this runs in the
                # continuation, outside the original `refine` span
                with trace.span("refine_redo"):
                    res2 = _refine(True, False)
                segs, records, filtered = res2
            return records, redo

        with trace.span("refine"):
            result = _refine(nodiscard, defer_fill)
        if isinstance(result, PendingRefine):
            return _PendingRecords(result, _finish)
        return _finish(result)

    # ------------------------------------------------------------------
    def map_read(
        self,
        name: str,
        seq: str,
        qual: Optional[str] = None,
        comment: Optional[str] = None,
    ) -> List[str]:
        """Map one read and return SAM text lines (no trailing newline)."""
        cfg = self.config
        try:
            records, _ = self.map_read_records(name, seq)
        except DeviceKernelError:  # a device fault stops the run
            raise
        except Exception as err:  # per-read isolation (mammap:24116-24125)
            if cfg.debug:
                log.error("read %s failed: %s", name, err)
            return []
        return self._emit_sam(name, records, seq, qual, comment)

    def map_read_deferred(self, name, seq, qual=None, comment=None):
        """map_read with the device fill batch left in flight: returns
        either finished SAM lines (host path / early exit) or a
        PendingLines whose ``finish()`` completes the read.  Drives the
        async TPU deployment: the worker keeps a window of in-flight
        reads instead of blocking per read."""
        cfg = self.config
        try:
            res = self.map_read_records(name, seq, defer_fill=True)
        except DeviceKernelError:  # a device fault stops the run
            raise
        except Exception as err:
            if cfg.debug:
                log.error("read %s failed: %s", name, err)
            return []
        if not isinstance(res, _PendingRecords):
            return self._emit_sam(name, res[0], seq, qual, comment)

        def _done():
            try:
                records, _ = res.finish()
            except DeviceKernelError:  # a device fault stops the run
                raise
            except Exception as err:
                if cfg.debug:
                    log.error("read %s failed: %s", name, err)
                return []
            return self._emit_sam(name, records, seq, qual, comment)

        return PendingLines(_done)

    def _emit_sam(self, name, records, seq, qual, comment) -> List[str]:
        cfg = self.config
        if not records:
            return []
        try:
            with trace.span("sam_emit"):
                return self._records_to_sam(name, records, seq, qual,
                                            comment)
        except Exception as err:
            if cfg.debug:
                log.error("read %s SAM emission failed: %s", name, err)
            return []

    def _records_to_sam(self, name, records, seq, qual, comment):
        cfg = self.config
        return records_to_sam(
            records,
            seq.upper(),
            None if cfg.ignore_quals else qual,
            self.ref_fetch_str,
            md=cfg.md,
            cs=cfg.cs,
            short_cs=cfg.shortcs,
            cigar2cg=cfg.cigar2cg,
            markunbalancetra=cfg.resolved_markunbalancetra,
            hardclip=cfg.hardclip,
            fakecigar=cfg.fakecigar,
            rg_id=cfg.rg_id,
            comment=comment if cfg.copycomments else None,
            collapse_eqx=not cfg.resolved_eqx,
            keep_order=cfg.preset.emit_keep_order,
            mapq_quantize=cfg.preset.emit_mapq_quantize,
        )

    # ------------------------------------------------------------------
    def map_contig(
        self,
        name: str,
        seq: str,
        qual: Optional[str] = None,
        comment: Optional[str] = None,
    ) -> List[str]:
        """asm mode: contigs < 500 kb use the normal per-read path with the
        cluster cap disabled; larger contigs run the out-of-core streaming
        chain (mammap_asm.py:23205-23206)."""
        from .asm import STREAM_THRESHOLD, map_contig_streaming

        import dataclasses

        cfg = self.config
        if len(seq) < STREAM_THRESHOLD:
            old_cfg = self.config
            self.config = dataclasses.replace(cfg, check_num=0)
            try:
                return self.map_read(name, seq, qual, comment)
            finally:
                self.config = old_cfg
        workdir = None
        if cfg.workdir:
            workdir = f"{cfg.workdir.rstrip('/')}/{name}"
        try:
            records = map_contig_streaming(self, name, seq, workdir=workdir)
        except DeviceKernelError:  # a device fault stops the run
            raise
        except Exception as err:
            log.error("contig %s is not aligned: %s", name, err)
            return []
        if not records:
            return []
        try:
            return records_to_sam(
                records,
                seq.upper(),
                None if cfg.ignore_quals else qual,
                self.ref_fetch_str,
                md=cfg.md,
                cs=cfg.cs,
                short_cs=cfg.shortcs,
                cigar2cg=cfg.cigar2cg,
                markunbalancetra=cfg.resolved_markunbalancetra,
                hardclip=cfg.hardclip,
                fakecigar=cfg.fakecigar,
                rg_id=cfg.rg_id,
                comment=comment if cfg.copycomments else None,
                collapse_eqx=not cfg.resolved_eqx,
                keep_order=cfg.preset.emit_keep_order,
                mapq_quantize=cfg.preset.emit_mapq_quantize,
            )
        except Exception as err:
            log.error("contig %s SAM emission failed: %s", name, err)
            return []

    # ------------------------------------------------------------------
    def header_lines(self, cli: Optional[str] = None) -> List[str]:
        lines = ["@HD\tVN:1.0"]
        for name, ln in zip(self.index.contig_names, self.index.contig_lens):
            lines.append(f"@SQ\tSN:{name}\tLN:{int(ln)}")
        if self.config.rg_id is not None:
            # default read group carries SM:sample like the reference
            # (vacmap:214-223, required by DeepSomatic/GATK tooling)
            sm = "\tSM:sample" if self.config.rg_id == "1" else ""
            lines.append(f"@RG\tID:{self.config.rg_id}{sm}")
        pg = "@PG\tID:vacmap-tpu\tPN:vacmap-tpu\tVN:0.1.0"
        if cli:
            pg += f"\tCL:{cli}"
        lines.append(pg)
        return lines
