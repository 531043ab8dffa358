"""Typed, frozen configuration for vacmap-tpu.

The reference threads a single mutable dict ``pdict`` through every layer
(reference ``src/vacmap/vacmap:177-296``).  Here modes are frozen preset
tables and the aligner config is an immutable dataclass, so the whole
configuration can be hashed and used as a static argument to jitted
functions.

Mode semantics (reference cites):
  * defaults per mode: ``vacmap:257-283``
  * H vs L deltas (accept threshold, local maxgap, guide cap, local skipcost
    cap): ``mammap_clrnano.py:23650,24061,28581`` vs ``mammap_ccs.py``
  * markunbalancetra / nodiscard defaults: ``vacmap:286-296``
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModePreset:
    """Per-mode algorithm constants.

    Attributes mirror the reference's mode deltas (SURVEY.md section 2.3).
    """

    name: str
    # chaining penalties (reference: pdict['golbal_skipcost'] / 'local_skipcost')
    global_skipcost: float
    local_skipcost: float
    max_divergence: float
    # minimum best-chain score to accept a read
    # (reference: mammap_clrnano.py:23650 `max_scores > 60`; ccs/sensitive use 40)
    accept_score: float
    # cap on number of guide chains refined by the local re-chain
    # (reference: mammap_clrnano.py:28581 `count > 5`; ccs 3; sensitive unlimited)
    guide_chain_cap: int  # 0 means unlimited
    # maxgap for the local (k=9) chaining DP
    # (reference: mammap_clrnano.py:24061 maxgap=99; ccs 50)
    local_maxgap: int
    # L mode caps the local skipcost at 40 before the local DP (mammap_ccs.py)
    local_skipcost_cap: Optional[float]
    # R mode: flat SV penalty with refund ledger, no distance term, no
    # repeat-coverage adaptation (mammap_noprefercloser.py:22288-22446)
    refund_penalty: bool
    # default flag values (vacmap:286-296)
    markunbalancetra: bool
    nodiscard: bool
    # asm streaming mode
    streaming: bool = False
    # asm-mode global DPs use FLAT skipcost (no adaptive repeat coverage:
    # mammap_asm.py:20552/:21687 have no coverage_dict, unlike the read
    # modes' mark_a blocks)
    cov_adapt: bool = True
    # the asm module's rebuild_chain_break uses a plain refgap >= 0 accept
    # (no -20 duplication-overlap tolerance; mammap_asm.py live def)
    rebuild_dup_overlap: bool = True
    # decode_hit's mapq-0 primary re-selection by main-block edit
    # distance is live in H/L/S/asm but COMMENTED OUT in R
    # (mammap_noprefercloser.py decode_hit)
    mapq0_tie_break: bool = True
    # minimum segment span kept by rebuild_chain_break in extend_func:
    # 50 in the read modes, 40 in asm's live extend_func (its streaming
    # ass_extend_func uses 30, passed explicitly there)
    rebuild_small_alignment: int = 50
    # asm's split_alignment_test forces a CIGAR window at junctions with
    # max(readgap, refgap) >= 2000, bounding per-window DP size on contigs
    # (mammap_asm.py live def); 0 = no forced split (read modes)
    split_force_gap: int = 0
    # the R and asm modules carry a STALE fix_simple_inv whose
    # refen_0 > refst_1 branch is inert (mammap_noprefercloser.py:17155,
    # mammap_asm.py:17159); H/L/S have the full version
    simple_inv_full: bool = True
    # R mode's live local re-chain routine skips merge/drop/cap, harvests
    # with +-2kb/+-500 margins and runs the "scar" DP
    # (mammap_noprefercloser.py live guide_list/guide_1/fine_list_scar)
    local_scar: bool = False
    # asm's local re-chain uses the PRIMARY guide only with +-2kb/+-500
    # margins and the plain fine DP — no merge/drop/cap
    # (mammap_asm.py live get_localmap_multi_all_forDP_inv_guide)
    local_single_guide: bool = False
    # R and asm SAM emitters keep the upstream record order (their sort
    # key ``sortbycontig`` returns x[0] = readid, a stable no-op) and
    # demote a mapq-1 first record when the second isn't mapq 1
    # (mammap_noprefercloser.py / mammap_asm.py live get_bam_dict_str);
    # H/L/S sort by query-span length descending, longest = primary
    emit_keep_order: bool = False
    # asm's emitter quantizes MAPQ (and SA mq) to 60 when nonzero else 1
    # (mammap_asm.py live get_bam_dict_str)
    emit_mapq_quantize: bool = False


_PRESETS = {
    "H": ModePreset(
        name="H",
        global_skipcost=40.0,
        local_skipcost=40.0,
        max_divergence=0.2,
        accept_score=60.0,
        guide_chain_cap=5,
        local_maxgap=99,
        local_skipcost_cap=None,
        refund_penalty=False,
        markunbalancetra=True,
        nodiscard=False,
    ),
    "L": ModePreset(
        name="L",
        global_skipcost=40.0,
        local_skipcost=59.0,
        max_divergence=0.1,
        accept_score=40.0,
        guide_chain_cap=3,
        local_maxgap=50,
        local_skipcost_cap=40.0,
        refund_penalty=False,
        markunbalancetra=True,
        nodiscard=False,
    ),
    "S": ModePreset(
        name="S",
        global_skipcost=30.0,
        local_skipcost=30.0,
        max_divergence=0.5,
        accept_score=40.0,
        guide_chain_cap=0,
        local_maxgap=99,
        local_skipcost_cap=None,
        refund_penalty=False,
        markunbalancetra=False,
        nodiscard=True,
    ),
    "R": ModePreset(
        name="R",
        global_skipcost=30.0,
        local_skipcost=30.0,
        max_divergence=0.5,
        accept_score=60.0,
        guide_chain_cap=5,
        local_maxgap=99,
        local_skipcost_cap=None,
        refund_penalty=True,
        simple_inv_full=False,
        local_scar=True,
        emit_keep_order=True,
        mapq0_tie_break=False,
        markunbalancetra=False,
        nodiscard=True,
    ),
    "asm": ModePreset(
        name="asm",
        cov_adapt=False,
        simple_inv_full=False,
        rebuild_dup_overlap=False,
        rebuild_small_alignment=40,
        split_force_gap=2000,
        emit_keep_order=True,
        local_single_guide=True,
        emit_mapq_quantize=True,
        global_skipcost=30.0,
        local_skipcost=30.0,
        max_divergence=1.0,  # forced for asm (mammap_asm.py:23483)
        accept_score=40.0,
        guide_chain_cap=5,
        local_maxgap=99,
        local_skipcost_cap=None,
        refund_penalty=False,
        markunbalancetra=False,
        nodiscard=True,
        streaming=True,
    ),
}


def preset(mode: str) -> ModePreset:
    return _PRESETS[mode]


@dataclasses.dataclass(frozen=True)
class AlignerConfig:
    """Full aligner configuration: mode preset + CLI overrides.

    Flag parity with the reference CLI (``vacmap:75-152``).
    """

    mode: str = "H"
    kmersize: int = 15
    window: int = 10
    local_kmersize: int = 9  # vacmap:257
    check_num: int = 100  # -c, top N clusters (vacmap:105)
    global_maxdiff: int = 50  # vacmap:112 (reference key 'golbal_maxdiff')
    local_maxdiff: int = 30  # vacmap:113
    global_skipcost: Optional[float] = None  # -globalpenalty override
    local_skipcost: Optional[float] = None  # -localpenalty override
    max_divergence: Optional[float] = None  # -maxdivergence override
    markunbalancetra: Optional[bool] = None
    nodiscard: Optional[bool] = None
    # output shaping
    eqx: bool = False
    md: bool = False
    cs: bool = False
    shortcs: bool = True
    cigar2cg: bool = False  # --L
    hardclip: bool = False  # --H
    fakecigar: bool = False
    copycomments: bool = False
    ignore_quals: bool = False  # --Q
    rg_id: Optional[str] = None
    # runtime
    threads: int = 8
    batch_reads: int = 64
    backend: str = "auto"  # 'auto' | 'jax' | 'numpy'
    debug: bool = False
    workdir: Optional[str] = None

    @property
    def preset(self) -> ModePreset:
        return _PRESETS[self.mode]

    # -- resolved values (preset unless overridden) ------------------------
    @property
    def resolved_global_skipcost(self) -> float:
        p = self.preset
        return self.global_skipcost if self.global_skipcost is not None else p.global_skipcost

    @property
    def resolved_local_skipcost(self) -> float:
        p = self.preset
        return self.local_skipcost if self.local_skipcost is not None else p.local_skipcost

    @property
    def resolved_max_divergence(self) -> float:
        p = self.preset
        if p.streaming:
            return 1.0
        return self.max_divergence if self.max_divergence is not None else p.max_divergence

    @property
    def resolved_markunbalancetra(self) -> bool:
        return (
            self.markunbalancetra
            if self.markunbalancetra is not None
            else self.preset.markunbalancetra
        )

    @property
    def resolved_nodiscard(self) -> bool:
        return self.nodiscard if self.nodiscard is not None else self.preset.nodiscard

    @property
    def resolved_eqx(self) -> bool:
        # asm mode forces eqx (vacmap:246)
        return True if self.preset.streaming else self.eqx

    def local_dp_skipcost(self) -> float:
        """Skipcost handed to the local (k=9) DP, with the L-mode cap."""
        sc = self.resolved_local_skipcost
        cap = self.preset.local_skipcost_cap
        return min(sc, cap) if cap is not None else sc

    def chain_params_global(self) -> Tuple[float, int, int]:
        """(skipcost, maxdiff, maxgap) for the global chaining DP.

        maxgap is hard-set to 1000 inside decode_hit (mammap_clrnano.py:23993).
        """
        return (self.resolved_global_skipcost, self.global_maxdiff, 1000)

    def chain_params_local(self) -> Tuple[float, int, int]:
        """(skipcost, maxdiff, maxgap) for the local k=9 DP."""
        return (self.local_dp_skipcost(), self.local_maxdiff, self.preset.local_maxgap)
