"""Non-linear chaining DP — exact host (numpy) reference implementation.

This is the algorithmic core of VACmap: an anchor-chaining DP that, unlike
colinear (minimap2-style) chaining, may pay a bounded "variation penalty"
to jump between strands, diagonals and contigs inside one chain, so a
single chain can represent inversions, duplications and translocations.

Four recurrence variants exist in the reference (SURVEY.md section 2.2/2.3):
  * global  — ``_d_all`` (mammap_clrnano.py:24828), adaptive repeat
    penalties, used on k=15 minimizer anchors.
  * global refund ("R" mode) — flat SV penalty plus a refund ledger that
    repays the penalty once enough matched bases accrue after the jump
    (mammap_noprefercloser.py:22839,22288-22446).
  * fine    — local k=9 re-chaining (``fine_list``, mammap_clrnano.py:27305).
  * mismatch — local re-chaining when multiple guide chains exist
    (``_mismatch``, mammap_clrnano.py:28250).

The implementation here is vectorized per read-position group: anchors
sharing the barrier key can never chain to each other
(``mammap_clrnano.py:24912-24928``), so each group scores against all
earlier anchors with one fused numpy pass.  This computes exactly the
same S/P as the reference's sequential descending-score scan, because the
reference's early break is lossless (a winning predecessor j must have
S[j] > running_max - len_i, see SURVEY.md Appendix A.2).

Predecessor tie-breaking matches the reference scan order: highest S[j]
first, ties by larger index (later insertion scanned first).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "EXTRA",
    "ChainResult",
    "chain_dp",
    "chain_dp_fast",
    "chain_local",
    "final_score_order",
]


def _build_extra() -> np.ndarray:
    """SV-move distance surcharge table (mammap_clrnano.py:15371-15376):
    extra[g] = min(36, 30 + 0.5*ln(max(g,1)), min(10, g/100) + min(30, g/1000)),
    built until the value saturates at 36."""
    vals = []
    g = 0
    while True:
        v = min(
            36.0,
            30.0 + 0.5 * math.log(max(g, 1)),
            min(10.0, g / 100.0) + min(30.0, g / 1000.0),
        )
        vals.append(v)
        if len(vals) > 1 and vals[-1] == 36.0:
            break
        g += 1
    return np.array(vals, dtype=np.float32)


EXTRA = _build_extra()
_EXTRA_MAX = len(EXTRA) - 1

# 0.5*log2(g+1) cache used by the mismatch variant's SV cost
# (mammap_clrnano.py:27528 log2cache)
_LOG2CACHE = 0.5 * np.log2(np.arange(100000, dtype=np.float64) + 1.0)

# colinear small read-gap cost for the fine variant
# (mammap_clrnano.py:26567 readgapcost_list, float32 in the reference)
_READGAPCOST = np.zeros(100, dtype=np.float32)
_READGAPCOST[1:] = (0.1 * np.log2(np.arange(1, 100) + 1.0)).astype(np.float32)
# R-mode scar table: 0.1*log2(g) (mammap_noprefercloser.py:16534-16536)
_READGAPCOST_SCAR = np.zeros(100, dtype=np.float32)
_READGAPCOST_SCAR[1:] = (0.1 * np.log2(np.arange(1, 100))).astype(np.float32)


def _gapcost_table(kmersize: int, maxdiff: int, local: bool) -> np.ndarray:
    """Colinear gap cost 0.01*k*g + c*log2(g); the local variants use
    c=2 above g=10 (mammap_clrnano.py:24843 vs :27321)."""
    g = np.arange(maxdiff + 1, dtype=np.float64)
    with np.errstate(divide="ignore"):
        lg = np.where(g > 0, np.log2(np.maximum(g, 1)), 0.0)
    coef = np.where((g > 10) & local, 2.0, 0.5)
    t = 0.01 * kmersize * g + coef * lg
    t[0] = 0.0
    return t


def _large_readgapcost(maxgap: int, large_readgap: int = 30) -> np.ndarray:
    """Mismatch-variant colinear read-gap cost
    (mammap_clrnano.py:28270-28275), float32 like the reference."""
    g = np.arange(maxgap + 1, dtype=np.float64)
    t = np.where(g >= large_readgap, 0.5 * g, 0.1 * np.log2(g + 1.0))
    t[0] = 0.0
    return t.astype(np.float32)


@dataclasses.dataclass
class ChainResult:
    g_max_index: int
    S: np.ndarray  # float64 chain score per anchor
    P: np.ndarray  # int64 predecessor (-1 for chain start)
    aborted: bool = False  # exact DP bailed out (density too high)


NO_PRED = -1


def _pair_geometry(ai: np.ndarray, A: np.ndarray, asm_geo: bool = False):
    """Vectorized transition geometry of one anchor `ai` against anchor
    rows `A`: returns (readgap>=0 clipped, refgap, bonus, neg_overlap_mask,
    bonus_nonpos_mask).  Exact transcription of the case analysis at
    mammap_clrnano.py:24946-24983 (shared by every variant).

    ``asm_geo=True`` uses the asm fine DP's start-based opposite-strand
    refgap formulas (mammap_asm.py live ..._fine_list: non_overlap_size
    = r_i - r_j, no +-1 adjustments); same-strand cases are algebraically
    identical between the two."""
    r_i, y_i, s_i, l_i = ai
    r_j, y_j, s_j, l_j = A[:, 0], A[:, 1], A[:, 2], A[:, 3]
    raw_readgap = r_i - r_j - l_j
    neg = raw_readgap < 0
    bonus = np.where(neg, r_i + l_i - r_j - l_j, l_i)
    overlap = r_j + l_j - r_i
    readgap = np.where(neg, 0, raw_readgap)
    same = s_j == s_i

    plus = s_i == 1
    j_minus = s_j == -1
    if asm_geo:
        nov = r_i - r_j
        refgap_neg = np.where(
            same,
            np.where(plus, y_i + overlap - (y_j + l_j), y_j - (y_i + bonus)),
            np.where(j_minus, y_i + l_j - nov - y_j, y_i + l_i - y_j - nov),
        )
        refgap_pos = np.where(
            same,
            np.where(plus, y_i - y_j - l_j, y_j - y_i - l_i),
            np.where(j_minus, y_i - y_j, y_i + l_i - y_j - l_j),
        )
        refgap = np.where(neg, refgap_neg, refgap_pos)
        return readgap, refgap, bonus, neg, same
    # refgap for the overlapping (neg) case
    refgap_neg = np.where(
        same,
        np.where(plus, y_i + overlap - (y_j + l_j), y_j - (y_i + bonus)),
        np.where(j_minus, y_i + overlap - y_j + 1, y_i + bonus - 1 - (y_j + l_j)),
    )
    # refgap for the disjoint case
    refgap_pos = np.where(
        same,
        np.where(plus, y_i - y_j - l_j, y_j - y_i - l_i),
        np.where(j_minus, y_i - y_j + 1, y_i + l_i - 1 - y_j - l_j),
    )
    refgap = np.where(neg, refgap_neg, refgap_pos)
    return readgap, refgap, bonus, neg, same


def chain_dp(
    anchors: np.ndarray,
    kmersize: int = 15,
    skipcost: float = 40.0,
    maxdiff: int = 50,
    maxgap: int = 1000,
    variant: str = "global",
    max_ops_per_anchor: int = 1000,
) -> ChainResult:
    """Exact chaining DP dispatcher: native C++ kernel when available
    (identical recurrence and tie-breaks), numpy group-vectorized oracle
    otherwise."""
    from .. import native

    if native.available() and len(anchors):
        res = native.chain_dp_native(
            anchors, kmersize, skipcost, maxdiff, maxgap, variant,
            max_ops_per_anchor,
        )
        if res is not None:
            S, P, aborted = res
            g = int(np.argmax(S)) if len(S) else -1
            if aborted:
                return ChainResult(-1, S, P, aborted=True)
            return ChainResult(g, S, P)
    return chain_dp_numpy(
        anchors, kmersize=kmersize, skipcost=skipcost, maxdiff=maxdiff,
        maxgap=maxgap, variant=variant, max_ops_per_anchor=max_ops_per_anchor,
    )


def chain_dp_numpy(
    anchors: np.ndarray,
    kmersize: int = 15,
    skipcost: float = 40.0,
    maxdiff: int = 50,
    maxgap: int = 1000,
    variant: str = "global",
    max_ops_per_anchor: int = 1000,
) -> ChainResult:
    """Exact chaining DP over `anchors` (n,4) = (readpos, refpos, strand, len).

    variant:
      * "global"  — adaptive repeat penalties, readpos barrier
        (mammap_clrnano.py:24828)
      * "refund"  — R mode: flat SV penalty + refund ledger, readpos barrier
        (mammap_noprefercloser.py:22839)
      * "fine"    — local: end-position barrier, local gap costs, strand-flip
        discount min(50, skipcost) (mammap_clrnano.py:27305)
      * "mismatch" — local multi-guide: end-position barrier, flat SV cost
        + 0.5*log2(gapcost+1) (mammap_clrnano.py:28250)

    Anchors must already be sorted by the variant's barrier key (readpos
    for global/refund — mammap_clrnano.py:23572; readpos+len for
    fine/mismatch — :28585).

    Aborts (`aborted=True`) mid-DP the moment candidate evaluations per
    anchor exceed `max_ops_per_anchor`, with the reference's exact
    scan-order count (early-break prefix emulated per anchor) — the
    ``max_factor`` bailout to the fast bucketed DP
    (mammap_clrnano.py:24914, :27380).
    """
    n = len(anchors)
    A = anchors.astype(np.int64)
    S = np.zeros(n, np.float64)
    P = np.full(n, NO_PRED, np.int64)
    if n == 0:
        return ChainResult(-1, S, P)

    # "global_nocov" = asm-mode global scoring without the adaptive
    # repeat coverage (mammap_asm.py:20552/:21687 use flat skipcost) and
    # with the asm opposite-strand geometry (non_overlap_size forms, no
    # +-1 — mammap_asm.py:20552 refgap cases; same-strand forms are
    # algebraically identical to clrnano's)
    use_cov = variant != "global_nocov"
    asm_geo = variant == "global_nocov"
    if variant == "global_nocov":
        variant = "global"
    # "scar" = the R-mode LOCAL re-chain (mammap_noprefercloser.py:23419):
    # local barrier/overlap rules, GLOBAL-style colinear gap table, a
    # 0.1*log2(g) readgap term, flat-skipcost SV moves with the refund
    # ledger, no fast fallback
    scar = variant == "scar"
    # "asm_fine" = the asm local re-chain DP (mammap_asm.py live
    # ..._fine_list): readpos (START) barrier, flat 0.5*log2 gap table,
    # 0.1*log2(readgap) readgap term, SV cost skipcost + extra[gapcost],
    # start-based opposite-strand overlap geometry, no coverage, no
    # bonus<=0 skip, no abort / fast fallback
    asmf = variant == "asm_fine"
    local = variant in ("fine", "mismatch", "scar")
    gapcost_list = _gapcost_table(
        kmersize, maxdiff, local and not scar
    )
    lrg = _large_readgapcost(maxgap) if variant == "mismatch" else None

    # adaptive repeat penalties (global variant only, mark_a blocks)
    repeat_weight = 20
    if variant == "global" and use_cov:
        cov = np.zeros(int(A[:, 0].max()) + 1, np.int64)
        np.add.at(cov, A[:, 0], 1)
        cov = np.minimum(cov, repeat_weight)
        skip_i = skipcost + cov[A[:, 0]]
        maxdiff_i = np.maximum(maxdiff - cov[A[:, 0]], 10)
    else:
        skip_i = np.full(n, float(skipcost))
        maxdiff_i = np.full(n, maxdiff)

    barrier = A[:, 0] + (A[:, 3] if local else 0)
    # group boundaries: candidates for i are anchors with strictly smaller
    # barrier value (same-readpos barrier, SURVEY.md Appendix A.1)
    group_start = np.searchsorted(barrier, barrier, side="left")

    refund = variant in ("refund", "scar")
    if refund:
        fixed_pen = np.zeros(n, np.float64)
        pre_pen = np.zeros(n, np.float64)

    S[0] = A[0, 3]
    g_max_scores = S[0]
    g_max_index = 0
    ops = 0

    # abort classes (mid-DP, checked at each barrier advance exactly like
    # the reference):
    #  * global/refund: opcount/i > max_factor (mammap_clrnano.py:24914,
    #    true division) -> bail to the fast DP;
    #  * fine/mismatch: opcount > 100000 AND opcount/prereadloc >
    #    max_factor (mammap_clrnano.py:27380,:28333); their loops count
    #    the breaking candidate and break on `<` (equality evaluated);
    #  * scar / asm_fine: no abort (mammap_noprefercloser.py:23419).
    abort_global = (
        variant in ("global", "refund")
        and not scar
        and not asmf
        and max_ops_per_anchor > 0
    )
    abort_local = variant in ("fine", "mismatch") and max_ops_per_anchor > 0
    count_first = variant in ("fine", "mismatch")
    # scar evaluates equality candidates too (`<` break) and, because of
    # the refund ledger, an equality candidate can WIN -- and conversely
    # refund variants can have sub-break candidates that full evaluation
    # would wrongly see; both require masking to the reference's scan
    # prefix (the "examined" set).
    need_prefix = abort_global or abort_local or refund

    # iterate over barrier groups; inside a group everything vectorizes
    starts = np.unique(group_start)
    prev_barrier = int(barrier[0])
    for gs in starts:
        gs = int(gs)
        ge = int(np.searchsorted(barrier, barrier[gs], side="right"))
        if gs > 0:
            if abort_global and ops / gs > max_ops_per_anchor:
                return ChainResult(-1, S, P, aborted=True)
            if (
                abort_local
                and ops > 100000
                and ops / max(prev_barrier, 1) > max_ops_per_anchor
            ):
                return ChainResult(-1, S, P, aborted=True)
        prev_barrier = int(barrier[gs])
        # candidate scan order for this group: descending (score, index) —
        # the reference's S_arg[::-1] (insertpoint_score inserts ties after
        # existing equals, so later indices scan first)
        m_grp = int(group_start[gs])
        if need_prefix and m_grp > 0:
            order_desc = np.lexsort((np.arange(m_grp), S[:m_grp]))[::-1]
            s_desc = S[:m_grp][order_desc]
        for i in range(gs, ge):
            if i == 0:
                continue
            ai = A[i]
            l_i = ai[3]
            m = int(group_start[i])
            if m == 0:
                S[i] = l_i
                if S[i] > g_max_scores:
                    g_max_scores, g_max_index = S[i], i
                continue
            Aj = A[:m]
            Sj = S[:m]
            readgap, refgap, bonus, neg, same = _pair_geometry(
                ai, Aj, asm_geo=(asmf or asm_geo)
            )
            gapcost = np.abs(readgap - refgap)
            colinear = (
                same
                & (refgap >= 0)
                & (readgap <= maxgap)
                & (gapcost <= maxdiff_i[i])
            )
            gidx = np.minimum(gapcost, maxdiff)
            if variant in ("global", "refund"):
                col = Sj + bonus - gapcost_list[gidx]
            elif variant in ("scar", "asm_fine"):
                col = (
                    Sj
                    + bonus
                    - gapcost_list[gidx]
                    - _READGAPCOST_SCAR[np.minimum(readgap, 99)]
                )
            elif variant == "fine":
                col = (
                    Sj
                    + bonus
                    - gapcost_list[gidx]
                    - _READGAPCOST[np.minimum(readgap, 99)]
                )
            else:  # mismatch
                col = Sj + bonus - gapcost_list[gidx] - lrg[np.minimum(readgap, maxgap)]

            eidx = np.minimum(gapcost, _EXTRA_MAX)
            if variant in ("global", "asm_fine"):
                sv = Sj - skip_i[i] + bonus - EXTRA[eidx]
            elif variant in ("refund", "scar"):
                sv = Sj + bonus - skip_i[i]
            elif variant == "fine":
                flip_pen = np.where(~same, min(50.0, skipcost), skipcost)
                sv = Sj + bonus - (flip_pen + EXTRA[eidx])
            else:  # mismatch
                sv = Sj + bonus - (skipcost + _LOG2CACHE[np.minimum(gapcost, 99999)])

            test = np.where(colinear, col, sv)
            if refund:
                refundable = colinear & (fixed_pen[:m] < 0) & (fixed_pen[:m] + bonus >= 0)
                test = np.where(refundable, test + pre_pen[:m], test)
            if local:
                # overlapping anchors that are fully contained give no
                # bonus and are skipped (mammap_clrnano.py:27425)
                test = np.where(neg & (bonus <= 0), -np.inf, test)

            if need_prefix:
                # emulate the reference's early-break scan: M[t] = running
                # max (seeded with w_i) over the first t candidate scores
                # in scan order; the scan stops at the first candidate
                # failing the break test against the *evolving* max
                ts_o = test[order_desc]
                M = np.maximum.accumulate(
                    np.concatenate(([float(l_i)], ts_o))
                )[:-1]
                thr = M - l_i
                failv = (s_desc < thr) if (count_first or scar) else (s_desc <= thr)
                kf = int(np.argmax(failv)) if failv.any() else m
                if count_first:
                    ops += (kf + 1) if kf < m else m
                elif abort_global:
                    ops += kf
                if refund and kf < m:
                    # candidates past the break point were never examined;
                    # with the refund ledger they could otherwise win
                    masked = np.full(m, -np.inf)
                    ex = order_desc[:kf]
                    masked[ex] = test[ex]
                    test = masked

            best = test.max() if m else -np.inf
            if best > l_i:
                # tie-break: highest S[j], then largest j (reference scan
                # order: descending score, later-inserted first)
                winners = np.flatnonzero(test == best)
                if len(winners) > 1:
                    wj = winners[np.lexsort((winners, Sj[winners]))[-1]]
                else:
                    wj = winners[0]
                S[i] = best
                P[i] = wj
                if refund:
                    if colinear[wj]:
                        if fixed_pen[wj] < 0 and fixed_pen[wj] + bonus[wj] < 0:
                            fixed_pen[i] = fixed_pen[wj] + bonus[wj]
                            pre_pen[i] = pre_pen[wj]
                        else:
                            fixed_pen[i] = 0.0
                            pre_pen[i] = 0.0
                    else:
                        fixed_pen[i] = -skip_i[i] + bonus[wj]
                        pre_pen[i] = skip_i[i]
            else:
                S[i] = l_i
            if S[i] > g_max_scores:
                g_max_scores, g_max_index = S[i], i
        if ops / max(ge, 1) > max_ops_per_anchor and variant in ("global", "refund"):
            return ChainResult(-1, S, P, aborted=True)
        if (
            local
            and ops > 100_000
            and ops / max(int(barrier[min(ge, n - 1)]), 1) > max_ops_per_anchor
        ):
            return ChainResult(-1, S, P, aborted=True)

    return ChainResult(int(g_max_index), S, P)


def final_score_order(S: np.ndarray) -> np.ndarray:
    """Anchor indices in the reference's final S_arg[::-1] order:
    descending score, ties by descending index (insertpoint_score inserts
    equal scores after existing equals — mammap_clrnano.py:19369-19388)."""
    n = len(S)
    return np.lexsort((np.arange(n), S))[::-1]


# ---------------------------------------------------------------------------
# fast bucketed variant (exact scalar replication of _d_fast_all,
# mammap_clrnano.py:25033-25341) — used when anchor density is extreme
# ---------------------------------------------------------------------------


def chain_dp_fast(
    anchors: np.ndarray,
    kmersize: int = 15,
    skipcost: float = 40.0,
    maxdiff: int = 50,
    maxgap: int = 1000,
    fast_t: int = 5,
    variant: str = "global",
) -> ChainResult:
    """Bucketed-prune chaining DP: scores quantized to ints; buckets with
    more than `fast_t` members test only the diagonal-nearest anchor.

    This is the reference's repeat-dense fallback.  Dispatches to the
    native C++ kernel when available; the scalar Python transcription
    below is the validation oracle.
    """
    from .. import native

    if native.available() and len(anchors):
        res = native.chain_dp_fast_native(
            anchors, kmersize, skipcost, maxdiff, maxgap, variant, fast_t
        )
        if res is not None:
            S, P = res
            g = int(np.argmax(S)) if len(S) else -1
            return ChainResult(g, S, P)
    import bisect
    from collections import defaultdict

    n = len(anchors)
    A = anchors.astype(np.int64)
    S = np.zeros(n, np.float64)
    P = np.full(n, NO_PRED, np.int64)
    if n == 0:
        return ChainResult(-1, S, P)

    use_cov = variant != "global_nocov"
    asm_geo = variant == "global_nocov"  # asm opposite-strand geometry
    if variant == "global_nocov":
        variant = "global"
    local = variant in ("fine", "mismatch")
    refund = variant == "refund"
    gapcost_list = _gapcost_table(kmersize, maxdiff, local)
    lrg = _large_readgapcost(maxgap) if variant == "mismatch" else None
    repeat_weight = 20
    cov = np.zeros(int(A[:, 0].max()) + 1, np.int64)
    if variant == "global" and use_cov:
        np.add.at(cov, A[:, 0], 1)
        cov = np.minimum(cov, repeat_weight)

    readlength = int(A[-1, 0]) + 1000
    target = np.where(
        A[:, 2] == 1,
        A[:, 1] - A[:, 0] + readlength,
        -(A[:, 1] + A[:, 0] + readlength),
    )
    barrier = A[:, 0] + (A[:, 3] if local else 0)

    S_i = np.zeros(n, np.int64)
    S[0] = A[0, 3]
    S_i[0] = A[0, 3]
    g_max_scores = float(S[0])
    g_max_index = 0
    if refund:
        fixed_pen = np.zeros(n, np.float64)
        pre_pen = np.zeros(n, np.float64)

    inserted = 1
    max_score_i = int(S_i[0])
    bucket: dict[int, list] = defaultdict(list)  # int score -> [(diag, idx)]
    bucket[int(S_i[0])].append((int(target[0]), 0))

    prebarrier = int(barrier[0])
    skipcost_c = float(skipcost) + (cov[A[0, 0]] if variant == "global" else 0)
    maxdiff_c = max(maxdiff - (cov[A[0, 0]] if variant == "global" else 0), 10)

    def score_pair(i: int, j: int, skip_c: float, mdiff_c: int):
        readgap, refgap, bonus, neg, same = _pair_geometry(
            A[i], A[j : j + 1], asm_geo=asm_geo
        )
        readgap, refgap, bonus, neg, same = (
            int(readgap[0]),
            int(refgap[0]),
            int(bonus[0]),
            bool(neg[0]),
            bool(same[0]),
        )
        if local and neg and bonus <= 0:
            return -np.inf, False, bonus
        gapcost = abs(readgap - refgap)
        colinear = same and refgap >= 0 and readgap <= maxgap and gapcost <= mdiff_c
        if colinear:
            ts = S[j] + bonus - gapcost_list[gapcost]
            if variant == "fine":
                ts -= _READGAPCOST[min(readgap, 99)]
            elif variant == "mismatch":
                ts -= lrg[min(readgap, maxgap)]
            elif refund and fixed_pen[j] < 0 and fixed_pen[j] + bonus >= 0:
                ts += pre_pen[j]
            return ts, True, bonus
        if variant == "global":
            ts = S[j] - skip_c + bonus - EXTRA[min(gapcost, _EXTRA_MAX)]
        elif variant == "refund":
            ts = S[j] + bonus - skip_c
        elif variant == "fine":
            pen = (skipcost if same else min(50.0, skipcost)) + EXTRA[
                min(gapcost, _EXTRA_MAX)
            ]
            ts = S[j] + bonus - pen
        else:  # mismatch
            ts = S[j] + bonus - (skipcost + _LOG2CACHE[min(gapcost, 99999)])
        return ts, False, bonus

    for i in range(1, n):
        if prebarrier < barrier[i]:
            while inserted < i:
                k = inserted
                sk = int(S_i[k])
                bisect.insort(bucket[sk], (int(target[k]), k))
                if sk > max_score_i:
                    max_score_i = sk
                inserted += 1
            if variant == "global":
                skipcost_c = float(skipcost) + cov[A[i, 0]]
                maxdiff_c = max(maxdiff - cov[A[i, 0]], 10)
            prebarrier = int(barrier[i])

        l_i = int(A[i, 3])
        max_scores = float(l_i)
        pre_index = NO_PRED
        win_col, win_bonus = False, 0
        c = max_score_i
        while c > max_scores - (l_i + 1):
            blist = bucket.get(c)
            if blist:
                if len(blist) > fast_t:
                    # diagonal-nearest member only; distance ties prefer the
                    # larger diagonal (closest2targetdistance strict <,
                    # mammap_clrnano.py:17248)
                    t = int(target[i])
                    pos = bisect.bisect_left(blist, (t, -1))
                    cand = []
                    if pos < len(blist):
                        cand.append(blist[pos])
                    if pos > 0:
                        cand.append(blist[pos - 1])
                    best_j = min(cand, key=lambda td: (abs(td[0] - t), td[0] < t))[1]
                    ts, is_col, bn = score_pair(i, best_j, skipcost_c, maxdiff_c)
                    if ts > max_scores:
                        max_scores, pre_index = ts, best_j
                        win_col, win_bonus = is_col, bn
                else:
                    for t_j in reversed(blist):
                        j = t_j[1]
                        ts, is_col, bn = score_pair(i, j, skipcost_c, maxdiff_c)
                        if ts > max_scores:
                            max_scores, pre_index = ts, j
                            win_col, win_bonus = is_col, bn
            c -= 1
        S[i] = max_scores
        S_i[i] = int(max_scores)
        P[i] = pre_index
        if refund and pre_index != NO_PRED:
            j = pre_index
            if win_col:
                if fixed_pen[j] < 0 and fixed_pen[j] + win_bonus < 0:
                    fixed_pen[i] = fixed_pen[j] + win_bonus
                    pre_pen[i] = pre_pen[j]
            else:
                fixed_pen[i] = -skipcost_c + win_bonus
                pre_pen[i] = skipcost_c
        if max_scores > g_max_scores:
            g_max_scores, g_max_index = max_scores, i

    return ChainResult(int(g_max_index), S, P)


# ---------------------------------------------------------------------------
# local re-chain wrapper: DP + single-path backtrack with overlap trimming
# ---------------------------------------------------------------------------


def chain_local(
    anchors: np.ndarray,
    kmersize: int = 9,
    skipcost: float = 40.0,
    maxdiff: int = 30,
    maxgap: int = 99,
    mismatch: bool = False,
    chain_backend=None,
    variant: str = None,
    as_array: bool = False,
) -> Tuple[float, list]:
    """Local k=9 re-chain: returns (score, path) where path is the best
    chain in DESCENDING read-position order with overlapping anchors
    trimmed, exactly like the reference backtrack
    (mammap_clrnano.py:27510-27540).

    Expects anchors sorted by readpos+len (mammap_clrnano.py:28585).
    ``as_array`` returns the path as an (n,4) int64 array instead of
    tuples (the pipeline threads it straight into rebuild_chain_break).
    """
    if variant is None:
        variant = "mismatch" if mismatch else "fine"
    res = None
    if chain_backend is not None:
        res = chain_backend(anchors, variant, kmersize, skipcost, maxdiff, maxgap)
    if res is None:
        res = chain_dp(
            anchors,
            kmersize=kmersize,
            skipcost=skipcost,
            maxdiff=maxdiff,
            maxgap=maxgap,
            variant=variant,
        )
    if res.aborted and variant not in ("scar", "asm_fine"):  # no fast fallback
        res = chain_dp_fast(
            anchors,
            kmersize=kmersize,
            skipcost=skipcost,
            maxdiff=maxdiff,
            maxgap=maxgap,
            variant=variant,
        )
    if res.g_max_index < 0:
        return 0.0, (np.empty((0, 4), np.int64) if as_array else [])
    # Follow the predecessor chain, then apply the overlap trim as one
    # vectorized pass: each path element is trimmed at most once and the
    # trim depends only on the RAW (pre, now) anchor pair, never on an
    # already-trimmed value, so the serial loop is data-parallel.
    from .. import native

    idx = native.backtrack_follow_native(res.P, res.g_max_index)
    if idx is None:
        P_list = res.P.tolist()
        take = res.g_max_index
        idx_l = [take]
        while P_list[take] != NO_PRED:
            take = P_list[take]
            idx_l.append(take)
        idx = np.asarray(idx_l, np.int64)
    A = anchors[idx].astype(np.int64, copy=True)
    if variant == "asm_fine":
        # asm trim convention: an overlapped PREDECESSOR loses its right
        # edge (len = pre_readpos - now_readpos; minus strand shifts ref)
        # — mammap_asm.py live ..._fine_list backtrack.  clrnano instead
        # trims the successor's left edge (below).
        if len(A) > 1:
            m = A[:-1, 0] < A[1:, 0] + A[1:, 3]
            newlen = A[:-1, 0] - A[1:, 0]
            A[1:, 1] = np.where(
                m & (A[1:, 2] != 1), A[1:, 1] + A[1:, 3] - newlen, A[1:, 1]
            )
            A[1:, 3] = np.where(m, newlen, A[1:, 3])
        return float(res.S[res.g_max_index]), (
            A if as_array else list(map(tuple, A.tolist())))
    if len(A) > 1:
        ov = A[1:, 0] + A[1:, 3] - A[:-1, 0]
        ovm = np.where(ov > 0, ov, 0)
        A[:-1, 1] += np.where(A[:-1, 2] == 1, ovm, 0)
        A[:-1, 0] += ovm
        A[:-1, 3] -= ovm
    return float(res.S[res.g_max_index]), (
        A if as_array else list(map(tuple, A.tolist())))
