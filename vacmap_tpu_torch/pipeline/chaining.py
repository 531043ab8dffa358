"""Global chaining routine: strand normalization, DP dispatch, multi-path
backtrack, primary clustering, MAPQ, secondary-path selection.

Equivalent of the reference's ``decode_hit`` + ``hit2work_1``
(mammap_clrnano.py:23981, :23491-23734).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..ops.chain_ref import (
    NO_PRED,
    ChainResult,
    chain_dp,
    chain_dp_fast,
    final_score_order,
)

MIN_PATH_SCORE = 40.0  # per-path keep threshold (mammap_clrnano.py:23607)


def normalize_strand(anchors: np.ndarray, read_len: int) -> Tuple[bool, np.ndarray]:
    """Majority-strand flip (get_reversed_chain_numpy_rough,
    mammap_clrnano.py:21202-21217): if minus-strand anchors outnumber plus,
    mirror read coordinates and negate strands so the dominant strand is +."""
    if len(anchors) < 3:
        return False, anchors
    n_minus = int(np.count_nonzero(anchors[:, 2] == -1))
    if n_minus > len(anchors) - n_minus:
        out = anchors.copy()
        out[:, 0] = read_len - out[:, 0] - out[:, 3]
        out[:, 2] = -out[:, 2]
        return True, out[::-1]
    return False, anchors


@dataclasses.dataclass
class GlobalChains:
    mapq: int
    score: float  # negative when the read was strand-flipped
    paths: List[np.ndarray]  # best path first, then accepted secondaries
    need_reverse: bool


def _backtrack_all(
    anchors: np.ndarray, res: ChainResult
) -> Tuple[List[np.ndarray], List[float], List[float]]:
    """Best path plus all disjoint suffix paths reusing P
    (mammap_clrnano.py:23588-23640).  Returns (paths, scores, best_S_arr)
    where paths are anchor arrays in descending read-pos order and
    best_S_arr holds the per-anchor chain scores along the best path."""
    S, P = res.S, res.P
    n = len(S)
    from .. import native

    if native.available():
        nres = native.backtrack_all_native(
            S, P, res.g_max_index, final_score_order(S), MIN_PATH_SCORE
        )
        if nres is not None:
            idx_paths, n_scores, best_s_arr = nres
            return (
                [anchors[ip] for ip in idx_paths], n_scores, best_s_arr
            )
    used = np.zeros(n, bool)
    paths: List[np.ndarray] = []
    scores: List[float] = []

    def walk(start: int) -> Tuple[list, float, list]:
        idxs = []
        s_arr = []
        take = start
        score = float(S[take])
        while True:
            idxs.append(take)
            s_arr.append(float(S[take]))
            used[take] = True
            p = int(P[take])
            if p == NO_PRED:
                break
            if used[p]:
                score -= float(S[p])
                break
            take = p
        return idxs, score, s_arr

    best_idx, best_score, best_s_arr = walk(res.g_max_index)
    if best_score > MIN_PATH_SCORE:
        paths.append(anchors[np.asarray(best_idx)])
        scores.append(best_score)
    else:
        return [], [], []

    for take in final_score_order(S):
        if used[take]:
            continue
        idxs, score, _ = walk(int(take))
        if score > MIN_PATH_SCORE:
            paths.append(anchors[np.asarray(idxs)])
            scores.append(score)
    return paths, scores, best_s_arr


def _readloc_bins(path: np.ndarray, bin_size: int) -> set:
    return set((path[:, 0] // bin_size).tolist())


def _overlapsize(a: set, b: set) -> float:
    return len(a & b) / min(len(a), len(b))


def _select_secondaries(
    order: np.ndarray,
    paths: List[np.ndarray],
    scores: List[float],
    best_s_arr: List[float],
    read_len: int,
) -> List[np.ndarray]:
    """Secondary alignment selection (mammap_clrnano.py:23505-23538):
    keep non-best paths whose score is within 0.9x (or 40) of the best
    path's score over the same read interval, span >= 50 bp, and that
    overlap already-kept secondaries < 50%."""
    out: List[np.ndarray] = []
    if len(paths) <= 1:
        return out
    loc2score = np.zeros(read_len, np.float64)
    en = read_len
    for anchor, s in zip(paths[0], best_s_arr):
        st = int(anchor[0])
        loc2score[st:en] = s
        en = st
    for iloc in order[1:]:
        p, f2 = paths[iloc], scores[iloc]
        en_loc, st_loc = int(p[0][0]), int(p[-1][0])
        if en_loc - st_loc < 50:
            continue
        f1 = max(loc2score[en_loc] - loc2score[st_loc], 1.0)
        if f2 / f1 > 0.9 or abs(f1 - f2) < 40:
            skip = False
            for q in out:
                q_en, q_st = int(q[0][0]), int(q[-1][0])
                ov = max(min(en_loc, q_en) - max(q_st, st_loc), 0)
                if ov / (en_loc - st_loc) > 0.5:
                    skip = True
                    break
            if not skip:
                out.append(p)
    return out


def prepare_read_anchors(anchors: np.ndarray, read_len: int):
    """Strand-normalize and readpos-sort anchors for the global DP.
    Returns (need_reverse, sorted_anchors) — the exact array the DP (host
    or device) must run on."""
    need_reverse, anchors = normalize_strand(anchors, read_len)
    # index.seeds emits readpos-sorted anchors: skipping the re-sort when
    # already nondecreasing preserves the exact stable order
    rp = anchors[:, 0]
    if len(rp) and np.all(rp[1:] >= rp[:-1]):
        return need_reverse, anchors
    order0 = np.argsort(rp, kind="stable")
    return need_reverse, anchors[order0]


def _main_alignment_span(path_asc, starts) -> tuple:
    """Longest colinear run (readgap>=0, refgap>=0, |readgap-refgap|<=30,
    same contig) of an ascending path, as its (first, last) anchors —
    return_main_alignment_size (mammap_clrnano.py live def).

    Contig ids are precomputed vectorized and the scan runs on plain
    int lists: the per-pair ``np.searchsorted`` lambda this replaces was
    ~70 ms per invocation on long paths."""
    arr = np.asarray(path_asc, dtype=np.int64).reshape(len(path_asc), 4)
    cids = np.maximum(
        np.searchsorted(starts, arr[:, 1], side="right") - 1, 0
    ).tolist()
    rows = arr.tolist()
    pre = rows[0]
    pre_ci = cids[0]
    pack = (pre, pre)
    size = 0
    st_item = pre
    for k in range(1, len(rows)):
        now = rows[k]
        if pre[2] == now[2]:
            readgap = now[0] - pre[0] - pre[3]
            if readgap < 0:
                continue
            if pre[2] == 1:
                refgap = now[1] - pre[1] - pre[3]
            else:
                refgap = pre[1] - now[1] - now[3]
            if (abs(readgap - refgap) <= 30 and refgap >= 0
                    and pre_ci == cids[k]):
                pre = now
                pre_ci = cids[k]
                continue
        if pre[0] - st_item[0] > size:
            size = pre[0] - st_item[0]
            pack = (st_item, pre)
        pre = now
        pre_ci = cids[k]
        st_item = pre
    if pre[0] - st_item[0] > size:
        pack = (st_item, pre)
    return pack


def _mapq0_tie_break(members, member_scores, paths, read_len, need_reverse,
                     tie_break_seqs):
    """decode_hit's mapq-0 primary re-selection (mammap_clrnano.py live
    def): among cluster-0 candidates within 0.999 of the best score, pick
    the one whose main colinear block has the lowest Myers edit-distance
    ratio (<= keeps the LAST equal candidate, like the reference)."""
    from .. import native
    from ..ops.edit import edit_distance
    from .extend import query_target_between

    codes, rc_codes, ref = tie_break_seqs
    fwd, rev = (rc_codes, codes) if need_reverse else (codes, rc_codes)
    base_score = member_scores[0]
    best = None
    min_diff = 10.0
    for mi, iloc in enumerate(members):
        if member_scores[mi] / base_score < 0.999:
            break
        pre, now = _main_alignment_span(paths[iloc][::-1], ref.starts)
        if pre[2] != now[2] or pre[0] == now[0]:
            continue
        t, q = query_target_between(pre, now, fwd, rev, read_len, ref)
        mn = min(len(t), len(q))
        if mn == 0:
            continue
        # candidates can only win with d/mn <= min_diff, so a banded pass
        # capped there is decision-exact (d > cap -> cannot improve);
        # native Myers bit-vector when present, capped numpy band otherwise.
        # The admissible cap can be huge (min_diff starts at 10.0), so climb
        # a x4 cap ladder: a banded pass is exact whenever d <= cap, and
        # real main-block divergences are a few percent, so the first rung
        # almost always decides at a fraction of the full-band cost.
        cap_full = min(int(min_diff * mn) + 1, len(t) + len(q))
        qa, ta = np.asarray(q), np.asarray(t)
        cap = min(cap_full, max(128, mn >> 4))
        while True:
            d = native.edit_distance_native(qa, ta, cap=cap)
            if d is None:
                d = edit_distance(qa, ta, cap=cap)
            if d <= cap or cap >= cap_full:
                break
            cap = min(cap * 4, cap_full)
        if d > cap_full:
            continue
        d = d / mn
        if d <= min_diff:
            min_diff = d
            best = iloc
    if best is not None and best != 0:
        return best
    return None


def chain_read(
    anchors: np.ndarray,
    read_len: int,
    kmersize: int,
    skipcost: float,
    maxdiff: int,
    maxgap: int = 1000,
    accept_score: float = 60.0,
    bin_size: int = 100,
    overlap_percentage: float = 0.5,
    refund: bool = False,
    cov_adapt: bool = True,
    chain_backend=None,
    precomputed=None,
    tie_break_seqs=None,
) -> Optional[GlobalChains]:
    """Full global chaining for one read's anchors (sorted any order).

    Returns None when the read has too few anchors or no accepted chain.
    ``chain_backend`` optionally supplies a per-call device backend;
    ``precomputed`` is a (need_reverse, sorted_anchors, ChainResult)
    triple from the batched executor.

    ``tie_break_seqs`` = (read_codes, rc_read_codes, RefView) enables the
    mapq-0 primary re-selection (decode_hit, mammap_clrnano.py live def):
    among same-cluster candidates within 0.999 of the best score, the one
    whose main colinear block has the lowest edit-distance ratio becomes
    the primary.  R mode ships with this block commented out
    (mammap_noprefercloser.py), so R passes None.
    """
    if precomputed is not None:
        need_reverse, A, res = precomputed
    else:
        if len(anchors) <= 2:
            return None
        need_reverse, A = prepare_read_anchors(anchors, read_len)
        res = None

    variant = "refund" if refund else ("global" if cov_adapt else "global_nocov")
    dense = len(A) / max(read_len, 1) > 5
    if res is None and not dense:
        if chain_backend is not None:
            res = chain_backend(A, variant, kmersize, skipcost, maxdiff, maxgap)
        if res is None:
            res = chain_dp(
                A,
                kmersize=kmersize,
                skipcost=skipcost,
                maxdiff=maxdiff,
                maxgap=maxgap,
                variant=variant,
            )
    if res is None or res.aborted:
        res = chain_dp_fast(
            A,
            kmersize=kmersize,
            skipcost=skipcost,
            maxdiff=maxdiff,
            maxgap=maxgap,
            variant=variant,
        )

    paths, scores, best_s_arr = _backtrack_all(A, res)
    if not paths:
        return None
    max_scores = max(scores)
    if not (max_scores > accept_score):
        return None

    order = np.argsort(np.asarray(scores))[::-1]
    # global best path is forced to the front (mammap_clrnano.py:23664-23669)
    if order[0] != 0:
        z = int(np.flatnonzero(order == 0)[0])
        order[z] = order[0]
        order[0] = 0

    # primary clustering by read-pos bins with 0.5 overlap
    primary_binsets = [_readloc_bins(paths[order[0]], bin_size)]
    primary_scores: List[List[float]] = [[scores[order[0]]]]
    primary_members: List[int] = [int(order[0])]  # cluster-0 path indices
    for iloc in order[1:]:
        bins_b = _readloc_bins(paths[iloc], bin_size)
        max_ov, prefer = 0.0, -1
        for p_loc, bins_a in enumerate(primary_binsets):
            ov = _overlapsize(bins_a, bins_b)
            if ov > max_ov:
                max_ov, prefer = ov, p_loc
        if max_ov < overlap_percentage:
            primary_binsets.append(bins_b)
            primary_scores.append([scores[iloc]])
        else:
            primary_scores[prefer].append(scores[iloc])
            if prefer == 0:
                primary_members.append(int(iloc))

    m = len(paths[order[0]])
    f1 = primary_scores[0][0]
    f2 = primary_scores[0][1] if len(primary_scores[0]) > 1 else 0.0
    mapq = min(int(40 * (1 - f2 / f1) * min(1.0, m / 10) * np.log(f1)), 60)

    secondaries = _select_secondaries(order, paths, scores, best_s_arr, read_len)

    primary_path, primary_score = paths[0], scores[0]
    if mapq == 0 and tie_break_seqs is not None:
        chosen = _mapq0_tie_break(
            primary_members, primary_scores[0], paths, read_len,
            need_reverse, tie_break_seqs,
        )
        if chosen is not None:
            primary_path, primary_score = paths[chosen], scores[chosen]

    return GlobalChains(
        mapq=mapq,
        score=-primary_score if need_reverse else primary_score,
        paths=[primary_path] + secondaries,
        need_reverse=need_reverse,
    )
