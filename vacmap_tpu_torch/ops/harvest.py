"""Local k=9 exact-match anchor harvest.

Equivalent of the reference's ``get_localmap_multi_all_forDP_inv_guide_1``
(mammap_clrnano.py:23069-23345): build an exact 9-mer table over reference
windows around a guide chain, scan every read position, keep hits near the
guide diagonal, and merge colinear hits into variable-length anchors via a
per-diagonal cache.

Design differences from the reference (documented deviations):
  * 9-mers are 2-bit integer codes instead of Python string hashes, so
    matching is a vectorized sorted-array join (deterministic and
    device-friendly) rather than dict probes.
  * The reference splits its table into single-hit and multi-hit dicts;
    a sorted array handles both uniformly.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..seq import kmer_codes, rc_kmer

LOOK_SPAN = 7000  # mammap_clrnano.py:23097 (overrides the computed span)


def _ref_windows(guide: np.ndarray, contig_starts: np.ndarray,
                 contig_lens: np.ndarray, look_span: int = LOOK_SPAN):
    """Reference windows around the guide chain's ref intervals
    (mammap_clrnano.py:23098-23131): group ref-sorted guide anchors into
    runs with gaps < readgap_threshold, extend each by the look span, clip
    to the containing contig.  Falls back to per-contig grouping when a
    window would cross a contig boundary."""
    # max consecutive read-pos jump + 1000, at least 5000
    rp = guide[:, 0]
    readgap = int(np.abs(np.diff(rp)).max()) if len(rp) > 1 else 0
    readgap = max(readgap + 1000, 5000)

    by_ref = guide[np.argsort(guide[:, 1], kind="stable")]
    refs = by_ref[:, 1]

    def contig_of(pos):
        return max(int(np.searchsorted(contig_starts, pos, side="right")) - 1, 0)

    def group(split_on_contig: bool):
        spans = []
        st = en = int(refs[0])
        cur_c = contig_of(st)
        for v in refs[1:]:
            v = int(v)
            same_c = (not split_on_contig) or contig_of(v) == cur_c
            if v - en < readgap and same_c:
                en = v
            else:
                if st != en:
                    spans.append((st, en))
                st = en = v
                cur_c = contig_of(v)
        if st != en:
            spans.append((st, en))
        return spans

    spans = group(split_on_contig=False)
    if any(contig_of(a) != contig_of(b) for a, b in spans):
        spans = group(split_on_contig=True)
        spans = [(a, b) for a, b in spans if contig_of(a) == contig_of(b)]

    windows = []
    for a, b in spans:
        ci = contig_of(a)
        cstart = int(contig_starts[ci])
        cend = cstart + int(contig_lens[ci])
        lo = max(a - look_span, cstart)
        hi = min(b + look_span, cend)
        windows.append((lo, hi))
    return windows


def harvest_anchors(
    guide: np.ndarray,
    read_codes: np.ndarray,
    rc_read_codes: np.ndarray,
    ref_codes: np.ndarray,
    contig_starts: np.ndarray,
    contig_lens: np.ndarray,
    kmersize: int = 9,
    ref_margin: int = LOOK_SPAN,
    read_margin: int = LOOK_SPAN,
    read_start: int | None = None,
    read_end: int | None = None,
) -> np.ndarray:
    """Harvest merged k=9 anchors for one guide chain.

    The H/L/S modes use +-7 kb margins for both the reference windows and
    the read scan span (mammap_clrnano.py:23097); R mode's guide_1 uses
    +-2 kb / +-500 (mammap_noprefercloser.py live def).

    ``read_start``/``read_end`` override the scan span with the explicit
    batch bounds of asm's collect_second_round_anchors (mammap_asm.py
    live def: scan positions [r_st, r_en - k), ref windows +-2 kb).

    guide: (m,4) anchor array (any order).  read/rc/ref codes: uint8 base
    codes; ref_codes is the whole concatenated reference.  Returns an
    (m, 4) int64 array of (readpos, refpos_global, strand, len) anchors.
    """
    k = kmersize
    read_len = len(read_codes)
    empty = np.zeros((0, 4), np.int64)
    windows = _ref_windows(guide, contig_starts, contig_lens,
                           look_span=ref_margin)
    if not windows:
        return empty

    # --- read scan span (guide read span +/- LOOK_SPAN) ------------------
    if read_start is not None:
        readstart = max(0, int(read_start))
        readend = int(read_end) - k
    else:
        rp_sorted = np.sort(guide[:, 0])
        readstart = max(0, int(rp_sorted[0]) - read_margin)
        readend = min(read_len - k + 1, int(rp_sorted[-1]) + read_margin)
    if readend <= readstart:
        return empty

    # native fast path: table + scan + proximity + merge in one C++ call
    from .. import native

    if native.available():
        g_by_read = guide[np.argsort(guide[:, 0], kind="stable")]
        merged = native.harvest_join_native(
            ref_codes, windows, read_codes, readstart, readend,
            g_by_read[:, 0], g_by_read[:, 1], k,
        )
        if merged is not None:
            return merged

    # --- reference k-mer table over the windows (numpy fallback) --------
    ref_kmers_parts, ref_pos_parts = [], []
    for lo, hi in windows:
        seg = ref_codes[lo:hi]
        km, ok = kmer_codes(seg, k)
        idx = np.flatnonzero(ok)
        ref_kmers_parts.append(km[idx])
        ref_pos_parts.append(idx + lo)
    ref_kmers = np.concatenate(ref_kmers_parts)
    ref_pos = np.concatenate(ref_pos_parts)
    if len(ref_kmers) == 0:
        return empty
    order = np.argsort(ref_kmers, kind="stable")
    ref_kmers, ref_pos = ref_kmers[order], ref_pos[order]

    pos = np.arange(readstart, readend, dtype=np.int64)
    km_all, ok_all = kmer_codes(read_codes, k)
    fwd = km_all[readstart:readend]
    okf = ok_all[readstart:readend]
    rc = rc_kmer(fwd, k)
    palindrome = fwd == rc
    valid = okf & ~palindrome
    pos, fwd, rc = pos[valid], fwd[valid], rc[valid]
    if len(pos) == 0:
        return empty

    # --- guide proximity precomputation ---------------------------------
    g_by_read = guide[np.argsort(guide[:, 0], kind="stable")]
    g_rp = g_by_read[:, 0].astype(np.int64)
    g_ref = g_by_read[:, 1].astype(np.int64)
    # two nearest guide anchors by readpos (findClosest_1,
    # mammap_clrnano.py:17560): indices j-1 and j around the insertion point
    ins = np.searchsorted(g_rp, pos)
    i0 = np.clip(ins - 1, 0, len(g_rp) - 1)
    i1 = np.clip(ins, 0, len(g_rp) - 1)
    bias0 = np.abs(g_rp[i0] - pos)
    bias1 = np.abs(g_rp[i1] - pos)
    # at-or-beyond-boundary cases collapse to one anchor like the reference
    at_edge = (pos <= g_rp[0]) | (pos >= g_rp[-1])
    edge_i = np.where(pos <= g_rp[0], 0, len(g_rp) - 1)
    i0 = np.where(at_edge, edge_i, i0)
    i1 = np.where(at_edge, edge_i, i1)
    # exact readpos match collapses both neighbours onto the match
    exact = g_rp[i1] == pos
    i0 = np.where(exact, i1, i0)
    bias0 = np.abs(g_rp[i0] - pos)
    bias1 = np.abs(g_rp[i1] - pos)
    interval = np.minimum(bias0 + bias1 + 500, 2000)
    ref0 = g_ref[i0]
    ref1 = g_ref[i1]
    readgap = np.abs(pos - g_rp[i0])

    def matches(kmers):
        lo = np.searchsorted(ref_kmers, kmers, side="left")
        hi = np.searchsorted(ref_kmers, kmers, side="right")
        cnt = hi - lo
        total = int(cnt.sum())
        if total == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        src = np.repeat(np.arange(len(kmers)), cnt)
        csum = np.concatenate(([0], np.cumsum(cnt)))
        within = np.arange(total) - np.repeat(csum[:-1], cnt)
        ridx = np.repeat(lo, cnt) + within
        return src, ref_pos[ridx]

    out: List[Tuple[int, int, int, int]] = []
    out_arrays: List[np.ndarray] = []
    for strand, kmers in ((1, fwd), (-1, rc)):
        src, refloc = matches(kmers)
        if len(src) == 0:
            continue
        refgap = np.abs(refloc - ref0[src])
        diff = np.abs(readgap[src] - refgap)
        near = (
            (diff < 500)
            | ((ref0[src] + interval[src] >= refloc) & (ref0[src] - interval[src] <= refloc))
            | ((ref1[src] + interval[src] >= refloc) & (ref1[src] - interval[src] <= refloc))
        )
        src, refloc = src[near], refloc[near]
        if len(src) == 0:
            continue
        rpos = pos[src]
        diag = refloc - rpos if strand == 1 else -(refloc + rpos)
        # process per diagonal in read order, replicating the pointdict
        # grow/emit rule (mammap_clrnano.py:23260-23344)
        o2 = np.lexsort((rpos, diag))
        rpos, refloc, diag = rpos[o2], refloc[o2], diag[o2]
        from .. import native

        if native.available():
            merged = native.merge_diag_runs_native(rpos, refloc, diag, strand, k)
            if merged is not None:
                out_arrays.append(merged)
                continue
        out.extend(_merge_diagonal_runs(rpos, refloc, diag, strand, k))
    if out:
        out_arrays.append(np.asarray(out, np.int64).reshape(-1, 4))
    if not out_arrays:
        return empty
    return np.concatenate(out_arrays, axis=0)


def _merge_diagonal_runs(rpos, refloc, diag, strand, k):
    """Per-diagonal colinear merge: grow an anchor while new hits overlap
    its end; once its length would reach 20, emit it and continue from its
    end (mammap_clrnano.py:23260-23305)."""
    out = []
    n = len(rpos)
    i = 0
    while i < n:
        d = diag[i]
        # current anchor cache: (read_start, ref_left, len)
        a_r, a_y, a_l = int(rpos[i]), int(refloc[i]), k
        i += 1
        while i < n and diag[i] == d:
            r, y = int(rpos[i]), int(refloc[i])
            i += 1
            if a_r + a_l >= r:
                bouns = r - (a_r + a_l) + k
                if bouns > 0:
                    if a_l + bouns < 20:
                        if strand == 1:
                            a_l += bouns
                        else:
                            a_y = y  # leftmost ref shrinks for minus strand
                            a_l += bouns
                    else:
                        out.append((a_r, a_y, strand, a_l))
                        if strand == 1:
                            a_r, a_y, a_l = a_r + a_l, a_y + a_l, bouns
                        else:
                            a_r, a_y, a_l = a_r + a_l, y, bouns
                # bouns <= 0: hit fully contained, ignore
            else:
                out.append((a_r, a_y, strand, a_l))
                a_r, a_y, a_l = r, y, k
        out.append((a_r, a_y, strand, a_l))
    return out
