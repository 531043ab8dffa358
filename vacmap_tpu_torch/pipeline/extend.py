"""Chain-to-alignment refinement: segment splitting, divergence filter,
edge extension, artifact dropping, merging, inversion fixing, and
base-level CIGAR production.

Equivalent of ``extend_func`` and its helpers
(mammap_clrnano.py:19238-19303, :23437, :2302, :726, :16736, :24226,
:21505, :20731).

Anchor tuples are (readpos, refpos_global, strand, len); alignment
segments are lists of anchors in ASCENDING read order.
"""

from __future__ import annotations

import os

from typing import Callable, List, Optional, Tuple

import numpy as np

from ..errors import DeviceKernelError
from ..ops.affine_ref import AlignResult, align2p
from ..ops.edit import divergence_exceeds
from ..seq import revcomp_codes


class RefView:
    """Reference access helpers shared by the refinement passes."""

    def __init__(self, ref_codes, contig_starts, contig_lens, contig_names):
        self.codes = ref_codes
        self.starts = np.asarray(contig_starts, np.int64)
        self.lens = np.asarray(contig_lens, np.int64)
        self.names = list(contig_names)

    def contig_index(self, pos: int) -> int:
        return max(int(np.searchsorted(self.starts, pos, side="right")) - 1, 0)

    def contig_name(self, pos: int) -> str:
        return self.names[self.contig_index(pos)]

    def contig_start(self, pos: int) -> int:
        return int(self.starts[self.contig_index(pos)])

    def contig_end(self, pos: int) -> int:
        ci = self.contig_index(pos)
        return int(self.starts[ci] + self.lens[ci])

    def fetch(self, gstart: int, gend: int) -> np.ndarray:
        return self.codes[gstart:gend]


# ---------------------------------------------------------------------------
# segment splitting (rebuild_chain_break, mammap_clrnano.py:23437-23484)
# ---------------------------------------------------------------------------


def rebuild_chain_break(
    path: List[tuple], ref: RefView, large_cost: int,
    small_alignment: int = 50, allow_dup_overlap: bool = True,
) -> List[List[tuple]]:
    """Split a chained path (ascending read order) into colinear segments
    at breaks; drop one-anchor and sub-50bp segments; tolerate small
    duplication overlaps (refgap<0 with readgap<=20 skips the anchor).

    ``allow_dup_overlap=False`` is the asm module's rule (mammap_asm.py
    live rebuild_chain_break): a plain ``refgap >= 0`` accept with no
    duplication-overlap tolerance."""
    if len(path) == 0:
        return []
    from .. import native

    if native.available():
        A = np.asarray(path, np.int64)
        res = native.rebuild_chain_break_native(
            A, ref.starts, large_cost, small_alignment, allow_dup_overlap
        )
        if res is not None:
            seg_id, n_segs = res
            # kept anchors form contiguous non-decreasing seg_id runs: cut
            # at the run boundaries instead of a per-row append loop
            keep = np.flatnonzero(seg_id >= 0)
            if len(keep) == 0:
                return []
            cuts = np.flatnonzero(np.diff(seg_id[keep])) + 1
            return [
                list(map(tuple, A[c].tolist()))
                for c in np.split(keep, cuts)
            ]
    # one vectorized contig lookup for the whole path (pos2contig per
    # junction is a hot spot otherwise)
    if isinstance(path, np.ndarray):
        path = list(map(tuple, path.tolist()))
    refs = np.fromiter((p[1] for p in path), np.int64, len(path))
    cids = np.searchsorted(ref.starts, refs, side="right") - 1
    pre = path[0]
    pre_cid = int(cids[0])
    segs: List[List[tuple]] = [[pre]]
    for idx1 in range(1, len(path)):
        now = path[idx1]
        now_cid = int(cids[idx1])
        if pre[2] == now[2]:
            readgap = now[0] - pre[0] - pre[3]
            if pre[2] == 1:
                refgap = now[1] - pre[1] - pre[3]
            else:
                refgap = pre[1] - now[1] - now[3]
            if (
                abs(readgap - refgap) <= large_cost
                and refgap >= (-20 if allow_dup_overlap else 0)
                and readgap < 100
                and pre_cid == now_cid
            ):
                if refgap >= 0:
                    segs[-1].append(now)
                    pre, pre_cid = now, now_cid
                    continue
                elif readgap <= 20:
                    # small duplication overlap: skip the anchor entirely
                    continue
                else:
                    segs[-1].append(now)
                    pre, pre_cid = now, now_cid
                    continue
        if len(segs[-1]) == 1:
            segs.pop()
        if segs and (segs[-1][-1][0] + segs[-1][-1][3] - segs[-1][0][0]) < small_alignment:
            segs.pop()
        segs.append([now])
        pre, pre_cid = now, now_cid
    if segs and len(segs[-1]) == 1:
        segs.pop()
    if segs and (segs[-1][-1][0] + segs[-1][-1][3] - segs[-1][0][0]) < small_alignment:
        segs.pop()
    return segs


# ---------------------------------------------------------------------------
# per-segment sequence extraction (get_query_target_for_cigar,
# mammap_clrnano.py:5802-5818)
# ---------------------------------------------------------------------------


def query_target_between(pre, now, read_codes, rc_read_codes, read_len, ref: RefView):
    """Sequences between anchor `pre` and anchor `now` (ascending read
    order) on pre's strand; query in read orientation matching target."""
    if pre[2] == 1:
        target = ref.fetch(pre[1], now[1])
        query = read_codes[pre[0] : now[0]]
    else:
        target = ref.fetch(now[1] + now[3], pre[1] + pre[3])
        query = rc_read_codes[read_len - now[0] : read_len - pre[0]]
    return target, query


# ---------------------------------------------------------------------------
# divergence filter (extend_func, mammap_clrnano.py:19247-19253)
# ---------------------------------------------------------------------------


def _nm_from_eqx(cigar: str) -> int:
    import re

    return sum(int(n) for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar)
               if op in "XID")


def _window_bound_jobs(segs, keys, read_codes, rc_read_codes, read_len,
                       ref, force_gap: int):
    """Job construction for the window-bound pass: each candidate
    segment's interior window (target, query) pairs.  Segments with a
    window past the striped/device class (>768) are skipped — the Myers
    ladder is cheaper for those.  Returns (seg_pairs, all_pairs,
    all_keys) where seg_pairs = [(key, n_windows)]."""
    seg_pairs, all_pairs, all_keys = [], [], []
    for key, seg in zip(keys, segs):
        try:
            kept, pairs = segment_cigar_jobs(
                seg, read_codes, rc_read_codes, read_len, ref,
                force_gap=force_gap)
        except RuntimeError:
            continue
        if any(max(len(t), len(q)) > 768 for t, q in pairs):
            continue  # banded/scalar class: the Myers ladder is cheaper
        seg_pairs.append((key, len(pairs)))
        all_pairs.extend(pairs)
        all_keys.extend(zip(kept, kept[1:]))
    return seg_pairs, all_pairs, all_keys


def _bounds_from_cigars(seg_pairs, all_keys, cigs, cache: dict):
    """Per-segment bounds + cache fill from already-computed window
    cigars (the device fill service path: NM parsed per cigar)."""
    for key2, cig in zip(all_keys, cigs):
        cache[key2] = cig
    nm = [_nm_from_eqx(c) for c in cigs]
    out = {}
    off = 0
    for key, n in seg_pairs:
        out[key] = int(sum(nm[off : off + n]))
        off += n
    return out


def _window_fill_bounds(segs, keys, read_codes, rc_read_codes, read_len,
                        ref, eqx: bool, force_gap: int, cache: dict):
    """Upper bounds on the given segments' span UNIT edit distances via
    their interior window alignments: anchors are exact matches by
    construction, and each window alignment path's X+I+D count bounds
    that window's true edit distance, so the per-segment sum bounds
    d(span).  All windows of all segments align as ONE striped batch
    (per-segment batches stripe poorly); cigars go into ``cache`` for
    reuse by the final fill stage — interior windows are untouched by
    edge extension, so the fill work is moved, not duplicated.

    Returns {key: bound}; a segment is absent when the bound is
    unusable for it (degenerate walk, non-eqx cigars, or a window past
    the striped-kernel class — the Myers ladder handles those)."""
    out = {}
    if not eqx:
        return out
    seg_pairs, all_pairs, all_keys = _window_bound_jobs(
        segs, keys, read_codes, rc_read_codes, read_len, ref, force_gap)
    if not seg_pairs:
        return out
    from .. import native

    nm_arr = None
    cigs = None
    if native.available() and all(len(t) and len(q) for t, q in all_pairs):
        res = native.align2p_batch_native(all_pairs, eqx=True,
                                          return_plane=True)
        if res is not None:
            plane, meta = res
            cigs = native.ops_to_cigars_plane(plane, meta)
            if cigs is not None:
                # NM per item straight off the ops plane (op 1=I 2=D 4=X),
                # one reduceat instead of per-item cigar parses
                used = int(meta[:, 0].max() + meta[meta[:, 0].argmax(), 1]
                           ) if len(meta) else 0
                ops = plane[:used]
                contrib = np.where(
                    (ops[:, 0] == 1) | (ops[:, 0] == 2) | (ops[:, 0] == 4),
                    ops[:, 1], 0).astype(np.int64)
                csum = np.concatenate(([0], np.cumsum(contrib)))
                nm_arr = (csum[(meta[:, 0] + meta[:, 1])] - csum[meta[:, 0]])
    if cigs is None:
        results = _host_global_batch(all_pairs, eqx)
        cigs = [r.cigar for r in results]
        nm_arr = np.array([_nm_from_eqx(c) for c in cigs], np.int64)
    for key2, cig in zip(all_keys, cigs):
        cache[key2] = cig
    off = 0
    for key, n in seg_pairs:
        out[key] = int(nm_arr[off : off + n].sum())
        off += n
    return out


def divergence_filter(
    segs: List[List[tuple]],
    read_codes,
    rc_read_codes,
    read_len: int,
    ref: RefView,
    max_ratio: float,
    edit_client=None,
    eqx: bool = True,
    force_gap: int = 0,
    window_cache: dict = None,
    precomputed_bounds: dict = None,
) -> List[List[tuple]]:
    """Drop segments whose span divergence exceeds max_ratio.

    With ``edit_client`` (a fill-service client exposing ``edit_batch``)
    the whole batch of span pairs is resolved as EXACT device edit
    distances — decisions identical to the host
    ladder; unrouted pairs fall back per pair.

    With ``window_cache`` (host path), each span first tries the
    window-fill upper bound: d(span) <= sum of interior window NM, so
    ``bound <= cap`` proves "keep" without running Myers at all, and
    the computed window cigars are reused by the final fill stage.
    Spans the bound cannot settle (borderline/junk) fall through to the
    exact Myers ladder — the keep/drop DECISION is identical either
    way."""
    spans, metas, out = [], [], []
    for seg in segs:
        t, q = query_target_between(
            seg[0], seg[-1], read_codes, rc_read_codes, read_len, ref
        )
        spans.append((t, q))
    dists = None
    if edit_client is not None and spans:
        try:
            dists = edit_client.edit_batch(spans)
            if dists is not None and all(d is None for d in dists):
                # edit offload unavailable (service has no edit kernel):
                # fall back to the window-bound pass — treating this as
                # "dists resolved" silently disabled the bound pass AND
                # the window cigar cache in the round-3 device deployment
                dists = None
        except DeviceKernelError:  # a device fault stops the run
            raise
        except Exception:
            dists = None
    bounds = {}
    if precomputed_bounds is not None:
        bounds = precomputed_bounds
    elif window_cache is not None:
        # bound pass for every span the edit offload did not settle
        cand = [k for k, seg in enumerate(segs)
                if (dists is None or dists[k] is None)
                and len(spans[k][0]) and len(spans[k][1])]
        if cand:
            bounds = _window_fill_bounds(
                [segs[k] for k in cand], cand, read_codes, rc_read_codes,
                read_len, ref, eqx, force_gap, window_cache)
    for k, seg in enumerate(segs):
        t, q = spans[k]
        if len(t) == 0 or len(q) == 0:
            out.append(seg)
            continue
        d = dists[k] if dists is not None else None
        if d is not None:
            if d <= int(max_ratio * min(len(t), len(q))):
                out.append(seg)
            continue
        b = bounds.get(k)
        if b is not None and b <= int(max_ratio * min(len(t), len(q))):
            out.append(seg)
            continue
        if not divergence_exceeds(t, q, max_ratio):
            out.append(seg)
    return out


# ---------------------------------------------------------------------------
# edge extension (extend_edge_test, mammap_clrnano.py:2302-2526)
# ---------------------------------------------------------------------------

MAX_EXTEND = 20_000
_EXT_KW = dict(
    match=2, mismatch=-4, gap_open_1=4, gap_extend_1=4,
    gap_open_2=4, gap_extend_2=4, bw=100, zdrop=50,
)


def _host_ext_batch(pairs):
    return [align2p(t, q, **_EXT_KW) for t, q in pairs]


def extend_edges(
    segs: List[List[tuple]],
    read_codes,
    read_len: int,
    ref: RefView,
    san: int = 1,
    aligner: Optional[Callable] = None,
) -> None:
    """Extend each segment's both ends toward the read ends / neighbouring
    segments with banded zdrop extension alignment; the end anchors are
    replaced by zero-length anchors at the extended positions.

    Runs as two batched waves — all right/end edges first (they depend
    only on the raw start of the following segment), then all left/start
    edges (they depend on the previous segment's extended end) — which is
    dependency-equivalent to the reference's interleaved sequential order
    (mammap_clrnano.py:2321-2526) but lets all alignments in a wave run as
    one device batch.  ``aligner`` is a batch callable: list of
    (target_codes, query_codes) -> list of results with .q_end/.t_end.
    """
    batch_align = aligner or _host_ext_batch

    # ---- wave 1: right/end edges -------------------------------------
    jobs, meta = [], []
    for idx, seg in enumerate(segs):
        if seg[-1][0] + seg[-1][3] < read_len:
            nxt_idx = min(idx + san, len(segs))
            if nxt_idx == len(segs):
                looksize = read_len - (seg[-1][0] + seg[-1][3])
            else:
                looksize = segs[nxt_idx][0][0] - (seg[-1][0] + seg[-1][3])
            item = seg[-1]
            if item[2] == 1:
                target_en = item[1] + item[3]
                query_en = item[0] + item[3]
                looksize = min(looksize, ref.contig_end(item[1]) - (target_en - 1))
                looksize = min(looksize, MAX_EXTEND)
                if looksize > 0:
                    q = read_codes[query_en : query_en + looksize]
                    t = ref.fetch(target_en, target_en + len(q))
                    jobs.append((t, q))
                    meta.append((idx, 1, query_en, target_en))
            else:
                target_st = item[1]
                query_en = item[0] + item[3]
                looksize = min(looksize, target_st - ref.contig_start(item[1]))
                looksize = min(looksize, MAX_EXTEND)
                if looksize > 0:
                    q = read_codes[query_en : query_en + looksize]
                    t = revcomp_codes(ref.fetch(target_st - len(q), target_st))
                    jobs.append((t, q))
                    meta.append((idx, -1, query_en, target_st))
        else:
            item = seg[-1]
            if item[2] == 1:
                seg[-1] = (item[0] + item[3], item[1] + item[3], 1, 0)
            else:
                seg[-1] = (item[0] + item[3], item[1], -1, 0)
    for (idx, strand, query_en, tpos), r in zip(meta, batch_align(jobs)):
        if strand == 1:
            segs[idx][-1] = (query_en + r.q_end, tpos + r.t_end, 1, 0)
        else:
            segs[idx][-1] = (query_en + r.q_end, tpos - r.t_end, -1, 0)

    # ---- wave 2: left/start edges ------------------------------------
    jobs, meta = [], []
    for idx, seg in enumerate(segs):
        if seg[0][0] > 0:
            if idx == 0 or idx - san < 0:
                looksize = seg[0][0]
            else:
                p = segs[max(idx - san, 0)][-1]
                looksize = seg[0][0] - (p[0] + p[3])
            item = seg[0]
            if item[2] == 1:
                target_st = item[1]
                query_st = item[0]
                looksize = min(looksize, target_st - ref.contig_start(item[1]))
                looksize = min(looksize, MAX_EXTEND)
                if looksize > 0:
                    q = read_codes[max(query_st - looksize, 0) : query_st][::-1]
                    t = ref.fetch(target_st - len(q), target_st)[::-1]
                    jobs.append((t, q))
                    meta.append((idx, 1, query_st, target_st))
            else:
                target_en = item[1] + item[3]
                query_st = item[0]
                looksize = min(looksize, ref.contig_end(item[1]) - (target_en - 1))
                looksize = min(looksize, MAX_EXTEND)
                if looksize > 0:
                    q = read_codes[max(query_st - looksize, 0) : query_st][::-1]
                    t = revcomp_codes(ref.fetch(target_en, target_en + len(q)))[::-1]
                    jobs.append((t, q))
                    meta.append((idx, -1, query_st, target_en))
        else:
            item = seg[0]
            if item[2] == 1:
                seg[0] = (item[0], item[1], 1, 0)
            else:
                seg[0] = (item[0], item[1] + item[3], -1, 0)
    for (idx, strand, query_st, tpos), r in zip(meta, batch_align(jobs)):
        if strand == 1:
            segs[idx][0] = (query_st - r.q_end, tpos - r.t_end, 1, 0)
        else:
            segs[idx][0] = (query_st - r.q_end, tpos + r.t_end, -1, 0)


# ---------------------------------------------------------------------------
# misplaced-segment drop (drop_misplaced_alignment_test,
# mammap_clrnano.py:726-786)
# ---------------------------------------------------------------------------


def _junction_gaps(a_end, b_start):
    readgap = b_start[0] - a_end[0] - a_end[3]
    if a_end[2] == 1:
        refgap = b_start[1] - a_end[1] - a_end[3]
    else:
        refgap = a_end[1] - b_start[1] - b_start[3]
    return readgap, refgap


def drop_misplaced(segs: List[List[tuple]], iloc: int) -> bool:
    """Remove a short middle segment whose flanking junctions form one
    INS plus one DEL of similar magnitude (a misplaced-alignment
    artifact)."""
    a, b, c = segs[iloc], segs[iloc + 1], segs[iloc + 2]
    if not (a[0][2] == b[0][2] == c[0][2]):
        return False
    midsize = b[-1][0] + b[-1][3] - b[0][0]
    if midsize > 1000:
        return False
    readgap, refgap = _junction_gaps(a[-1], b[0])
    if abs(refgap) >= 100_000:
        return False
    DEL = INS = 0
    d = readgap - refgap
    if d < -30:
        DEL += 1
    elif d > 30:
        INS += 1
    else:
        return False
    gap_1 = abs(d)
    readgap, refgap = _junction_gaps(b[-1], c[0])
    if abs(refgap) >= 100_000:
        return False
    d = readgap - refgap
    if d < -30:
        DEL += 1
    elif d > 30:
        INS += 1
    else:
        return False
    gap_2 = abs(d)
    if DEL == 1 and INS == 1 and (midsize < 500 or max(gap_1, gap_2) / midsize > 0.5):
        segs.pop(iloc + 1)
        return True
    return False


# ---------------------------------------------------------------------------
# adjacent-segment merge (merge_conjacent_alignment + getdupiloc,
# mammap_clrnano.py:16736-16780, :16680-16734)
# ---------------------------------------------------------------------------


def _dup_ilocs(segs) -> set:
    dup = set()
    if len(segs) < 2:
        return dup
    iloc = 0
    while iloc + 1 < len(segs):
        last = segs[iloc][-1]
        readpos_1 = last[0] + last[3]
        if last[2] == 1:
            refpos_1, strand_1 = last[1] + last[3], 1
        else:
            refpos_1, strand_1 = last[1], -1
        jloc = iloc
        hit = False
        dupsize = 0
        new_iloc = iloc
        readpos_2 = 0
        while jloc + 1 < len(segs):
            jloc += 1
            first = segs[jloc][0]
            lastj = segs[jloc][-1]
            if lastj[2] == 1:
                refpos_2, strand_2 = first[1], 1
            else:
                # NOTE: the reference reads first[1] + first[2] here
                # (mammap_asm-independent quirk at :16706) — index 2 is the
                # strand, so this is first[1] - 1; we reproduce it.
                refpos_2, strand_2 = first[1] + first[2], -1
            if strand_1 != strand_2:
                continue
            if strand_1 == 1:
                if refpos_2 - refpos_1 < 50:
                    new_iloc, dupsize, readpos_2, hit = (
                        jloc, refpos_2 - refpos_1, first[0], True,
                    )
            else:
                if refpos_1 - refpos_2 < 50:
                    new_iloc, dupsize, readpos_2, hit = (
                        jloc, refpos_1 - refpos_2, first[0], True,
                    )
        if hit:
            readgap = readpos_2 - readpos_1
            if (iloc + 1 < new_iloc) or ((dupsize - readgap) < -30 and readgap < 30):
                for s in range(iloc, new_iloc):
                    dup.add(s)
            iloc = new_iloc
        else:
            iloc += 1
    return dup


def merge_adjacent(segs: List[List[tuple]], ref: RefView) -> None:
    """Merge adjacent same-strand same-contig segments with small read/ref
    junction gaps, skipping duplication-overlap segments."""
    if len(segs) < 2:
        return
    dup = _dup_ilocs(segs)
    iloc = 0
    while iloc + 1 < len(segs):
        if iloc in dup:
            iloc += 1
            continue
        pre, now = segs[iloc][-1], segs[iloc + 1][0]
        if pre[2] != now[2] or ref.contig_index(pre[1]) != ref.contig_index(now[1]):
            iloc += 1
            continue
        readgap, refgap = _junction_gaps(pre, now)
        if refgap < 0:
            iloc += 1
            continue
        if min(readgap, refgap) < 50 and abs(readgap - refgap) < 10_000:
            segs[iloc] = segs[iloc] + segs[iloc + 1]
            segs.pop(iloc + 1)
        else:
            iloc += 1


# ---------------------------------------------------------------------------
# simple inversion fix (fix_simple_inv, mammap_clrnano.py:24226-24313)
# ---------------------------------------------------------------------------


def fix_simple_inv(segs: List[List[tuple]], read_codes, ref: RefView,
                   full: bool = True) -> None:
    """Detect +/-/+ segment triplets forming a perfectly balanced simple
    inversion and re-anchor the middle segment's boundary.

    ``full=False`` reproduces the STALE revision live in the R and asm
    modules (mammap_noprefercloser.py:17155, mammap_asm.py:17159): the
    ``refen_0 > refst_1`` branch computes its probe and does nothing, so
    only the ``refen_0 < refst_1`` case acts."""
    if len(segs) <= 2:
        return
    iloc = 0
    while iloc + 2 < len(segs):
        a, b, c = segs[iloc], segs[iloc + 1], segs[iloc + 2]
        if a[0][2] == c[0][2] and a[0][2] != b[0][2] and a[0][2] == 1:
            bias0 = ref.contig_start(a[0][1])
            refen_0 = a[-1][1] + a[-1][3] - bias0
            readen_0 = a[-1][0] + a[-1][3]
            refst_1 = b[-1][1] - bias0
            readst_1 = b[0][0]
            refen_1 = b[0][1] + b[0][3] - bias0
            readen_1 = b[-1][0] + b[-1][3]
            refst_2 = c[0][1] - bias0
            readst_2 = c[0][0]
            if (
                refst_2 - refen_0 == refen_1 - refst_1
                and readst_1 - readen_0 + readst_2 - readen_1 == 0
            ):
                if refst_1 - refen_0 != 0 and refst_1 - refen_0 + refst_2 - refen_1 == 0:
                    if refen_0 > refst_1:
                        if not full:
                            iloc += 1
                            continue
                        tempref = revcomp_codes(
                            ref.fetch(bias0 + refen_1, bias0 + refen_1 + refen_0 - refst_1)
                        )
                        tempquery = read_codes[readen_0 - refen_0 + refst_1 : readen_0]
                        if len(tempref) == len(tempquery) and np.array_equal(
                            tempref, tempquery
                        ):
                            bias = refen_0 - refst_1
                            c[0] = (readst_2 - bias, bias0 + refst_2 - bias, 1, 0)
                            insertitem = (readst_2 - bias, bias0 + refen_0, -1, 0)
                            while b and insertitem[0] <= (b[-1][0] + b[-1][3]):
                                b.pop()
                            if b:
                                b.append(insertitem)
                    else:
                        tempref = ref.fetch(bias0 + refen_0, bias0 + refst_1)
                        tempquery = read_codes[readen_0 : readen_0 - refen_0 + refst_1]
                        if len(tempref) == len(tempquery) and np.array_equal(
                            tempref, tempquery
                        ):
                            a[-1] = (
                                readen_0 - refen_0 + refst_1,
                                bias0 + refst_1,
                                1,
                                0,
                            )
                            insertitem = (
                                readen_0 - refen_0 + refst_1,
                                bias0 + refen_1 + refen_0 - refst_1,
                                -1,
                                0,
                            )
                            while b and insertitem[0] >= b[0][0]:
                                b.pop(0)
                            if b:
                                b.insert(0, insertitem)
        iloc += 1


# ---------------------------------------------------------------------------
# base-level CIGAR (split_alignment_test, mammap_clrnano.py:21505-21617)
# ---------------------------------------------------------------------------

_GLOBAL_KW = dict(
    match=2, mismatch=-4, gap_open_1=4, gap_extend_1=2,
    gap_open_2=24, gap_extend_2=1, bw=-1, zdrop=-1,
)
MIN_GAP_FOR_CIGAR = 200


def segment_cigar_jobs(
    seg: List[tuple],
    read_codes,
    rc_read_codes,
    read_len: int,
    ref: RefView,
    force_gap: int = 0,
    skip_pairs_in: dict = None,
) -> Tuple[List[tuple], List[Tuple[np.ndarray, np.ndarray]]]:
    """Walk a segment's anchor pairs, batching small gaps (anchor len < 19
    or gap < 200 skipped unless last), and emit the (target, query) pairs
    whose global alignments, concatenated, form the segment CIGAR.

    ``force_gap`` > 0 is the asm rule (mammap_asm.py live
    split_alignment_test): a junction with max(readgap, refgap) >=
    force_gap always emits a window, bounding per-window DP size on
    contigs regardless of anchor length.

    Returns (kept_anchors, pairs); pairs[i] spans kept[i] -> kept[i+1];
    kept[0] and kept[-1] are the zero-length edge anchors.

    ``skip_pairs_in``: windows whose (kept[i], kept[i+1]) key is present
    get ``None`` instead of a built (target, query) pair — the caller
    already holds their cigars (divergence-bound cache) and the sequence
    extraction is the walk's dominant cost."""
    seg = list(seg)
    if seg[0][2] == 1:
        if seg[-1][3] != 0:
            seg[-1] = (seg[-1][0] + seg[-1][3], seg[-1][1] + seg[-1][3], 1, 0)
        walk = seg
    else:
        if seg[0][3] != 0:
            seg[0] = (seg[0][0], seg[0][1] + seg[0][3], -1, 0)
        if seg[-1][3] != 0:
            seg[-1] = (seg[-1][0] + seg[-1][3], seg[-1][1], -1, 0)
        walk = seg[::-1]

    minus = seg[0][2] != 1
    from .. import native

    keep_idx = None
    if native.available() and len(walk) > 1:
        keep_idx = native.segment_walk_keep_native(
            np.asarray(walk, np.int64), minus, force_gap,
            MIN_GAP_FOR_CIGAR,
        )
    if keep_idx is not None:
        if len(keep_idx) == 0:
            raise RuntimeError("Failed to compute CIGAR: no aligned pieces")
        kept = [walk[int(j)] for j in keep_idx]
        pairs = []
        for a, bnow in zip(kept, kept[1:]):
            if skip_pairs_in is not None and (a, bnow) in skip_pairs_in:
                pairs.append(None)  # caller holds this window's cigar
                continue
            if minus:
                t, q = query_target_between(
                    bnow, a, read_codes, rc_read_codes, read_len, ref
                )
            else:
                t, q = query_target_between(
                    a, bnow, read_codes, rc_read_codes, read_len, ref
                )
            if len(t) == 0 or len(q) == 0:
                raise RuntimeError(
                    "Failed to compute CIGAR: empty gap sequences"
                )
            pairs.append((t, q))
        return kept, pairs
    kept = [walk[0]]
    pairs = []
    pre = walk[0]
    i = 1
    while i < len(walk):
        now = walk[i]
        if minus:
            readgap = pre[0] - now[0] - now[3]
            refgap = now[1] - pre[1] - pre[3]
        else:
            readgap = now[0] - pre[0] - pre[3]
            refgap = now[1] - pre[1] - pre[3]
        if not (force_gap > 0 and max(readgap, refgap) >= force_gap):
            if (now[3] < 19) or min(readgap, refgap) < MIN_GAP_FOR_CIGAR:
                if i + 1 != len(walk):
                    i += 1
                    continue
        if minus:
            t, q = query_target_between(
                now, pre, read_codes, rc_read_codes, read_len, ref
            )
        else:
            t, q = query_target_between(
                pre, now, read_codes, rc_read_codes, read_len, ref
            )
        if len(t) == 0 or len(q) == 0:
            raise RuntimeError("Failed to compute CIGAR: empty gap sequences")
        kept.append(now)
        pairs.append((t, q))
        pre = now
        i += 1
    if not pairs:
        raise RuntimeError("Failed to compute CIGAR: no aligned pieces")
    return kept, pairs


def _host_global_batch(pairs, eqx):
    from .. import native

    if native.available() and pairs:
        # empty-side pairs keep the scalar path (special cigar handling)
        if all(len(t) and len(q) for t, q in pairs):
            res = native.align2p_batch_native(pairs, eqx=eqx,
                                              return_plane=True)
            if res is not None:
                cigs = native.ops_to_cigars_plane(res[0], res[1])
                if cigs is not None:
                    # n_del/n_ins left 0: refine_chain only consumes .cigar
                    # NOTE (characterized, round 4): on near-random pairs
                    # the striped R=16 band can return a ~1%-score-
                    # suboptimal path without its escalate-on-edge rule
                    # firing (staircase optima; adversarial test in
                    # test_affine_pallas).  No content statistic separates
                    # that class (X/EQ and NM guards were measured: 8-12%
                    # host cost, zero true positives on pipeline corpora),
                    # and pipeline exposure is nil: divergence-bound NM
                    # stays a valid upper bound (decisions exact) and kept
                    # segments' windows are anchor-bounded similar content
                    # (round-3b: SAM-identical on SV corpora at R=16).
                    return [
                        AlignResult(c, False, len(q), len(t), 0, 0, 0)
                        for c, (t, q) in zip(cigs, pairs)
                    ]
    return [align2p(t, q, eqx=eqx, **_GLOBAL_KW) for t, q in pairs]


# ---------------------------------------------------------------------------
# record assembly (get_onemapinfolist, mammap_clrnano.py:20731-20838)
# ---------------------------------------------------------------------------


def records_from_segments(
    seg_anchor_lists: List[List[tuple]],
    cigar_lists: List[List[str]],
    readid: str,
    mapq: int,
    read_len: int,
    ref: RefView,
    need_reverse: bool,
    use_hardclip: bool,
) -> List[list]:
    """Assemble (readid, contig, strand, q_st, q_en, r_st, r_en, mapq,
    cigar) records with soft/hard clips.  When the read was
    strand-normalized (need_reverse), emitted strands are swapped and the
    record order reversed."""
    clip = "H" if use_hardclip else "S"
    out = []
    for anchors, cigs in zip(seg_anchor_lists, cigar_lists):
        contig = ref.contig_name(anchors[0][1])
        bias = ref.contig_start(anchors[0][1])
        body = "".join(cigs)
        if anchors[0][2] == 1:
            q_st = anchors[0][0]
            q_en = anchors[-1][0] + anchors[-1][3]
            r_st = anchors[0][1]
            r_en = anchors[-1][1] + anchors[-1][3]
            top = f"{q_st}{clip}" if q_st > 0 else ""
            tail = f"{read_len - q_en}{clip}" if read_len - q_en > 0 else ""
            if anchors[-1][3] > 0:
                tail = f"{int(anchors[-1][3])}M" + tail
            strand = "-" if need_reverse else "+"
            out.append(
                [readid, contig, strand, q_st, q_en, r_st - bias, r_en - bias,
                 mapq, top + body + tail]
            )
        else:
            q_st = read_len - anchors[0][0] - anchors[0][3]
            q_en = read_len - anchors[-1][0]
            r_st = anchors[0][1]
            r_en = anchors[-1][1] + anchors[-1][3]
            top = f"{q_st}{clip}" if q_st > 0 else ""
            tail = f"{read_len - q_en}{clip}" if read_len - q_en > 0 else ""
            strand = "+" if need_reverse else "-"
            out.append(
                [readid, contig, strand, q_st, q_en, r_st - bias, r_en - bias,
                 mapq, top + body + tail]
            )
    if need_reverse:
        out = out[::-1]
    # CIGAR length sanity (reference asserts, :20784-20795)
    for rec in out:
        span = _cigar_query_span(rec[8], with_clips=not use_hardclip)
        expect = read_len if not use_hardclip else rec[4] - rec[3]
        if span != expect:
            raise RuntimeError(
                f"CIGAR length {span} != expected {expect} for {readid}"
            )
    return out


def _cigar_query_span(cigar: str, with_clips: bool) -> int:
    from .. import native

    if native.available():
        n = native.cigar_qspan_native(cigar, with_clips)
        if n is not None:
            return n
    import re

    n = 0
    for ln, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar):
        if op in "MI=X" or (op in "SH" and with_clips):
            n += int(ln)
    return n


# ---------------------------------------------------------------------------
# full refinement routine (extend_func, mammap_clrnano.py:19238-19303)
# ---------------------------------------------------------------------------


def refine_chain(
    path_asc: List[tuple],
    readid: str,
    mapq: int,
    read_codes,
    rc_read_codes,
    read_len: int,
    ref: RefView,
    maxdiff: int,
    need_reverse: bool,
    max_divergence: float,
    use_hardclip: bool,
    nofilter: bool,
    eqx: bool,
    extension_aligner: Optional[Callable] = None,
    global_aligner: Optional[Callable] = None,
    simple_inv_full: bool = True,
    rebuild_dup_overlap: bool = True,
    split_force_gap: int = 0,
    rebuild_small_alignment: int = 50,
    defer_fill: bool = False,
) -> Tuple[List[List[tuple]], List[list], bool]:
    """Chain path (ascending read order) -> SAM-ready records.

    Returns (segments, records, filtered) where `filtered` reports whether
    the misplaced-segment pass removed anything (drives the paired-indel
    redo at mammap_clrnano.py:24079).

    With ``defer_fill=True`` and a ``global_aligner`` exposing
    ``submit``/``wait``, returns a ``PendingRefine`` instead: the fill
    batch is in flight on the device and ``finish()`` assembles the
    records when called — the caller pipelines other reads in between
    (the round-3 async TPU deployment, VERDICT.md item 1)."""
    from .. import trace

    with trace.span("rf.rebuild"):
        segs0 = rebuild_chain_break(path_asc, ref, large_cost=maxdiff,
                                    small_alignment=rebuild_small_alignment,
                                    allow_dup_overlap=rebuild_dup_overlap)
    if not segs0:
        return [], [], False
    win_cache: dict = {}

    def _body(pre_bounds, defer, force_host_fill=False):
        with trace.span("rf.diverg"):
            segs = divergence_filter(
                segs0, read_codes, rc_read_codes, read_len, ref,
                max_divergence,
                edit_client=(global_aligner
                             if (pre_bounds is None
                                 and hasattr(global_aligner, "edit_batch"))
                             else None),
                eqx=eqx, force_gap=split_force_gap, window_cache=win_cache,
                precomputed_bounds=pre_bounds,
            )
        if not segs:
            return [], [], False
        with trace.span("rf.extend"):
            extend_edges(segs, read_codes, read_len, ref,
                         aligner=extension_aligner)

        o_len = len(segs)
        filtered = False
        if len(segs) > 2 and not nofilter:
            iloc = 0
            while iloc < len(segs) - 2:
                if not drop_misplaced(segs, iloc):
                    iloc += 1
        if len(segs) < o_len:
            filtered = True
            with trace.span("rf.extend"):
                extend_edges(segs, read_codes, read_len, ref,
                             aligner=extension_aligner)

        with trace.span("rf.fix"):
            merge_adjacent(segs, ref)
            fix_simple_inv(segs, read_codes, ref, full=simple_inv_full)

        # collect every inter-anchor gap of every segment and align them
        # as ONE batch (the device aligner buckets by length internally).
        # force_host_fill: the async-window continuation fills its small
        # residue (~12 jobs/read) on host — a synchronous device round
        # trip here would serialize every read's completion on the
        # service latency (measured: capped the whole deployment at ~6
        # reads/s/thread on the relay)
        gl_batch = (_host_global_batch if force_host_fill
                    else (global_aligner or _host_global_batch))
        seg_anchor_lists, seg_npairs = [], []
        all_pairs = []
        all_keys = []
        with trace.span("rf.jobs"):
            for seg in segs:
                kept, pairs = segment_cigar_jobs(
                    seg, read_codes, rc_read_codes, read_len, ref,
                    force_gap=split_force_gap,
                    skip_pairs_in=win_cache if win_cache else None,
                )
                seg_anchor_lists.append(kept)
                seg_npairs.append(len(pairs))
                all_pairs.extend(pairs)
                all_keys.extend(zip(kept, kept[1:]))
        # windows already aligned by the divergence bound pass are served
        # from the cache; only the residue (edge/merged/changed windows)
        # goes to the aligner
        if win_cache:
            fill_pairs, fill_idx, cached = [], [], {}
            for i, (tq, key) in enumerate(zip(all_pairs, all_keys)):
                c = win_cache.get(key)
                if c is None:
                    fill_idx.append(i)
                    fill_pairs.append(tq)
                else:  # tq may be None (pair extraction skipped)
                    cached[i] = AlignResult(c, False, 0, 0, 0, 0, 0)
        else:
            fill_pairs, fill_idx, cached = all_pairs, None, {}

        def _merge(results):
            if fill_idx is None:
                return results
            out = [None] * len(all_pairs)
            for i, r in cached.items():
                out[i] = r
            for i, r in zip(fill_idx, results):
                out[i] = r
            return out

        def _assemble(fill_results):
            all_results = _merge(fill_results)
            cigar_lists = []
            off = 0
            for n in seg_npairs:
                cigar_lists.append(
                    [r.cigar for r in all_results[off : off + n]])
                off += n
            with trace.span("rf.records"):
                records = records_from_segments(
                    seg_anchor_lists, cigar_lists, readid, mapq, read_len,
                    ref, need_reverse, use_hardclip,
                )
            return seg_anchor_lists, records, filtered

        if defer and hasattr(gl_batch, "submit"):
            trace.count("rf.fill_jobs", len(fill_pairs))
            handle = gl_batch.submit(fill_pairs, eqx)
            return PendingRefine(gl_batch, handle, _assemble)

        with trace.span("rf.fill"):
            trace.count("rf.fill_jobs", len(fill_pairs))
            all_results = gl_batch(fill_pairs, eqx)
        return _assemble(all_results)

    # async-window path (the round-4 device deployment): the divergence
    # window-bound batch — the pipeline's LARGEST fill block (round-3
    # mt shares: rf.diverg 23.5% vs rf.fill 8.0%) — ships to the device
    # aligner while the caller maps other reads; the divergence
    # decisions, made from the returned exact cigars, are identical to
    # the host path.  The residual fill batch inside the continuation
    # runs synchronously (one service batch period; the caller's other
    # in-flight reads keep the pipeline busy).
    # opt-in (wants_window_jobs): the HOST deferred aligner measured 19%
    # SLOWER through this stage (per-cigar NM parses vs the native
    # ops-plane reduceat in _window_fill_bounds) — only device service
    # aligners, whose win is moving the compute off-host, set the marker
    if (defer_fill and eqx and global_aligner is not None
            and getattr(global_aligner, "wants_window_jobs", False)
            and hasattr(global_aligner, "submit")
            # saturation peek: when the service's in-flight cap is
            # reached, this read takes the HOST window-bound path (the
            # native ops-plane pass) instead of submitting jobs that
            # would only bounce back at finish time
            and getattr(global_aligner, "accepting", lambda: True)()):
        with trace.span("rf.diverg"):
            seg_pairs, w_pairs, w_keys = _window_bound_jobs(
                segs0, list(range(len(segs0))), read_codes, rc_read_codes,
                read_len, ref, split_force_gap)
        if w_pairs:
            handle = global_aligner.submit(w_pairs, True)

            def _after_windows(results):
                with trace.span("rf.diverg"):
                    bounds = _bounds_from_cigars(
                        seg_pairs, w_keys, [r.cigar for r in results],
                        win_cache)
                return _body(bounds, False, force_host_fill=True)

            return PendingRefine(global_aligner, handle, _after_windows)

    return _body(None, defer_fill)


class HostBatchFillAligner:
    """Deferred HOST fill aligner: ``submit`` queues a read's fill jobs,
    the first ``wait`` flushes EVERYTHING queued as one native batch.

    The striped AVX2 kernel runs 16 jobs per group; per-read batches
    (~35 jobs) leave the tail group mostly dummy lanes and give the
    size/diagonal sort little to work with.  Cross-read batching over
    the caller's deferred window (cli worker / bench: 32 reads in
    flight) turns ~3 ragged groups per read into ~70 well-sorted groups
    per flush with one partial tail.  Per-pair results are independent
    of batch composition (band escalation is exact), so output is
    byte-identical to the per-read path."""

    __slots__ = ("_queued", "_results", "_next")

    def __init__(self):
        self._queued: List[tuple] = []  # (pairs, eqx, handle)
        self._results: dict = {}
        self._next = 0  # monotone handle counter (pops must never reuse)

    def submit(self, pairs, eqx: bool = False):
        handle = self._next
        self._next += 1
        self._queued.append((list(pairs), eqx, handle))
        return handle

    def wait(self, handle):
        if handle not in self._results:
            self._flush()
        return self._results.pop(handle)

    def _flush(self):
        by_eqx = {False: [], True: []}
        for pairs, eqx, h in self._queued:
            by_eqx[bool(eqx)].append((pairs, h))
        self._queued.clear()
        for eqx, entries in by_eqx.items():
            if not entries:
                continue
            flat = [p for pairs, _ in entries for p in pairs]
            res = _host_global_batch(flat, eqx)
            off = 0
            for pairs, h in entries:
                self._results[h] = res[off : off + len(pairs)]
                off += len(pairs)

    def __call__(self, pairs, eqx: bool = False):
        return _host_global_batch(pairs, eqx)

    align_batch = __call__


class PendingRefine:
    """A refine_chain whose device batch (window-bound pass or final
    fill) is in flight; ``finish()`` blocks on the results and runs the
    continuation (divergence decisions + rest of refine, or record
    assembly).

    Trace accounting: the aligner's ``wait`` spans its own blocking
    (``fill_wait`` in the in-process service), and the continuation runs
    under the top-level span ``refine_cont`` so its nested rf.* child
    spans have a parent in the stage-share denominator."""

    __slots__ = ("_aligner", "_handle", "_assemble")

    def __init__(self, aligner, handle, assemble):
        self._aligner = aligner
        self._handle = handle
        self._assemble = assemble

    def finish(self):
        from .. import trace

        all_results = self._aligner.wait(self._handle)
        with trace.span("refine_cont"):
            return self._assemble(all_results)
