"""Assembly (asm) mode: out-of-core streaming chaining for contigs of
unbounded length.

Equivalent of the reference's streaming path
(``assembly_get_readmap_DP_test``, mammap_asm.py:23204-23460): anchors
are produced in 100 kb read-position batches; the chaining DP resumes
from a carried *frontier* — the top-scoring anchors of the previous
batch, rebased (+1000) with negative predecessor codes pointing into the
spilled per-batch arrays; the best chain is backtracked newest -> oldest
across the spill files.

The host implementation here (native warm-start chain kernel per block)
defines the exact semantics; ``chain_backend`` (the device warm-start DP,
``ops.chain.TorchStreamChainBackend``) takes a block instead when it
answers, and a block it declines (it returns None) goes to the native
DP.  A device error inside the backend is raised, never declined.

Contigs < 500 kb take the normal per-read path with check_num disabled
(mammap_asm.py:23205-23206).
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional, Tuple

import numpy as np

from .. import native
from ..ops.harvest import harvest_anchors
from ..seq import decode
from .extend import (
    RefView,
    extend_edges,
    fix_simple_inv,
    merge_adjacent,
    rebuild_chain_break,
    records_from_segments,
    segment_cigar_jobs,
    _host_global_batch,
)

BATCH = 100_000
STREAM_THRESHOLD = 500_000
NO_PRED = -1


class _Spill:
    """Per-batch (anchors, P) store; disk-backed when workdir given."""

    def __init__(self, workdir: Optional[str]):
        self.workdir = workdir
        self.mem: List = []
        if workdir:
            os.makedirs(workdir, exist_ok=True)

    def put(self, anchors: np.ndarray, P: np.ndarray):
        if self.workdir:
            np.savez_compressed(
                os.path.join(self.workdir, str(len(self.mem))), a=anchors, P=P
            )
            self.mem.append(None)
        else:
            self.mem.append((anchors, P))

    def get(self, i: int):
        if self.workdir:
            z = np.load(os.path.join(self.workdir, f"{i}.npz"))
            return z["a"], z["P"]
        return self.mem[i]

    def __len__(self):
        return len(self.mem)

    def cleanup(self):
        if self.workdir and os.path.isdir(self.workdir):
            shutil.rmtree(self.workdir, ignore_errors=True)


def stream_chain(
    batches,
    kmersize: int,
    skipcost: float,
    maxdiff: int,
    maxgap: int,
    variant: str,
    workdir: Optional[str] = None,
    chain_backend=None,
) -> List[tuple]:
    """Frontier-carry streaming chain over an iterator of barrier-sorted
    anchor batches.  Returns the best path in DESCENDING read order.

    Frontier predecessor encoding: P >= 0 in-batch link; P == -1 chain
    start; P <= -2 cross-batch link to index -(P+2) of the previous
    spilled batch.
    """
    spill = _Spill(workdir)
    frontier_a = np.zeros((0, 4), np.int64)
    frontier_S = np.zeros(0, np.float64)
    frontier_P = np.zeros(0, np.int64)
    last_g = -1
    try:
        for one in batches:
            if len(one) == 0:
                continue
            linked = (
                np.concatenate([frontier_a, one]) if len(frontier_a) else one
            )
            S = P = None
            if chain_backend is not None:
                dev = chain_backend(
                    linked, variant, kmersize, skipcost, maxdiff, maxgap,
                    frontier_S, frontier_P,
                )
                if dev is not None:
                    S, P = dev
            if S is None:
                res = native.chain_dp_native_warm(
                    linked, kmersize, skipcost, maxdiff, maxgap, variant,
                    frontier_S, frontier_P,
                )
                if res is None:
                    raise RuntimeError(
                        "asm streaming requires the native library"
                    )
                S, P, aborted = res
                if aborted:
                    # density bailout -> linked fast DP, exactly like the
                    # reference routine (mammap_asm.py:23246-23248)
                    fres = native.chain_dp_fast_native_warm(
                        linked, kmersize, skipcost, maxdiff, maxgap,
                        variant, frontier_S, frontier_P,
                    )
                    if fres is None:
                        raise RuntimeError(
                            "asm streaming requires the native library"
                        )
                    S, P = fres
            g = int(np.argmax(S))
            if P[g] < 0:
                # batch-skip guard (mammap_asm.py:23250): when the best
                # chain's head has no in-batch predecessor (it is a carried
                # frontier anchor or an isolated start), the batch adds
                # nothing — keep the previous frontier and spill nothing.
                # Divergence note: the reference still overwrites its
                # backtrack start index here, which mis-indexes the spill
                # if the LAST batch is skipped; we keep last_g pointing
                # into the newest SPILLED batch instead.
                continue
            last_g = g
            # frontier: anchors scoring within (skipcost + 36 + 20) of max
            # (mammap_asm.py:23256-23272)
            gmax = float(S[g])
            lowest = gmax - skipcost - 36 - 20
            order = np.argsort(S, kind="stable")
            k = int(np.searchsorted(S[order], lowest, side="right"))
            # the reference slices from the FIRST not-above-threshold entry
            # (its while loop stops there and the slice includes it,
            # mammap_asm.py:23341-23351)
            keep = order[max(k - 1, 0) :]
            if len(keep) == 0:
                keep = order[-1:]
            cut = float(S[keep[0]])
            batch_idx = len(spill)
            # cross-batch pointer: index into THIS batch's spilled arrays
            frontier_a = linked[keep]
            frontier_S = S[keep] - cut + 1000.0
            frontier_P = -(keep.astype(np.int64)) - 2
            spill.put(linked, P)

        if len(spill) == 0 or last_g < 0:
            return []
        # backtrack newest -> oldest; in the NEWEST batch start at last_g
        path: List[tuple] = []
        g_idx = last_g
        for bi in range(len(spill) - 1, -1, -1):
            a, P = spill.get(bi)
            take = g_idx
            path.append(tuple(int(x) for x in a[take]))
            while P[take] >= 0:
                take = int(P[take])
                path.append(tuple(int(x) for x in a[take]))
            if P[take] == NO_PRED:
                break
            g_idx = int(-(P[take] + 2))
        return path
    finally:
        spill.cleanup()


def _trim_overlaps(path_desc: List[tuple]) -> List[tuple]:
    """Trim anchors overlapping their successor (mammap_asm.py:23404-23416);
    path is in descending read order."""
    out = list(path_desc)
    for k in range(1, len(out)):
        pre = out[k - 1]
        now = out[k]
        if pre[0] >= now[0] + now[3]:
            continue
        newlen = pre[0] - now[0]
        if now[2] == 1:
            out[k] = (now[0], now[1], now[2], newlen)
        else:
            out[k] = (now[0], now[1] + now[3] - newlen, now[2], newlen)
    return out


def refine_chain_asm(
    path_asc: List[tuple],
    readid: str,
    read_codes,
    rc_read_codes,
    read_len: int,
    ref: RefView,
    eqx: bool,
    global_aligner=None,
    extension_aligner=None,
):
    """ass_extend_func (mammap_asm.py:23423-23460): like refine_chain but
    without the divergence filter and misplaced-segment drop; mapq 60,
    small_alignment 30, rebuild large_cost 50."""
    segs = rebuild_chain_break(path_asc, ref, large_cost=50, small_alignment=30,
                               allow_dup_overlap=False)
    if not segs:
        return []
    extend_edges(segs, read_codes, read_len, ref, aligner=extension_aligner)
    merge_adjacent(segs, ref)
    fix_simple_inv(segs, read_codes, ref, full=False)
    gl_batch = global_aligner or _host_global_batch
    seg_anchor_lists, seg_npairs, all_pairs = [], [], []
    for seg in segs:
        kept, pairs = segment_cigar_jobs(
            seg, read_codes, rc_read_codes, read_len, ref, force_gap=2000
        )
        seg_anchor_lists.append(kept)
        seg_npairs.append(len(pairs))
        all_pairs.extend(pairs)
    all_results = gl_batch(all_pairs, eqx)
    cigar_lists = []
    off = 0
    for n in seg_npairs:
        cigar_lists.append([r.cigar for r in all_results[off : off + n]])
        off += n
    return records_from_segments(
        seg_anchor_lists, cigar_lists, readid, 60, read_len, ref,
        need_reverse=False, use_hardclip=False,
    )


def map_contig_streaming(
    mapper,
    name: str,
    seq: str,
    workdir: Optional[str] = None,
) -> List[list]:
    """Full streaming asm pipeline for one large contig."""
    try:
        return _map_contig_streaming(mapper, name, seq, workdir)
    finally:
        if workdir:
            shutil.rmtree(workdir, ignore_errors=True)


def _map_contig_streaming(
    mapper,
    name: str,
    seq: str,
    workdir: Optional[str] = None,
) -> List[list]:
    from ..seq import encode, revcomp_codes

    cfg = mapper.config
    idx = mapper.index
    seq = seq.upper()
    read_len = len(seq)
    codes = encode(seq)
    rc_codes = revcomp_codes(codes)

    # ---- round 1: global chain over streamed minimizer anchors --------
    def round1_batches():
        for st in range(0, read_len, BATCH):
            sl = seq[st : st + BATCH]
            a = idx.seeds(sl, check_num=0)
            if len(a) == 0:
                continue
            a = a.copy()
            a[:, 0] += st
            yield a[np.argsort(a[:, 0], kind="stable")]

    skip_g, maxdiff_g, _ = cfg.chain_params_global()
    wd1 = os.path.join(workdir, "r1") if workdir else None
    stream_be = getattr(mapper, "stream_backend", None)
    path = stream_chain(
        round1_batches(), idx.k, skip_g, maxdiff_g, 1000, "global_nocov",
        wd1, chain_backend=stream_be,
    )
    if len(path) <= 1:
        return []

    # ---- round 2: local k=9 re-chain over harvested anchors -----------
    guide = np.asarray(path[::-1], np.int64)  # ascending

    def round2_batches():
        # asm batching (yield_second_mapinfo, mammap_asm.py live def):
        # batches close at guide-anchor readpos boundaries once the batch
        # spans BATCH bp AND >300 guide anchors; the harvest sees a +-20
        # guide-anchor slice, scans read positions [st, en - k), builds
        # ref windows with +-2 kb margins, and sorts by readpos only
        def emit(r_st, r_en, g):
            if len(g) < 1:
                return None
            A = harvest_anchors(
                g, codes, rc_codes, idx.seq_codes,
                idx.contig_starts, idx.contig_lens,
                kmersize=cfg.local_kmersize,
                ref_margin=2000, read_start=r_st, read_end=r_en,
            )
            if len(A) == 0:
                return None
            A = np.asarray(A, np.int64)
            return A[np.argsort(A[:, 0])]

        m = len(guide)
        st_read, st_path = 0, 0
        iloc = 0
        for iloc in range(1, m):
            if iloc == m - 1 or guide[iloc + 1][0] > guide[iloc][0]:
                if (
                    guide[iloc][0] + guide[iloc][3] > st_read + BATCH
                    and iloc - st_path > 300
                ):
                    g = guide[max(0, st_path - 20) : min(iloc + 20, m)]
                    A = emit(st_read, int(guide[iloc][0]), g)
                    if A is not None:
                        yield A
                    st_path = iloc + 1
                    st_read = int(guide[iloc][0])
        if st_read < read_len:
            g = guide[max(0, st_path - 20) : min(iloc + 20, m)]
            A = emit(st_read, read_len, g)
            if A is not None:
                yield A

    skip_l, maxdiff_l, maxgap_l = cfg.chain_params_local()
    wd2 = os.path.join(workdir, "r2") if workdir else None
    path2 = stream_chain(
        round2_batches(), cfg.local_kmersize, skip_l, maxdiff_l, maxgap_l,
        "asm_fine", wd2, chain_backend=stream_be,
    )
    if len(path2) <= 1:
        return []
    path2 = _trim_overlaps(path2)
    path2 = [a for a in path2 if a[3] > 0]
    if len(path2) <= 1:
        return []

    return refine_chain_asm(
        path2[::-1], name, codes, rc_codes, read_len, mapper.ref,
        eqx=True,
        global_aligner=mapper.global_aligner,
        extension_aligner=mapper.extension_aligner,
    )
