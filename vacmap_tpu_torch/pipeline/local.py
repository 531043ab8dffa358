"""Local re-chain: merge/filter guide chains, harvest k=9 anchors around
them, and re-chain at fine scale.

Equivalent of ``get_localmap_multi_all_forDP_inv_guide_list``
(mammap_clrnano.py:28479-28589).  Guide chains (paths from the global DP)
are anchor arrays in DESCENDING read-position order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import trace
from ..ops.chain_ref import chain_local
from ..ops.harvest import harvest_anchors as _harvest_anchors


def harvest_anchors(*a, **kw):
    with trace.span("lr.harvest"):
        return _harvest_anchors(*a, **kw)


def merge_guide_chains(paths: List[np.ndarray]) -> List[np.ndarray]:
    """Concatenate colinear guide chains (merge_chain,
    mammap_clrnano.py:28529-28569): secondary chains whose junction gap is
    consistent (|readgap - refgap| < 500, same strand) are fused.  The
    primary chain stays first; the rest are ordered by ascending length."""
    if len(paths) <= 1:
        return list(paths)
    chains = [np.asarray(p) for p in paths[1:]]
    chains.sort(key=lambda c: int(c[-1][0]))  # by start readpos
    iloc = 0
    while iloc < len(chains) - 1:
        jloc = iloc + 1
        while jloc < len(chains):
            a, b = chains[iloc], chains[jloc]
            # a's largest readpos end <= b's smallest readpos start
            if a[0][0] + a[0][3] <= b[-1][0] and a[0][2] == b[-1][2]:
                readgap = b[-1][0] - a[0][0] - a[0][3]
                if a[0][2] == 1:
                    refgap = b[-1][1] - a[0][1] - a[0][3]
                else:
                    refgap = a[0][1] - b[-1][1] - b[-1][3]
                if abs(readgap - refgap) < 500:
                    chains[iloc] = np.concatenate((b, a))
                    chains.pop(jloc)
                    continue
            jloc += 1
        iloc += 1
    chains.sort(key=len)
    return [np.asarray(paths[0])] + chains


def drop_some_chains(paths: List[np.ndarray]) -> List[np.ndarray]:
    """Drop near-duplicate or tiny secondary chains (drop_somechains,
    mammap_clrnano.py:28482-28528): a secondary is dropped when its span
    is < 100 bp, or when it lies within 500 bp (ref) of the primary chain
    and its strand composition matches the primary's in its read span."""
    if len(paths) <= 1:
        return list(paths)
    primary = paths[0]
    n_sec = len(paths) - 1
    iloclist = np.zeros(n_sec, np.int64)
    distance = np.full(n_sec, np.iinfo(np.int64).max)
    strandcount = np.zeros((n_sec, 2))
    chains_strandcount = np.zeros((n_sec, 2))
    for item in primary:
        for ci in range(n_sec):
            chain = paths[ci + 1]
            if chain[-1][0] <= item[0] <= chain[0][0]:
                strandcount[ci][0 if item[2] == 1 else 1] += 1
            while chain[iloclist[ci]][0] > item[0]:
                if iloclist[ci] < len(chain) - 1:
                    iloclist[ci] += 1
                else:
                    break
            testitem = chain[iloclist[ci]]
            d = abs(int(item[1]) - int(testitem[1]))
            if d < distance[ci]:
                distance[ci] = d
    for ci in range(n_sec):
        chain = paths[ci + 1]
        for item in chain:
            chains_strandcount[ci][0 if item[2] == 1 else 1] += 1
    out = [primary]
    for ci in range(n_sec):
        if strandcount[ci][0] > strandcount[ci][1] and chains_strandcount[ci][0] > chains_strandcount[ci][1]:
            keep = True
        elif strandcount[ci][0] < strandcount[ci][1] and chains_strandcount[ci][0] < chains_strandcount[ci][1]:
            keep = True
        else:
            keep = False
        chain = paths[ci + 1]
        span = int(chain[0][0]) - int(chain[-1][0])
        if (not keep and distance[ci] < 500) or span < 100:
            continue
        out.append(chain)
    return out


def local_rechain(
    paths: List[np.ndarray],
    read_codes: np.ndarray,
    rc_read_codes: np.ndarray,
    ref_codes: np.ndarray,
    contig_starts: np.ndarray,
    contig_lens: np.ndarray,
    kmersize: int = 9,
    skipcost: float = 40.0,
    maxdiff: int = 30,
    maxgap: int = 99,
    guide_cap: int = 5,
    chain_backend=None,
    scar: bool = False,
    asm_single: bool = False,
    as_array: bool = False,
) -> Tuple[float, list]:
    """Merge/filter guides, harvest, and run the fine-scale DP.

    Returns (score, path) with path in descending read-pos order.
    guide_cap = total chains harvested (0 = unlimited, S mode).

    ``scar=True`` is the R-mode local routine
    (mammap_noprefercloser.py live guide_list): no guide merging,
    dropping or cap; per-guide harvest with +-2 kb / +-500 margins;
    anchors sorted by readpos only; the scar DP (flat-penalty + refund
    ledger) with no fast fallback.

    ``asm_single=True`` is the asm local routine
    (mammap_asm.py live get_localmap_multi_all_forDP_inv_guide, called
    from its get_readmap_DP_test with the PRIMARY path only): one guide,
    +-2 kb / +-500 margins, anchors sorted by readpos only, the plain
    fine DP — no guide merging, dropping, cap, or mismatch variant.
    """
    if asm_single:
        A = harvest_anchors(
            np.asarray(paths[0], np.int64), read_codes, rc_read_codes,
            ref_codes, contig_starts, contig_lens, kmersize=kmersize,
            ref_margin=2000, read_margin=500,
        )
        if len(A) == 0:
            return 0.0, (np.empty((0, 4), np.int64) if as_array else [])
        A = A[np.argsort(A[:, 0])]
        return chain_local(
            A, kmersize=kmersize, skipcost=skipcost, maxdiff=maxdiff,
            maxgap=maxgap, chain_backend=None, variant="asm_fine",
            as_array=as_array,
        )
    if scar:
        parts = [
            harvest_anchors(
                np.asarray(g, np.int64), read_codes, rc_read_codes,
                ref_codes, contig_starts, contig_lens, kmersize=kmersize,
                ref_margin=2000, read_margin=500,
            )
            for g in paths
        ]
        A = np.concatenate(parts, axis=0) if parts else np.zeros((0, 4), np.int64)
        if len(A) == 0:
            return 0.0, (np.empty((0, 4), np.int64) if as_array else [])
        A = A[np.argsort(A[:, 0])]  # reference sorts by readpos only
        return chain_local(
            A, kmersize=kmersize, skipcost=skipcost, maxdiff=maxdiff,
            maxgap=maxgap, chain_backend=None, variant="scar",
            as_array=as_array,
        )
    paths = merge_guide_chains(paths)
    paths = drop_some_chains(paths)
    paths.sort(key=len, reverse=True)  # getcounts = 1/len (stable)
    multi = len(paths) > 1

    parts: List[np.ndarray] = []
    for i, guide in enumerate(paths):
        if guide_cap and i >= guide_cap:
            break
        parts.append(
            harvest_anchors(
                np.asarray(guide, np.int64),
                read_codes,
                rc_read_codes,
                ref_codes,
                contig_starts,
                contig_lens,
                kmersize=kmersize,
            )
        )
    A = np.concatenate(parts, axis=0) if parts else np.zeros((0, 4), np.int64)
    if len(A) == 0:
        return 0.0, (np.empty((0, 4), np.int64) if as_array else [])
    A = A[np.argsort(A[:, 0] + A[:, 3], kind="stable")]
    return chain_local(
        A,
        kmersize=kmersize,
        skipcost=skipcost,
        maxdiff=maxdiff,
        maxgap=maxgap,
        mismatch=multi,
        chain_backend=chain_backend,
        as_array=as_array,
    )
