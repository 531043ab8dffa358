"""Minimizer sketching (host side).

Replaces the reference's ``vacmap_index`` C extension (a minimap2
derivative, SURVEY.md section 2.6): minimizer extraction with an
invertible hash and canonical strand, window minimum selection, and
occurrence-indexed lookup.

This is a fresh vectorized implementation — minimizers are computed with
numpy array ops over the 2-bit encoded sequence instead of per-position
rolling loops, so a whole contig is sketched in a handful of passes.
"""

from __future__ import annotations

import numpy as np

from ..seq import encode, hash64, kmer_codes, rc_kmer


def window_min_positions(values: np.ndarray, w: int) -> np.ndarray:
    """Positions that are the minimum of at least one length-w window.

    All tied minimal positions within a window are kept (minimap2-style),
    which makes the selection strand-symmetric.  Position p is selected
    iff values[p] equals the min of some window containing p, i.e. the
    max over covering-window minima equals values[p].
    """
    n = len(values)
    if n < w:
        return np.empty(0, dtype=np.int64)
    sw = np.lib.stride_tricks.sliding_window_view(values, w)
    winmin = sw.min(axis=1)  # length n-w+1
    # sliding max of winmin over windows covering each position
    pad = np.full(w - 1, np.iinfo(values.dtype).min, dtype=winmin.dtype)
    padded = np.concatenate([pad, winmin, pad])
    cover = np.lib.stride_tricks.sliding_window_view(padded, w).max(axis=1)
    # cover[p] = max(winmin[p-w+1 .. p]) with out-of-range clipped
    return np.flatnonzero(cover[:n] == values)


def minimizers(
    seq_codes: np.ndarray, k: int, w: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compute minimizers of an encoded sequence (native C++ rolling
    sketch when available; vectorized numpy otherwise — identical
    selection).

    Returns (hashes, positions, strands):
      * hashes: int64 invertible-hashed canonical k-mer values
      * positions: int64 start position of the k-mer in the sequence
      * strands: int8 +1 if the forward k-mer is canonical, -1 otherwise

    K-mers containing ambiguous bases are excluded; windows whose forward
    and reverse-complement hashes tie (palindromes) are excluded from
    strand-specific matching, as in minimap2-style sketches.
    """
    from .. import native

    if k < 32 and native.available():
        if len(seq_codes) >= (1 << 20):  # long inputs: segment-parallel
            res = native.minimizer_sketch_mt_native(seq_codes, k, w)
        else:
            res = native.minimizer_sketch_native(seq_codes, k, w)
        if res is not None:
            return res
    kmers, valid = kmer_codes(seq_codes, k)
    if len(kmers) == 0:
        return (np.empty(0, np.int64),) * 2 + (np.empty(0, np.int8),)
    mask = (1 << (2 * k)) - 1
    fwd = hash64(kmers, mask)
    rev = hash64(rc_kmer(kmers, k), mask)
    strand = np.where(fwd <= rev, np.int8(1), np.int8(-1))
    canon = np.minimum(fwd, rev)
    # palindromic (fwd==rev) or ambiguous windows get +inf so they are
    # never selected as minimizers
    big = np.int64(np.iinfo(np.int64).max)
    keyed = np.where(valid & (fwd != rev), canon, big)
    if len(keyed) < w:
        m = keyed.min()
        sel = np.flatnonzero(keyed == m) if m != big else np.empty(0, np.int64)
    else:
        sel = window_min_positions(keyed, w)
    if len(sel) == 0:
        return (np.empty(0, np.int64),) * 2 + (np.empty(0, np.int8),)
    sel = sel[keyed[sel] != big]
    return canon[sel], sel.astype(np.int64), strand[sel]


def sketch_string(seq: str, k: int, w: int):
    return minimizers(encode(seq), k, w)
