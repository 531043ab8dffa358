"""Sequence utilities: 2-bit encoding, reverse complement, k-mer packing.

The reference keeps sequences as Python strings and hashes string slices
(``mammap_clrnano.py:23073-23138``).  For a TPU-native design we encode
bases as small integers once and derive k-mer codes with vectorized
shifts, which is both faster on host and directly usable by device
kernels.
"""

from __future__ import annotations

import numpy as np

# Base encoding: A=0 C=1 G=2 T=3, anything else = 4 (ambiguous).
_ENCODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate("ACGT"):
    _ENCODE[ord(_b)] = _i
    _ENCODE[ord(_b.lower())] = _i

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
_COMP_TABLE = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def encode(seq: str | bytes) -> np.ndarray:
    """Encode a DNA string into uint8 codes (A0 C1 G2 T3, other 4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENCODE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    return lut[codes].tobytes().decode("ascii")


def revcomp(seq: str) -> str:
    """Reverse complement of a DNA string (case-preserving complement)."""
    return seq.translate(_COMP_TABLE)[::-1]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of encoded bases; ambiguous (4) stays 4."""
    out = codes[::-1].copy()
    valid = out < 4
    out[valid] = 3 - out[valid]
    return out


def kmer_codes(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack every k-mer of `codes` into an integer.

    Returns (kmers, valid) where kmers[i] encodes codes[i:i+k] in 2 bits
    per base (first base most significant) and valid[i] is False when the
    window contains an ambiguous base.  Works for k <= 31.
    """
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, np.int64), np.empty(0, bool)
    c = codes.astype(np.int64)
    bad = (codes >= 4).astype(np.int64)
    # rolling pack via cumulative trick: kmers[i] = sum c[i+j] << 2*(k-1-j)
    kmers = np.zeros(n, dtype=np.int64)
    nbad = np.zeros(n, dtype=np.int64)
    for j in range(k):
        kmers = (kmers << 2) | (c[j : j + n] & 3)
        nbad += bad[j : j + n]
    return kmers, nbad == 0


def rc_kmer(kmers: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement of packed k-mer codes."""
    out = np.zeros_like(kmers)
    x = kmers.copy()
    for _ in range(k):
        out = (out << 2) | (3 - (x & 3))
        x >>= 2
    return out


def hash64(x: np.ndarray, mask: int) -> np.ndarray:
    """Invertible integer hash (Thomas Wang style, as used by minimizer
    sketches) so that minimizer selection is not biased toward poly-A.

    Operates on int64 interpreted as unsigned, masked to 2k bits.
    """
    x = x.astype(np.uint64)
    m = np.uint64(mask)
    x = (~x + (x << np.uint64(21))) & m
    x = x ^ (x >> np.uint64(24))
    x = (x + (x << np.uint64(3)) + (x << np.uint64(8))) & m
    x = x ^ (x >> np.uint64(14))
    x = (x + (x << np.uint64(2)) + (x << np.uint64(4))) & m
    x = x ^ (x >> np.uint64(28))
    x = (x + (x << np.uint64(31))) & m
    return x.astype(np.int64)
