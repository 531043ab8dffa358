"""Global edit distance (divergence filter).

Replaces the reference's edlib.align(task='distance') call
(mammap_clrnano.py:19251): the only consumer compares
editDistance / min(len) against a divergence threshold, so a banded
(Ukkonen) computation with an early cap is exact for the decision.
"""

from __future__ import annotations

import numpy as np


def edit_distance(a: np.ndarray, b: np.ndarray, cap: int | None = None) -> int:
    """Levenshtein distance between code arrays a and b, banded.

    If cap is given and the true distance exceeds it, returns cap + 1.
    Vectorized row DP over a band of radius r = cap (or full width).
    """
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    if cap is None:
        cap = n + m
    if abs(n - m) > cap:
        return cap + 1
    r = cap
    # rows over a; band offset d = j - i in [dlo, dhi]
    dlo, dhi = -min(r, n), min(r, m)
    W = dhi - dlo + 1
    BIG = np.int32(1 << 28)
    lanes = np.arange(W, dtype=np.int64)
    prev = np.where(
        (lanes + dlo >= 0) & (lanes + dlo <= m), np.abs(lanes + dlo), BIG
    ).astype(np.int32)
    for i in range(1, n + 1):
        j_here = lanes + i + dlo
        inb = (j_here >= 1) & (j_here <= m)
        subcost = np.where(
            b[np.clip(j_here - 1, 0, m - 1)] == a[i - 1], 0, 1
        ).astype(np.int32)
        diag = prev + subcost
        up = np.concatenate([prev[1:], [BIG]]) + 1  # deletion from a
        cur = np.minimum(diag, up)
        cur = np.where(inb | (j_here == 0), cur, BIG)
        cur = np.where(j_here == 0, i, cur)
        # insertion: running min within the row; unit gap cost makes it a
        # discounted running min: cost(p) = min_{p'<=p} cur[p'] + (p - p')
        cur = np.minimum(cur, np.minimum.accumulate(cur - lanes) + lanes)
        cur = np.where(inb | (j_here == 0), cur, BIG)
        if cur.min() > cap:
            return cap + 1
        prev = cur
    p_end = m - n - dlo
    if p_end < 0 or p_end >= W:
        return cap + 1
    d = int(prev[p_end])
    return d if d <= cap else cap + 1


def divergence_exceeds(a: np.ndarray, b: np.ndarray, max_ratio: float) -> bool:
    """True when editDistance(a, b)/min(len) > max_ratio (the drop rule at
    mammap_clrnano.py:19251-19253).  Uses the native Myers bit-vector
    kernel when available; numpy banded DP otherwise."""
    mn = min(len(a), len(b))
    if mn == 0:
        return True
    cap = int(max_ratio * mn)
    from .. import native

    have_native = native.available()

    def dist(c: int) -> int:
        if have_native:
            d = native.edit_distance_native(a, b, cap=c)
            if d is not None:
                return d
        return edit_distance(a, b, cap=c)

    # adaptive cap ladder: a banded pass with cap' < cap whose result is
    # <= cap' is value-exact, so the decision is already settled.  A
    # cheap probe settles low-divergence (HiFi-like) pairs ~3x
    # faster; ONT-like pairs escalate to the half-cap band and only
    # junk pairs pay the full-cap pass (measured in ops/edit micro-A/B:
    # HiFi 3.1->1.1 ms, ONT 5.9->6.4 ms, junk +0.5 ms at 18 kb).
    # The first rung scales with the span (6.25% of mn): a fixed 256
    # probe just misses typical ~5%-divergent long spans (d~300 at 6 kb),
    # paying probe + half-cap; mn/16 settles them in one pass.
    prev = 0
    for c in (max(256, mn // 16), cap // 2):
        if prev < c < cap:
            d = dist(c)
            if d <= c:
                return d > cap
            prev = c
    d = dist(cap)
    return d > cap
