"""Per-read SV signature calling + truth scoring (counterpart of
``vacmap_tpu/sim/svcalls.py``).

Turns alignment records into naive SV calls (big CIGAR indels + split-read
breakpoint signatures) and scores them against a vacsim truth set.  This
is the measurement half of the reference's validation recipe (vacsim +
external benchmarkers, SURVEY.md section 4): vacmap itself only emits
alignments, so recall/precision here quantify whether the alignments
carry recoverable SV evidence — the quantity the reference optimizes.

``benchcorpus`` makes the reads and truth set this scores against.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple


def _read_len_of(rec) -> int:
    """Full read length from one record's CIGAR (clips + query ops)."""
    return sum(
        int(ln)
        for ln, op in re.findall(r"(\d+)([MIDNSHP=X])", rec[8])
        if op in "SHMI=X"
    )


def call_signatures(records, min_size: int = 60) -> List[Tuple]:
    """Alignment records for ONE read -> [(kind, contig, pos, size, readid)].

    records: (readid, contig, strand, q_st, q_en, r_st, r_en, mapq, cigar)
    rows as produced by Mapper.map_read_records.  q coords follow SAM
    convention (measured on the stored SEQ, i.e. the reverse complement
    of the read for '-' records), so split-read gap geometry is computed
    in ORIGINAL-read order with strand-correct reference junctions: on a
    '-' segment the reference DEcreases as the read advances, so its
    junction-side boundary toward a later segment is r_st, not r_en.

    The trailing readid lets cluster_calls count DISTINCT supporting
    reads: a read spanning a whole inversion sees both junctions and
    would otherwise satisfy min_support=2 alone.  Duplicate
    (kind, contig, pos, size) rows within one read are emitted once.
    """
    calls = []
    for r in records:
        pos = r[5]
        for ln, op in re.findall(r"(\d+)([MIDNSHP=X])", r[8]):
            ln = int(ln)
            if op == "D" and ln >= min_size:
                calls.append(("DEL", r[1], pos, ln))
            if op == "I" and ln >= min_size:
                calls.append(("INS", r[1], pos, ln))
            if op in "M=XD":
                pos += ln

    def _finish(raw):
        readid = records[0][0] if records else None
        seen = set()
        out = []
        for c in raw:
            if c not in seen:
                seen.add(c)
                out.append(c + (readid,))
        return out

    if len(records) < 2:
        return _finish(calls)
    L = _read_len_of(records[0])
    # original-read interval of each record: '+' is [q_st, q_en); '-' is
    # [L - q_en, L - q_st)
    recs = sorted(
        records, key=lambda r: r[3] if r[2] == "+" else L - r[4]
    )
    for a, b in zip(recs, recs[1:]):
        # junction-side reference boundary of each segment
        a_bound = a[6] if a[2] == "+" else a[5]
        b_bound = b[5] if b[2] == "+" else b[6]
        if a[1] != b[1]:
            calls.append(("TRA", a[1], a_bound, 0))
            continue
        if a[2] != b[2]:
            # inversion: clusters form at both breakpoints
            calls.append(("INV", a[1], a_bound, abs(b_bound - a_bound)))
            calls.append(("INV", a[1], b_bound, abs(b_bound - a_bound)))
            continue
        if a[2] == "+":
            qgap = b[3] - a[4]
            rgap = b[5] - a[6]
        else:  # both '-': read advances down the reference
            qgap = a[3] - b[4]
            rgap = a[5] - b[6]
        junction = min(a_bound, b_bound)
        if rgap - qgap >= min_size:
            calls.append(("DEL", a[1], junction, rgap - qgap))
        elif rgap < -min_size and qgap > -min_size:
            # re-visited reference interval = duplication signature
            # (checked before INS: a tandem revisit also shows excess
            # query, but the ref overlap identifies it as DUP)
            calls.append(("DUP", a[1], junction, -rgap))
        elif qgap - rgap >= min_size:
            calls.append(("INS", a[1], junction, qgap - rgap))
    return _finish(calls)


def cluster_calls(calls: Sequence[Tuple], window: int = 300,
                  min_support: int = 2) -> List[Tuple]:
    """Group per-read calls into candidate events: same kind/contig,
    positions within ``window``; keep clusters supported by >=
    min_support DISTINCT reads (calls carry readid as their 5th field;
    legacy 4-tuples each count as their own read).
    Returns [(kind, contig, median_pos, support)]."""
    import numpy as np

    by_key: Dict[Tuple, List[Tuple[int, object]]] = {}
    for j, c in enumerate(calls):
        kind, contig, pos = c[0], c[1], c[2]
        readid = c[4] if len(c) > 4 else ("__call%d" % j)
        by_key.setdefault((kind, contig), []).append((int(pos), readid))
    events = []
    for (kind, contig), prs in by_key.items():
        prs.sort(key=lambda t: t[0])
        start = 0
        for i in range(1, len(prs) + 1):
            if i == len(prs) or prs[i][0] - prs[i - 1][0] > window:
                grp = prs[start:i]
                support = len({rid for _, rid in grp})
                if support >= min_support:
                    events.append(
                        (kind, contig,
                         int(np.median([p for p, _ in grp])), support)
                    )
                start = i
    return events


# vacsim event kinds whose alignment signature differs from the VCF kind
_TRUTH_ALIASES = {
    "DUP": ("DUP", "INS"),  # a duplication reads as INS at the insert site
    "TRA": ("TRA",),
    "DEL": ("DEL",),
    "INS": ("INS",),
    "INV": ("INV",),
}


def _near_truth(event, ev, tol):
    """event (kind, contig, pos, support) matches truth row (kind, contig,
    st, en, ...) if the kinds alias and the position is within ``tol`` of
    EITHER breakpoint (INV/DUP clusters form at both ends).

    vacsim INS truth rows are (INS, contig, st, LENGTH) — ev[3] is a
    size, not a second breakpoint, so it is never used as a coordinate
    (an INS has a single breakpoint anyway).

    vacsim TRA truth rows are (TRA, c1, st1, en1, c2, st2, en2, rev):
    a BALANCED swap of the two segments — reads produce correct TRA
    junction calls at both loci, so either side's breakpoints match."""
    if event[0] not in _TRUTH_ALIASES.get(ev[0], (ev[0],)):
        return False
    if ev[0] == "TRA" and len(ev) >= 7:
        for contig, a, b in ((ev[1], ev[2], ev[3]), (ev[4], ev[5], ev[6])):
            if event[1] == contig and (
                abs(event[2] - int(a)) <= tol
                or abs(event[2] - int(b)) <= tol
            ):
                return True
        return False
    if event[1] != ev[1]:
        return False
    pts = [int(ev[2])]
    if len(ev) > 3 and ev[0] != "INS":
        try:
            pts.append(int(ev[3]))
        except (TypeError, ValueError):
            pass
    return any(abs(event[2] - p) <= tol for p in pts)


def score_events(truth, events, tol: int = 500):
    """(recall, precision, n_truth, n_events): a truth entry (kind,
    contig, st, en, ...) is found if some event of an alias kind lies
    within ``tol`` of either breakpoint; an event is true if it matches
    some truth entry the same way."""
    found = sum(
        1 for ev in truth if any(_near_truth(e, ev, tol) for e in events)
    )
    true_events = sum(
        1 for e in events if any(_near_truth(e, ev, tol) for ev in truth)
    )
    recall = found / len(truth) if truth else 1.0
    precision = true_events / len(events) if events else 1.0
    return recall, precision, len(truth), len(events)


def score_events_per_class(truth, events, tol: int = 500):
    """Per-kind {recall, precision, n_truth, n_called}: recall over the
    truth rows of that kind; precision over the CALLED events of that
    kind, where an event is true if it matches any truth row of any
    kind (same aliasing as score_events — a DUP truth satisfied by an
    INS call counts for DUP recall AND for INS precision)."""
    out = {}
    kinds = sorted({r[0] for r in truth} | {e[0] for e in events})
    for kind in kinds:
        t_k = [r for r in truth if r[0] == kind]
        e_k = [e for e in events if e[0] == kind]
        found = sum(
            1 for ev in t_k if any(_near_truth(e, ev, tol) for e in events)
        )
        true_e = sum(
            1 for e in e_k if any(_near_truth(e, ev, tol) for ev in truth)
        )
        out[kind] = {
            "recall": round(found / len(t_k), 4) if t_k else None,
            "precision": round(true_e / len(e_k), 4) if e_k else None,
            "n_truth": len(t_k),
            "n_called": len(e_k),
        }
    return out
