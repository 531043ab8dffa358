"""Two-piece affine-gap alignment with traceback (host reference).

Equivalent of the reference's ``mp.k_cigar`` C call (ksw2-style,
mammap_clrnano.py:21554 global fill / :2381 banded zdrop extension):

    k_cigar(target, query, match=2, mismatch=-4,
            gap_open_1=4, gap_extend_1=2, gap_open_2=24, gap_extend_2=1,
            bw, zdropvalue, eqx) ->
        (cigar, zdrop_code, q_end, t_end, del_count, ins_count)

Gap cost of length l is min(o1 + l*e1, o2 + l*e2).  The DP is banded in
the (j - i) anti-diagonal offset; rows run over the target.  The in-row
horizontal (insertion) dependency is resolved with a discounted running
max instead of a sequential scan — score-exact because reopening a gap
inside a same-direction gap run is always dominated under a two-piece
(concave) gap model.  This row formulation is the same one the device
wavefront kernel uses.

Banding: bw < 0 requests a global alignment; we use a band of
|len(q)-len(t)| + 2*DEFAULT_GLOBAL_BW which contains the optimum for all
realistic inter-anchor gaps (deviation from the reference's unbounded
fill, documented in DESIGN notes).
"""

from __future__ import annotations

import dataclasses

import numpy as np

NEG = np.float32(-1e9)
DEFAULT_GLOBAL_BW = 501

# traceback op codes for H-choice
_DIAG, _DEL1, _DEL2, _INS1, _INS2 = 0, 1, 2, 3, 4
# extra bits: E/F extension flags
_E1X, _E2X, _F1X, _F2X = 8, 16, 32, 64


@dataclasses.dataclass
class AlignResult:
    cigar: str
    zdropped: bool
    q_end: int
    t_end: int
    n_del: int
    n_ins: int
    score: int


def align2p(
    target: np.ndarray,
    query: np.ndarray,
    match: int = 2,
    mismatch: int = -4,
    gap_open_1: int = 4,
    gap_extend_1: int = 2,
    gap_open_2: int = 24,
    gap_extend_2: int = 1,
    bw: int = -1,
    zdrop: int = -1,
    eqx: bool = False,
) -> AlignResult:
    """Dispatcher: native C++ kernel when available, numpy otherwise
    (both implement the identical cost model and tie-breaks)."""
    from .. import native

    if native.available() and len(target) and len(query):
        res = native.align2p_native(
            target, query, match=match, mismatch=mismatch,
            o1=gap_open_1, e1=gap_extend_1, o2=gap_open_2, e2=gap_extend_2,
            bw=bw, zdrop=zdrop, eqx=eqx,
        )
        if res is not None:
            ops, q_end, t_end, score, zdropped = res
            cig = native.ops_to_cigar(ops)
            opc, lens = ops[:, 0], ops[:, 1]
            n_del = int(lens[opc == 2].sum())
            n_ins = int(lens[opc == 1].sum())
            return AlignResult(cig, zdropped, q_end, t_end, n_del, n_ins, score)
    return align2p_numpy(
        target, query, match=match, mismatch=mismatch,
        gap_open_1=gap_open_1, gap_extend_1=gap_extend_1,
        gap_open_2=gap_open_2, gap_extend_2=gap_extend_2,
        bw=bw, zdrop=zdrop, eqx=eqx,
    )


def align2p_numpy(
    target: np.ndarray,
    query: np.ndarray,
    match: int = 2,
    mismatch: int = -4,
    gap_open_1: int = 4,
    gap_extend_1: int = 2,
    gap_open_2: int = 24,
    gap_extend_2: int = 1,
    bw: int = -1,
    zdrop: int = -1,
    eqx: bool = False,
) -> AlignResult:
    """Align query against target (both uint8 base codes).

    bw >= 0: banded extension; scores of all cells are tracked and the
    best-scoring cell defines (t_end, q_end), with zdrop early exit.
    bw < 0: global alignment over an automatic band; cigar covers both
    sequences end to end.
    """
    T, Q = len(target), len(query)
    if T == 0 or Q == 0:
        # pure-gap cigar (only in global mode; the reference errors earlier)
        cig = (f"{Q}I" if Q else "") + (f"{T}D" if T else "")
        return AlignResult(cig, False, Q, T, T, Q, 0)

    glob = bw < 0
    if glob:
        w = abs(Q - T) + 2 * DEFAULT_GLOBAL_BW
    else:
        w = bw
    # band in offset d = j - i, d in [dlo, dhi]
    dlo = min(0, Q - T) - w
    dhi = max(0, Q - T) + w
    dlo = max(dlo, -T)
    dhi = min(dhi, Q)
    W = dhi - dlo + 1

    o1, e1 = np.float32(gap_open_1), np.float32(gap_extend_1)
    o2, e2 = np.float32(gap_open_2), np.float32(gap_extend_2)
    mat, mis = np.float32(match), np.float32(mismatch)

    # H rows indexed by band offset; H_row[p] = H[i][i + dlo + p]
    # j index per lane for row i: j = i + dlo + p
    lanes = np.arange(W, dtype=np.int64)

    # row i = 0 .. T ; row 0 is the H[0][j] boundary
    H_prev = np.full(W, NEG, np.float32)
    E1_prev = np.full(W, NEG, np.float32)
    E2_prev = np.full(W, NEG, np.float32)
    j0 = lanes + dlo  # j values at row 0
    inb0 = (j0 >= 0) & (j0 <= Q)
    gap0 = np.minimum(o1 + e1 * j0, o2 + e2 * j0).astype(np.float32)
    H_prev = np.where(inb0 & (j0 > 0), -gap0, np.where(j0 == 0, 0.0, NEG)).astype(
        np.float32
    )

    tb = np.zeros((T, W), np.uint8)  # traceback bits per row (row i-1 stored at i-1)
    best = np.float32(NEG)
    best_i = best_j = 0
    zdropped = False
    last_i = T

    qarr = query.astype(np.int64)
    tarr = target.astype(np.int64)

    for i in range(1, T + 1):
        j_here = lanes + i + dlo  # j values of this row's lanes
        inb = (j_here >= 1) & (j_here <= Q)
        # diagonal H[i-1][j-1] is the same lane in the previous row
        sub = np.where(
            (j_here >= 1) & (j_here <= Q),
            np.where(
                qarr[np.clip(j_here - 1, 0, Q - 1)] == tarr[i - 1], mat, mis
            ),
            NEG,
        ).astype(np.float32)
        diag = H_prev + sub
        # vertical (deletion): previous row, lane shifted +1 (same j)
        H_up = np.concatenate([H_prev[1:], [NEG]])
        E1u = np.concatenate([E1_prev[1:], [NEG]])
        E2u = np.concatenate([E2_prev[1:], [NEG]])
        E1 = np.maximum(E1u - e1, H_up - o1 - e1)
        E2 = np.maximum(E2u - e2, H_up - o2 - e2)
        H0 = np.maximum(diag, np.maximum(E1, E2))
        # boundary column j == 0 participates as an insertion source
        gapi = np.float32(min(o1 + e1 * i, o2 + e2 * i))
        H0 = np.where(j_here == 0, -gapi, H0)
        # horizontal (insertion): discounted running max within the row.
        # F_k[p] = max_{p'<p} (H0[p'] - o_k - (p-p')*e_k)
        idx = lanes.astype(np.float32)
        base1 = np.where(inb | (j_here == 0), H0, NEG) + idx * e1
        run1 = np.maximum.accumulate(base1)
        F1 = np.concatenate([[NEG], run1[:-1]]) - idx * e1 - o1
        base2 = np.where(inb | (j_here == 0), H0, NEG) + idx * e2
        run2 = np.maximum.accumulate(base2)
        F2 = np.concatenate([[NEG], run2[:-1]]) - idx * e2 - o2
        H = np.maximum(H0, np.maximum(F1, F2))
        # boundary column j == 0 (gap over target prefix)
        H = np.where(j_here == 0, -gapi, H)
        H = np.where(inb | (j_here == 0), H, NEG)

        # traceback bits
        op = np.full(W, _DIAG, np.uint8)
        op = np.where(H == F2, _INS2, np.where(H == F1, _INS1, op))
        op = np.where(H == E2, _DEL2, np.where(H == E1, _DEL1, op))
        op = np.where(H == diag, _DIAG, op)
        bits = op.astype(np.uint8)
        bits |= np.where(E1 == E1u - e1, _E1X, 0).astype(np.uint8)
        bits |= np.where(E2 == E2u - e2, _E2X, 0).astype(np.uint8)
        # F extension flags: F continues when F[p] == F[p-1] - e
        F1prev = np.concatenate([[NEG], F1[:-1]])
        F2prev = np.concatenate([[NEG], F2[:-1]])
        bits |= np.where(F1 == F1prev - e1, _F1X, 0).astype(np.uint8)
        bits |= np.where(F2 == F2prev - e2, _F2X, 0).astype(np.uint8)
        tb[i - 1] = bits

        valid = inb
        row_best_p = int(np.argmax(np.where(valid, H, NEG)))
        row_best = H[row_best_p]
        if row_best > best:
            best = row_best
            best_i, best_j = i, int(j_here[row_best_p])
        if not glob and zdrop >= 0 and best - row_best > zdrop:
            zdropped = True
            last_i = i
            break

        H_prev, E1_prev, E2_prev = H, E1, E2

    if glob:
        end_i, end_j = T, Q
        # score at the global end cell
        p_end = Q - T - dlo
        score = float(H_prev[p_end])
    else:
        end_i, end_j = best_i, best_j
        score = float(best)

    cig, n_del, n_ins = _traceback(tb, end_i, end_j, dlo, e1, e2)
    if eqx:
        cig = _expand_eqx(cig, target, query, end_i, end_j)
    return AlignResult(cig, zdropped, end_j, end_i, n_del, n_ins, int(round(score)))


def _traceback(tb, i, j, dlo, e1, e2):
    """Walk traceback bits from (i, j) to (0, 0); returns run-length
    encoded cigar (M runs; =/X expansion happens separately) and indel
    base counts."""
    ops = []  # (op_char, length) reversed
    n_del = n_ins = 0
    state = 0  # 0 = H, 1..4 = inside E1/E2/F1/F2 run
    while i > 0 or j > 0:
        if i == 0:
            ops.append(("I", j))
            n_ins += j
            break
        if j == 0:
            ops.append(("D", i))
            n_del += i
            break
        p = j - i - dlo
        bits = int(tb[i - 1][p])
        if state == 0:
            op = bits & 7
            if op == _DIAG:
                ops.append(("M", 1))
                i -= 1
                j -= 1
            elif op in (_DEL1, _DEL2):
                state = 1 if op == _DEL1 else 2
            else:
                state = 3 if op == _INS1 else 4
        elif state in (1, 2):
            ops.append(("D", 1))
            n_del += 1
            ext = bits & (_E1X if state == 1 else _E2X)
            i -= 1
            if not ext:
                state = 0
        else:
            ops.append(("I", 1))
            n_ins += 1
            ext = bits & (_F1X if state == 3 else _F2X)
            j -= 1
            if not ext:
                state = 0
    # merge runs, reverse to forward order
    merged = []
    for op, ln in reversed(ops):
        if merged and merged[-1][0] == op:
            merged[-1][1] += ln
        else:
            merged.append([op, ln])
    cig = "".join(f"{ln}{op}" for op, ln in merged)
    return cig, n_del, n_ins


def _expand_eqx(cigar: str, target, query, t_end, q_end) -> str:
    """Rewrite M runs as =/X runs against the aligned sequences."""
    import re

    out = []
    ti = qi = 0
    for m in re.finditer(r"(\d+)([MIDNSHP=X])", cigar):
        ln, op = int(m.group(1)), m.group(2)
        if op == "M":
            eq = query[qi : qi + ln] == target[ti : ti + ln]
            # run-length encode the equality vector
            start = 0
            for b in range(1, ln + 1):
                if b == ln or eq[b] != eq[start]:
                    out.append(f"{b - start}{'=' if eq[start] else 'X'}")
                    start = b
            ti += ln
            qi += ln
        else:
            out.append(f"{ln}{op}")
            if op in "D":
                ti += ln
            elif op in "I":
                qi += ln
    return "".join(out)


def align_strings(target: str, query: str, **kw) -> AlignResult:
    from ..seq import encode

    return align2p(encode(target), encode(query), **kw)
