"""The plain reference that decides ``correct``: written from VACmap's
published semantics and the SAM specification, with NumPy alone.  It
imports nothing of the program and takes nothing the program made; it
reads the program's SAM lines only to judge them.

Each sampled read's records are judged by what they say, three ways:

- ``sam_faults``: a record whose SEQ is not the read
  (reverse-complemented under flag 16), whose CIGAR does not
  consume the read, whose NM is not the CIGAR's mismatches plus indel
  bases, whose =/X columns disagree with the bases, or that leaves the
  genome.  An exact comparison: its limit is 0.
- ``unplaced_share``: the generator knows where every read base came
  from (``traffic.Pool.truth``: a point every 50 read bases, on the
  genome and its strand; sequencing insertions and inserted SV sequence
  have no origin and are left out).  A point is placed when a record
  aligns that read base on the right strand within ``PLACE_TOL`` bases
  of its origin, or on another copy of an exact repeat around it (a
  segmental duplication, a tandem array's unit).  A read with no line
  (the program leaves a read it cannot map out) has every point
  unplaced.  This judges seeding, the global chain and the local
  re-chains: what a read is split into and where each part goes.
- ``score_gap_per_kb``: every record's path is cut into pieces of at
  most ``PIECE`` read bases, cut after a match column and at every
  insertion or deletion of ``LONG_GAP`` bases or more (scored alike on
  both sides, so left out).  For each piece, a plain two-piece affine DP
  (match 2, mismatch -4, a gap of l bases min(4 + 2 l, 24 + l): VACmap's
  ``k_cigar`` scoring) finds the best score between the piece's first
  and last cell inside a band of ``MARGIN`` diagonals around the
  program's own path, so the best is never below the program's.  The
  number is the sum of best minus the program's, per kb of the pieces.
  This judges the fills and extensions.

The control (``control.py``) is this DP put in the program's place in
the precision below the configuration's float32 fill scores: every value
rounded to bfloat16, its path traced back and scored exactly.
"""

from __future__ import annotations

import concurrent.futures
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

MATCH, MISMATCH = 2, -4
Q1, E1, Q2, E2 = 4, 2, 24, 1
PIECE = 1000       # read bases of a judged piece, at most
LONG_GAP = 50      # an insertion or deletion this long ends a piece
MARGIN = 32        # band diagonals on each side of the program's path
PLACE_TOL = 1000   # bases between a placed read base and its origin
COPY_WIN = 64      # bases around a point that another repeat copy repeats
COPY_SHIFT = 8     # bases a point's copy may lie off the record's estimate
WORKERS = 4        # threads of the DP (NumPy releases the lock)
CHUNK = 256        # pieces a DP pass takes together
NEG = np.float32(-1e9)

_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")
_OPS = {"M": 0, "=": 1, "X": 2, "I": 3, "D": 4, "N": 5, "S": 6, "H": 7,
        "P": 8}
_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[ord(chr(_c).lower())] = _i


def codes(seq: str) -> np.ndarray:
    return _CODE[np.frombuffer(seq.encode(), np.uint8)]


def revcomp(c: np.ndarray) -> np.ndarray:
    out = np.where(c < 4, 3 - c, c).astype(np.uint8)
    return out[::-1]


def gap_cost(n):
    n = np.asarray(n, np.int64)
    return np.minimum(Q1 + E1 * n, Q2 + E2 * n)


# --------------------------------------------------------------------------
# a record's path


class Record:
    """One SAM line, walked: ``col_op`` per alignment column (0 match or
    mismatch, 1 insertion, 2 deletion), ``col_q`` the oriented read's
    index and ``col_t`` the genome's at that column (for an insertion the
    next genome base, for a deletion the next read base)."""

    def __init__(self, line: str):
        f = line.rstrip("\n").split("\t")
        self.flag = int(f[1])
        self.rname = f[2]
        self.pos = int(f[3]) - 1
        self.cigar = f[5]
        self.seq = f[9]
        self.nm = next((int(t[5:]) for t in f[11:] if t.startswith("NM:i:")),
                       None)
        self.mapped = not self.flag & 4
        self.reverse = bool(self.flag & 16)

    def walk(self):
        ops = _CIGAR.findall(self.cigar)
        if "".join(n + o for n, o in ops) != self.cigar:
            raise ValueError(f"bad CIGAR {self.cigar[:40]!r}")
        n = np.array([int(x) for x, _ in ops], np.int64)
        o = np.array([_OPS[y] for _, y in ops], np.int64)
        self.hard = (int(n[0]) if o[0] == 7 else 0,
                     int(n[-1]) if len(o) > 1 and o[-1] == 7 else 0)
        self.query_len = int(n[np.isin(o, (0, 1, 2, 3, 6, 7))].sum())
        lead = 0
        for k in range(len(o)):
            if o[k] in (6, 7):
                lead += int(n[k])
            else:
                break
        body = ~np.isin(o, (6, 7, 8))
        if np.isin(o, (5,)).any():
            raise ValueError("N in a read alignment")
        # clips only at the ends
        inner = np.nonzero(body)[0]
        if len(inner) and np.isin(o[inner[0]:inner[-1] + 1], (6, 7)).any():
            raise ValueError("a clip inside the alignment")
        kind = np.select([np.isin(o, (0, 1, 2)), o == 3, o == 4], [0, 1, 2], -1)
        self.eqx = np.repeat(o[body], n[body])  # 0 M, 1 =, 2 X, 3 I, 4 D
        op = np.repeat(kind[body], n[body])
        dq = (op != 2).astype(np.int64)
        dt = (op != 1).astype(np.int64)
        self.col_op = op
        self.col_q = lead + np.cumsum(dq) - dq
        self.col_t = self.pos + np.cumsum(dt) - dt
        return self


def same_copy(genome: np.ndarray, t: int, g: int) -> bool:
    """True when the genome around ``t`` (within ``COPY_SHIFT``) repeats
    the ``COPY_WIN`` bases around ``g`` exactly: a read base placed on
    another copy of a repeat is placed as well as on its origin."""
    h = COPY_WIN // 2
    if g - h < 0 or g + h > len(genome):
        return False
    want = np.asarray(genome[g - h : g + h])
    lo, hi = t - h - COPY_SHIFT, t + h + COPY_SHIFT
    if lo < 0 or hi > len(genome):
        return False
    seg = np.asarray(genome[lo:hi])
    return any(np.array_equal(seg[s : s + COPY_WIN], want)
               for s in range(2 * COPY_SHIFT + 1))


def path_score(op, qc, tc) -> int:
    """The exact score of an alignment path: ``op`` per column (0 a base
    pair, 1 insertion, 2 deletion), ``qc`` and ``tc`` the paired bases of
    its match columns."""
    m = op == 0
    s = int(np.where(qc == tc, MATCH, MISMATCH).sum()) if m.any() else 0
    if (~m).any():
        edges = np.flatnonzero(np.diff(np.concatenate(([-1], op, [-1]))))
        runs = np.diff(edges)
        kinds = op[edges[:-1]]
        s -= int(gap_cost(runs[kinds != 0]).sum())
    return s


# --------------------------------------------------------------------------
# the banded DP


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 to the nearest bfloat16 (ties to even), as float32."""
    u = x.astype(np.float32).view(np.uint32)
    u = (u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def band_dp(qs: Sequence[np.ndarray], ts: Sequence[np.ndarray],
            dlo: np.ndarray, dhi: np.ndarray, bf16: bool = False,
            traceback: bool = False):
    """Best two-piece affine scores of global alignments of ``qs[p]``
    (rows) against ``ts[p]`` (columns), from cell (0, 0) to (m, n), over
    cells whose diagonal j - i lies in [dlo[p], dhi[p]] (which holds 0 and
    n - m).  Float32, or every stored value rounded to bfloat16.  With
    ``traceback`` also each piece's path as (op, q index, t index) per
    column, in order."""
    P = len(qs)
    m = np.array([len(q) for q in qs], np.int64)
    n = np.array([len(t) for t in ts], np.int64)
    W = int((dhi - dlo).max()) + 1
    M = int(m.max())
    rnd = _bf16 if bf16 else (lambda x: x)
    lane = np.arange(W, dtype=np.int64)[None, :]
    # query and target bases padded; 4 never equals a base, 5 neither
    Q = np.full((P, M + 1), 4, np.uint8)
    T = np.full((P, int(n.max()) + W + M + 2), 5, np.uint8)
    for p in range(P):
        Q[p, : m[p]] = qs[p]
        T[p, : n[p]] = ts[p]
    dlo_ = dlo[:, None]
    lanef = lane.astype(np.float32)
    e_lane = {k: np.float32(e) * lanef for k, e in ((1, E1), (2, E2))}
    qe = {1: np.float32(Q1 + E1), 2: np.float32(Q2 + E2)}
    ee = {1: np.float32(E1), 2: np.float32(E2)}
    best = np.zeros(P, np.float32)
    bits = np.zeros((M + 1, P, W), np.uint8) if traceback else None

    def row_cols(i):
        j = i + dlo_ + lane
        return j, (j >= 0) & (j <= n[:, None])

    def horizontal(Hp, i, valid, b):
        """E1, E2 from Hp along the row (a prefix max), then H."""
        E = {}
        for k in (1, 2):
            a = Hp + e_lane[k]
            pm = np.maximum.accumulate(a, axis=1)
            ex = np.full_like(pm, NEG)
            ex[:, 1:] = pm[:, :-1] - qe[k] + ee[k] - e_lane[k][:, 1:]
            E[k] = rnd(np.where(valid, ex, NEG))
            if b is not None:
                opn = np.full_like(Hp, NEG)
                opn[:, 1:] = Hp[:, :-1] - qe[k]
                b |= ((E[k] > rnd(opn)) << (3 + k)).astype(np.uint8)
        H = np.maximum(Hp, np.maximum(E[1], E[2]))
        if b is not None:
            src = np.where(H == Hp, 0, np.where(H == E[1], 1, 2))
            b |= (src << 2).astype(np.uint8)
        return H

    # row 0: only (0, 0) and deletions from it
    j, valid = row_cols(0)
    Hp = np.where(j == 0, np.float32(0), NEG).astype(np.float32)
    b0 = np.zeros((P, W), np.uint8) if traceback else None
    H = horizontal(Hp, 0, valid, b0)
    if traceback:
        bits[0] = b0
    F = {1: np.full((P, W), NEG, np.float32), 2: np.full((P, W), NEG, np.float32)}
    done = m == 0
    if done.any():
        best[done] = H[done, (n - 0 - dlo)[done]]
    rows = np.arange(P)
    for i in range(1, M + 1):
        j, valid = row_cols(i)
        b = np.zeros((P, W), np.uint8) if traceback else None
        # vertical: (i-1, j) is lane l + 1 of the previous row
        up = np.full((P, W), NEG, np.float32)
        up[:, :-1] = H[:, 1:]
        Fn = {}
        for k in (1, 2):
            Fu = np.full((P, W), NEG, np.float32)
            Fu[:, :-1] = F[k][:, 1:]
            opn, ext = rnd(up - qe[k]), rnd(Fu - ee[k])
            Fn[k] = np.where(valid, np.maximum(opn, ext), NEG)
            if b is not None:
                b |= ((ext > opn) << (5 + k)).astype(np.uint8)
        qb = Q[:, i - 1][:, None]
        tb = np.take_along_axis(T, np.clip(j - 1, 0, T.shape[1] - 1), axis=1)
        s = np.where(qb == tb, np.float32(MATCH), np.float32(MISMATCH))
        diag = np.where(valid & (j >= 1), rnd(H + s), NEG)
        Hp = np.maximum(diag, np.maximum(Fn[1], Fn[2]))
        if b is not None:
            src = np.where(Hp == diag, 0, np.where(Hp == Fn[1], 1, 2))
            b |= src.astype(np.uint8)
        H = horizontal(Hp, i, valid, b)
        F = Fn
        if traceback:
            bits[i] = b
        fin = m == i
        if fin.any():
            best[fin] = H[rows[fin], (n - i - dlo)[fin]]
    if not traceback:
        return best, None
    return best, [_trace(bits[:, p], int(m[p]), int(n[p]), int(dlo[p]))
                  for p in range(P)]


def _trace(bits, m, n, dlo):
    """The path of one piece from its bits: states H, Hp, E1, E2, F1, F2."""
    out = []
    i, j, state = m, n, "H"
    guard = 4 * (m + n) + 8
    while (i or j) and guard:
        guard -= 1
        b = int(bits[i, j - i - dlo])
        if state == "H":
            state = ("Hp", "E1", "E2")[(b >> 2) & 3]
        elif state == "Hp":
            src = b & 3
            if src == 0:
                out.append((0, i - 1, j - 1))
                i, j, state = i - 1, j - 1, "H"
            else:
                state = ("F1", "F2")[src - 1]
        elif state in ("E1", "E2"):
            k = int(state[1])
            out.append((2, i, j - 1))
            state = state if (b >> (3 + k)) & 1 else "Hp"
            j -= 1
        else:
            k = int(state[1])
            out.append((1, i - 1, j))
            state = state if (b >> (5 + k)) & 1 else "H"
            i -= 1
        if i < 0 or j < 0 or not (dlo <= j - i < dlo + bits.shape[1]):
            raise RuntimeError("traceback left the band")
    if i or j:
        raise RuntimeError("traceback did not reach the start")
    return np.array(out[::-1], np.int64).reshape(-1, 3)


# --------------------------------------------------------------------------
# judging one run's sample


def _pieces(rec: Record, q: np.ndarray, genome: np.ndarray):
    """The record's judged pieces: (query bases, genome bases, dlo, dhi,
    program's score)."""
    op, cq, ct = rec.col_op, rec.col_q, rec.col_t
    if not len(op):
        return []
    edges = np.flatnonzero(np.diff(np.concatenate(([-1], op, [-1]))))
    starts, ends = edges[:-1], edges[1:]
    cut = np.zeros(len(op) + 1, bool)   # True: a piece boundary before col
    long_runs = (op[starts] != 0) & (ends - starts >= LONG_GAP)
    skip = np.zeros(len(op), bool)
    for a, z in zip(starts[long_runs], ends[long_runs]):
        skip[a:z] = True
        cut[a] = cut[z] = True
    cut[0] = cut[len(op)] = True
    # more cuts after match columns, every PIECE read bases
    qpos = np.cumsum(op != 2)
    is_m = np.flatnonzero(op == 0)
    marks = np.searchsorted(qpos[is_m], np.arange(PIECE, qpos[-1] + 1, PIECE))
    marks = is_m[marks[marks < len(is_m)]] + 1
    cut[marks] = True
    bounds = np.flatnonzero(cut)
    out = []
    for a, z in zip(bounds[:-1], bounds[1:]):
        if skip[a]:
            continue
        o, qi, ti = op[a:z], cq[a:z], ct[a:z]
        q0, t0 = int(qi[0]), int(ti[0])
        q1 = q0 + int((o != 2).sum())
        t1 = t0 + int((o != 1).sum())
        mm = o == 0
        score = path_score(o, q[qi[mm]], genome[ti[mm]])
        # diagonals of the path: after each column, (t - t0) - (q - q0)
        d = np.cumsum(o != 1) - np.cumsum(o != 2)
        dlo = min(0, int(d.min())) - MARGIN
        dhi = max(0, int(d.max())) + MARGIN
        out.append((q[q0:q1], genome[t0:t1], dlo, dhi, score))
    return out


def _run_dp(pieces, bf16=False, traceback=False):
    """band_dp over all pieces, CHUNK at a time sorted by length, in
    WORKERS threads; returns best scores (and paths) in the pieces'
    order."""
    order = np.argsort([len(p[0]) for p in pieces], kind="stable")
    chunks = [order[k : k + CHUNK] for k in range(0, len(order), CHUNK)]

    def one(idx):
        sel = [pieces[i] for i in idx]
        return band_dp([p[0] for p in sel], [p[1] for p in sel],
                       np.array([p[2] for p in sel], np.int64),
                       np.array([p[3] for p in sel], np.int64),
                       bf16=bf16, traceback=traceback)

    best = np.zeros(len(pieces), np.float64)
    paths: List[Optional[np.ndarray]] = [None] * len(pieces)
    with concurrent.futures.ThreadPoolExecutor(WORKERS) as ex:
        for idx, (b, tr) in zip(chunks, ex.map(one, chunks)):
            best[idx] = b
            if tr is not None:
                for i, path in zip(idx, tr):
                    paths[i] = path
    return best, paths


def judge(reads: Sequence[tuple], lines: Sequence[List[str]], truth,
          genome: np.ndarray, contig: str, control: bool = False,
          show=None) -> Dict[str, float]:
    """The three numbers over the sampled ``reads`` ((name, sequence)),
    the program's ``lines`` of each, and each read's ``truth`` points
    (read positions, genome positions, strands).  ``control`` adds
    ``control_score_gap_per_kb``: the bfloat16 DP's own paths on the same
    pieces, scored exactly."""
    faults, pieces, why = 0, [], []
    placed = total = 0
    G = len(genome)
    for (name, seq), recs_lines, (tr_r, tr_g, tr_s) in zip(reads, lines, truth):
        fwd = codes(seq)
        rev = revcomp(fwd)
        L = len(fwd)
        ok_pt = np.zeros(len(tr_r), bool)  # a read with no line: unplaced
        for line in recs_lines:
            try:
                rec = Record(line)
                if not rec.mapped:
                    if rec.seq != "*" and not np.array_equal(codes(rec.seq),
                                                             fwd):
                        raise ValueError("unmapped record's SEQ is not the read")
                    continue
                rec.walk()
                q = rev if rec.reverse else fwd
                if rec.rname != contig:
                    raise ValueError(f"contig {rec.rname!r}")
                if rec.query_len != L:
                    raise ValueError(f"CIGAR consumes {rec.query_len} of {L}")
                if rec.seq != "*":
                    want = q[rec.hard[0] : L - rec.hard[1]]
                    if not np.array_equal(codes(rec.seq), want):
                        raise ValueError("SEQ is not the read")
                op, cq, ct = rec.col_op, rec.col_q, rec.col_t
                if not len(op) or rec.pos < 0 or int(ct.max()) >= G:
                    raise ValueError("leaves the genome")
            except (ValueError, IndexError) as err:
                faults += 1
                why.append(f"{name}: {err}")
                continue
            # a walkable record: its tags are judged, and its path too
            mm = op == 0
            eq = q[cq[mm]] == genome[ct[mm]]
            nm = int((~eq).sum()) + int((~mm).sum())
            e = rec.eqx[mm]
            if rec.nm is not None and rec.nm != nm:
                faults += 1
                why.append(f"{name}: NM {rec.nm}, the CIGAR's {nm}")
            elif ((e == 1) & ~eq).any() or ((e == 2) & eq).any():
                faults += 1
                why.append(f"{name}: =/X disagree with the bases")
            # placement of the truth points this record aligns
            sq = np.flatnonzero(mm)
            mq, mt = cq[sq], ct[sq]
            if len(mq):
                pts_q = (L - 1 - tr_r) if rec.reverse else tr_r
                k = np.searchsorted(mq, pts_q, side="right") - 1
                inside = (k >= 0) & (pts_q <= mq[-1])
                k = np.maximum(k, 0)
                t_est = mt[k] + (pts_q - mq[k])
                strand = -1 if rec.reverse else 1
                cand = inside & (tr_s == strand) & ~ok_pt
                near = cand & (np.abs(t_est - tr_g) <= PLACE_TOL)
                ok_pt |= near
                for p in np.flatnonzero(cand & ~near):
                    ok_pt[p] = same_copy(genome, int(t_est[p]), int(tr_g[p]))
            pieces.extend(_pieces(rec, q, genome))
        placed += int(ok_pt.sum())
        total += len(ok_pt)
    out = {"sam_faults": faults,
           "unplaced_share": 1 - placed / total if total else 0.0}
    if pieces:
        best, _ = _run_dp(pieces)
        prog = np.array([p[4] for p in pieces], np.float64)
        kb = sum(len(p[0]) for p in pieces) / 1e3
        out["score_gap_per_kb"] = float((best - prog).sum() / kb)
        out["below_program"] = int((best < prog).sum())
        if control:
            _, paths = _run_dp(pieces, bf16=True, traceback=True)
            low = np.array([path_score(pa[:, 0], p[0][pa[pa[:, 0] == 0, 1]],
                                       p[1][pa[pa[:, 0] == 0, 2]])
                            for p, pa in zip(pieces, paths)], np.float64)
            out["control_score_gap_per_kb"] = float((best - low).sum() / kb)
    else:
        out["score_gap_per_kb"] = 0.0
        out["below_program"] = 0
    out["pieces"] = len(pieces)
    if show is not None:
        for w in why[:5]:
            show(f"judge: {w}")
    return out
