"""Batched non-linear chaining DP (counterpart of
``vacmap_tpu/ops/chain_jax.py``).

Layout, as in the reference:
  anchors  (B, N, 4) int32 (readpos, refpos, strand, len), sorted by the
           variant's barrier key, zero-padded
  n_valid  (B,) int32
  skip_i   (B, N) float32 adaptive skipcost per anchor
  maxdiff_i (B, N) int32 adaptive maxdiff per anchor
Returns S (B, N) float32 and P (B, N) int32 (-1 = chain start).

``chain_scores_batch`` runs the CUDA kernel (csrc/chain_dp.cu; above
MAX_N anchors csrc/chain_dp_large.cu) on CUDA tensors and the plain
version ``chain_scores_batch_ref`` on CPU tensors.
``chain_scores_batch_warm`` is the warm-start (frontier-carry) DP of the
asm streaming chain: csrc/chain_dp_large.cu on CUDA tensors,
``chain_scores_batch_warm_ref`` on CPU tensors.

Both kernels finish rows in tiles (csrc/chain_tile.cuh).
``chain_scores_batch_tiled_ref`` and ``chain_scores_batch_warm_tiled_ref``
compute the DP in plain PyTorch the way the kernels do (S-free pair
terms, then apply; partial bests over a split of the candidates below
the tile; the in-tile walk; no candidate at or past the row on a sorted
read; the row-at-a-time route for an unsorted read), so that the
decomposition is held bit for bit to the plain versions where no card is.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .._build import library
from ..device import (
    DeviceKernelError, check_tensor, count_launch, cuda_stream, device_call,
)
from .chain_ref import ChainResult

NEG = -1e30
VARIANTS = ("global", "global_nocov", "refund", "fine", "mismatch")
MAX_N = 8192  # chain_dp.cu keeps N anchors + N scores in shared memory (per CTA)
# per-call anchors of TorchChainBackend (chain_dp_large.cu above MAX_N) and
# per-block anchors of TorchStreamChainBackend, as in the reference
MAX_ANCHORS = 65536
MAX_STREAM_ANCHORS = 1 << 20


def _f32(x: float) -> float:
    """A python float holding exactly the f32 value the reference's
    weak-typed scalar becomes."""
    return float(np.float32(x))


_DIVISORS = {}


def _divisors(device: torch.device):
    """(100.0, 1000.0) as 0-dim f32 tensors on ``device``.  On a CUDA
    tensor torch turns a division by a Python scalar into a multiplication
    by its reciprocal, one ulp away from the reference's (and the
    kernels') true division now and then; a tensor divisor is divided by."""
    if device not in _DIVISORS:
        _DIVISORS[device] = (
            torch.tensor(100.0, dtype=torch.float32, device=device),
            torch.tensor(1000.0, dtype=torch.float32, device=device))
    return _DIVISORS[device]


def _extra_penalty(gapcost: torch.Tensor) -> torch.Tensor:
    g = torch.clamp_min(gapcost.float(), 1.0)
    gf = gapcost.float()
    hundred, thousand = _divisors(gf.device)
    return torch.minimum(
        torch.full_like(gf, 36.0),
        torch.minimum(
            30.0 + 0.5 * torch.log(g),
            torch.clamp_max(gf / hundred, 10.0)
            + torch.clamp_max(gf / thousand, 30.0),
        ),
    )


def _gapcost_colinear(gapcost: torch.Tensor, kcoef: float,
                      local: bool) -> torch.Tensor:
    g = torch.clamp_min(gapcost.float(), 1.0)
    lg = torch.log2(g)
    if local:
        coef = torch.where(gapcost > 10, 2.0, 0.5)
    else:
        coef = torch.full_like(lg, 0.5)
    return torch.where(gapcost > 0, kcoef * gapcost.float() + coef * lg,
                       torch.zeros_like(lg))


def _pair_geometry(ai, Aj, maxdiff_i, maxgap, asm_geo):
    """The integer part of chain_jax._pair_scores, on any shapes that
    broadcast (ai the rows, Aj the candidates).  Returns (neg, bonus,
    readgap, same, gapcost, colinear)."""
    r_i, y_i, s_i, l_i = ai
    r_j, y_j, s_j, l_j = Aj
    raw_readgap = r_i - r_j - l_j
    neg = raw_readgap < 0
    bonus = torch.where(neg, r_i + l_i - r_j - l_j, l_i)
    overlap = r_j + l_j - r_i
    readgap = torch.clamp_min(raw_readgap, 0)
    same = s_j == s_i
    plus = s_i == 1
    j_minus = s_j == -1
    if asm_geo:
        nov = r_i - r_j
        refgap_neg = torch.where(
            same,
            torch.where(plus, y_i + overlap - (y_j + l_j), y_j - (y_i + bonus)),
            torch.where(j_minus, y_i + l_j - nov - y_j, y_i + l_i - y_j - nov),
        )
        refgap_pos = torch.where(
            same,
            torch.where(plus, y_i - y_j - l_j, y_j - y_i - l_i),
            torch.where(j_minus, y_i - y_j, y_i + l_i - y_j - l_j),
        )
    else:
        refgap_neg = torch.where(
            same,
            torch.where(plus, y_i + overlap - (y_j + l_j), y_j - (y_i + bonus)),
            torch.where(j_minus, y_i + overlap - y_j + 1,
                        y_i + bonus - 1 - (y_j + l_j)),
        )
        refgap_pos = torch.where(
            same,
            torch.where(plus, y_i - y_j - l_j, y_j - y_i - l_i),
            torch.where(j_minus, y_i - y_j + 1, y_i + l_i - 1 - y_j - l_j),
        )
    refgap = torch.where(neg, refgap_neg, refgap_pos)
    gapcost = torch.abs(readgap - refgap)
    colinear = same & (refgap >= 0) & (readgap <= maxgap) & (gapcost <= maxdiff_i)
    return neg, bonus, readgap, same, gapcost, colinear


def _pair_scores(ai, Aj, Sj, skip_i, maxdiff_i, kcoef, maxgap, skipcost,
                 variant, asm_geo):
    """chain_jax._pair_scores on (B, N) tensors: ai holds (B, 1) columns,
    Aj (B, N) ones.  Returns (test, colinear, bonus)."""
    local = variant in ("fine", "mismatch")
    neg, bonus, readgap, same, gapcost, colinear = _pair_geometry(
        ai, Aj, maxdiff_i, maxgap, asm_geo)

    bonus_f = bonus.float()
    zero = torch.zeros_like(bonus_f)
    col = Sj + bonus_f - _gapcost_colinear(gapcost, kcoef, local)
    if variant == "fine":
        rg = torch.clamp_max(readgap, 99).float()
        col = col - torch.where(readgap > 0, _f32(0.1) * torch.log2(rg + 1.0),
                                zero)
    elif variant == "mismatch":
        rgf = readgap.float()
        lrg = torch.where(readgap >= 30, 0.5 * rgf,
                          _f32(0.1) * torch.log2(rgf + 1.0))
        col = col - torch.where(readgap > 0, lrg, zero)

    if variant == "global":
        sv = Sj - skip_i + bonus_f - _extra_penalty(gapcost)
    elif variant == "refund":
        sv = Sj + bonus_f - skip_i
    elif variant == "fine":
        pen = torch.where(same, _f32(skipcost),
                          _f32(min(50.0, skipcost))) + _extra_penalty(gapcost)
        sv = Sj + bonus_f - pen
    else:  # mismatch
        gc = torch.clamp_max(gapcost, 99999).float()
        sv = Sj + bonus_f - (_f32(skipcost) + 0.5 * torch.log2(gc + 1.0))

    test = torch.where(colinear, col, sv)
    if local:
        test = torch.where(neg & (bonus <= 0), torch.full_like(test, NEG), test)
    return test, colinear, bonus


def _row_winner(test, S, mask, l_i, jidx):
    """One scan step's reduction: the best candidate under ``mask`` by
    (test, S[j], j), against the chain start l_i.  Returns (S_i, P_i,
    has_pred) of shape (B,)."""
    neg_full = torch.full_like(test, NEG)
    test = torch.where(mask, test, neg_full)
    m = test.max(dim=1).values
    has_pred = m > l_i
    # tie-break: among argmax, highest S[j]; then largest j
    is_max = test == m[:, None]
    s_best = torch.where(is_max, S, neg_full).max(dim=1).values
    cand = is_max & (S == s_best[:, None])
    p = torch.where(cand, jidx[None, :], -1).max(dim=1).values
    S_i = torch.where(has_pred, m, l_i)
    P_i = torch.where(has_pred, p, torch.full_like(p, -1))
    return S_i, P_i, has_pred


def chain_scores_batch_ref(
    anchors: torch.Tensor, n_valid: torch.Tensor, skip_i: torch.Tensor,
    maxdiff_i: torch.Tensor, *, kmersize: int = 15, maxdiff: int = 50,
    maxgap: int = 1000, skipcost: float = 40.0, variant: str = "global",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a Python loop over anchor index i of (B, N)
    tensor ops, line for line the reference's scan step."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown chain variant {variant!r}")
    asm_geo = variant == "global_nocov"
    if asm_geo:
        variant = "global"  # penalties already flat in skip_i/maxdiff_i
    B, N, _ = anchors.shape
    dev = anchors.device
    local = variant in ("fine", "mismatch")
    refund = variant == "refund"
    anchors = anchors.to(torch.int32)
    n_valid = n_valid.to(torch.int32)
    skip_i = skip_i.to(torch.float32)
    maxdiff_i = maxdiff_i.to(torch.int32)
    barrier = anchors[:, :, 0] + (anchors[:, :, 3] if local else 0)
    Aj = tuple(anchors[:, :, k] for k in range(4))
    kcoef = _f32(0.01 * kmersize)
    jidx = torch.arange(N, dtype=torch.int32, device=dev)
    valid_j = jidx[None, :] < n_valid[:, None]
    minus1 = torch.full((B,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)

    S = torch.zeros((B, N), dtype=torch.float32, device=dev)
    P = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    if refund:
        fixed_pen = torch.zeros((B, N), dtype=torch.float32, device=dev)
        pre_pen = torch.zeros((B, N), dtype=torch.float32, device=dev)
    # rows past every read's n_valid keep S = 0, P = -1
    for i in range(int(n_valid.max()) if B else 0):
        ai = tuple(anchors[:, i, k : k + 1] for k in range(4))
        test, colinear, bonus = _pair_scores(
            ai, Aj, S, skip_i[:, i : i + 1], maxdiff_i[:, i : i + 1], kcoef,
            maxgap, skipcost, variant, asm_geo)
        if refund:
            refundable = (colinear & (fixed_pen < 0)
                          & (fixed_pen + bonus.float() >= 0))
            test = torch.where(refundable, test + pre_pen, test)
        mask = (barrier < barrier[:, i : i + 1]) & valid_j
        l_i = anchors[:, i, 3].float()
        S_i, P_i, has_pred = _row_winner(test, S, mask, l_i, jidx)
        active = i < n_valid
        S_i = torch.where(active, S_i, torch.zeros_like(S_i))
        P_i = torch.where(active, P_i, minus1)
        S[:, i] = S_i
        P[:, i] = P_i
        if refund:
            pw = torch.clamp(P_i, 0, N - 1).long()
            win_col = colinear[rows, pw]
            win_bonus = bonus[rows, pw].float()
            fp_j = fixed_pen[rows, pw]
            pp_j = pre_pen[rows, pw]
            sk = skip_i[:, i]
            cont = (fp_j < 0) & (fp_j + win_bonus < 0)
            zero = torch.zeros_like(fp_j)
            new_fp = torch.where(win_col, torch.where(cont, fp_j + win_bonus, zero),
                                 -sk + win_bonus)
            new_pp = torch.where(win_col, torch.where(cont, pp_j, zero), sk)
            ok = has_pred & active
            fixed_pen[:, i] = torch.where(ok, new_fp, zero)
            pre_pen[:, i] = torch.where(ok, new_pp, zero)
    return S, P


TILE = 64  # rows per tile: chain_dp_large.cu's kTile (chain_dp.cu takes 32)
_INF = float("inf")


def _pair_terms(ai, Aj, skip_i, maxdiff_i, kcoef, maxgap, skipcost, variant,
                asm_geo):
    """csrc/chain_pair.cuh::pair_terms: the part of test(i, j) that does
    not need S[j].  Every branch of ``_pair_scores`` has the form
    ``(((S[j] - p0) + bonus) - p1) - p2`` (p0 = skip_i on the global
    non-colinear branch only, zeros where a branch has no such term:
    ``x - 0.0`` is exact).  Returns (p0, p1, p2, bonus_f, kill, colinear);
    ``kill`` marks test = NEG."""
    local = variant in ("fine", "mismatch")
    neg, bonus, readgap, same, gapcost, colinear = _pair_geometry(
        ai, Aj, maxdiff_i, maxgap, asm_geo)
    bonus_f = bonus.float()
    zero = torch.zeros_like(bonus_f)
    p1_col = _gapcost_colinear(gapcost, kcoef, local) + zero
    p2_col = zero
    if variant == "fine":
        rg = torch.clamp_max(readgap, 99).float()
        p2_col = torch.where(readgap > 0, _f32(0.1) * torch.log2(rg + 1.0),
                             zero)
    elif variant == "mismatch":
        rgf = readgap.float()
        lrg = torch.where(readgap >= 30, 0.5 * rgf,
                          _f32(0.1) * torch.log2(rgf + 1.0))
        p2_col = torch.where(readgap > 0, lrg, zero)
    p0_sv = zero
    if variant == "global":
        p0_sv = skip_i + zero
        p1_sv = _extra_penalty(gapcost)
    elif variant == "refund":
        p1_sv = skip_i + zero
    elif variant == "fine":
        p1_sv = torch.where(same, _f32(skipcost),
                            _f32(min(50.0, skipcost))) + _extra_penalty(gapcost)
    else:  # mismatch
        gc = torch.clamp_max(gapcost, 99999).float()
        p1_sv = _f32(skipcost) + 0.5 * torch.log2(gc + 1.0)
    p0 = torch.where(colinear, zero, p0_sv)
    p1 = torch.where(colinear, p1_col, p1_sv + zero)
    p2 = torch.where(colinear, p2_col, zero)
    kill = (neg & (bonus <= 0)) if local else torch.zeros_like(neg)
    return p0, p1, p2, bonus_f, kill, colinear


def _apply_terms(Sj, terms):
    """csrc/chain_pair.cuh::apply_terms: test(i, j) from S[j] and the
    pair's S-free terms, in the plain version's f32 operation order."""
    p0, p1, p2, bonus_f, kill, _ = terms
    test = (((Sj - p0) + bonus_f) - p1) - p2
    return torch.where(kill, torch.full_like(test, NEG), test)


def _lex_best(t, s, j, dim):
    """The (t, s, j) lexicographic maximum along ``dim`` (the kernels'
    better()): a total order, so any split of a reduction gives the same
    winner.  An entry that is no candidate holds (-inf, -inf, -1)."""
    m = t.max(dim=dim, keepdim=True).values
    is_max = t == m
    sb = torch.where(is_max, s, torch.full_like(s, -_INF)).max(
        dim=dim, keepdim=True).values
    cand = is_max & (s == sb)
    jb = torch.where(cand, j, torch.full_like(j, -1)).max(dim=dim).values
    return m.squeeze(dim), sb.squeeze(dim), jb


def _masked(mask, t, s, j):
    return (torch.where(mask, t, torch.full_like(t, -_INF)),
            torch.where(mask, s, torch.full_like(s, -_INF)),
            torch.where(mask, j, torch.full_like(j, -1)))


def _tiled_dp(anchors, n_valid, skip_i, maxdiff_i, S, P, n_warm, row_lo,
              row_hi, ledger, kcoef, maxgap, skipcost, variant, asm_geo,
              tile, n_split):
    """Rows [row_lo, row_hi) of barrier-sorted reads in tiles, updating S
    and P in place.  Rows below n_warm are frozen (candidates, never
    scored), rows at or past n_valid are left alone."""
    B, N, _ = anchors.shape
    dev = anchors.device
    local = variant in ("fine", "mismatch")
    barrier = anchors[:, :, 0] + (anchors[:, :, 3] if local else 0)
    args = (kcoef, maxgap, skipcost, variant, asm_geo)
    rows_b = torch.arange(B, device=dev)
    if ledger:
        fixed_pen = torch.zeros((B, N), dtype=torch.float32, device=dev)
        pre_pen = torch.zeros((B, N), dtype=torch.float32, device=dev)

    def refunded(t, terms, fp, pp):
        ok = terms[5] & (fp < 0) & (fp + terms[3] >= 0)
        return torch.where(ok, t + pp, t)

    for i0 in range(row_lo, row_hi, tile):
        T = min(tile, N - i0)
        rows = slice(i0, i0 + T)
        ai = tuple(anchors[:, rows, k].unsqueeze(2) for k in range(4))
        sk = skip_i[:, rows].unsqueeze(2)
        md = maxdiff_i[:, rows].unsqueeze(2)
        bar_i = barrier[:, rows].unsqueeze(2)
        # candidates below the tile hold their final S: partial bests over
        # an interleaved split, then the split's reduction
        parts = []
        for k in range(n_split):
            if k >= i0:
                break
            js = torch.arange(k, i0, n_split, device=dev)
            Aj = tuple(anchors[:, js, c].unsqueeze(1) for c in range(4))
            Sj = S[:, js].unsqueeze(1).expand(B, T, len(js))
            terms = _pair_terms(ai, Aj, sk, md, *args)
            t = _apply_terms(Sj, terms)
            if ledger:
                t = refunded(t, terms, fixed_pen[:, js].unsqueeze(1),
                             pre_pen[:, js].unsqueeze(1))
            mask = ((barrier[:, js].unsqueeze(1) < bar_i)
                    & (js[None, None, :] < n_valid[:, None, None]))
            jj = js.to(torch.int32)[None, None, :].expand(B, T, len(js))
            parts.append(_lex_best(*_masked(mask, t, Sj, jj), dim=2))
        if parts:
            pt, ps, pj = _lex_best(*(torch.stack(x, dim=2)
                                     for x in zip(*parts)), dim=2)
        else:
            pt = torch.full((B, T), -_INF, dtype=torch.float32, device=dev)
            ps = pt.clone()
            pj = torch.full((B, T), -1, dtype=torch.int32, device=dev)
        # the S-free terms of the in-tile pairs (r, jr < r); ties in the
        # barrier are common, so the barrier test stays
        Ajt = tuple(anchors[:, rows, c].unsqueeze(1) for c in range(4))
        terms_t = _pair_terms(ai, Ajt, sk, md, *args)
        ridx = torch.arange(T, device=dev)
        cand = ((barrier[:, rows].unsqueeze(1) < bar_i)
                & (ridx[None, None, :] < ridx[None, :, None]))
        jt = (i0 + ridx).to(torch.int32)[None, :].expand(B, T)
        for r in range(T):
            i = i0 + r
            active = (i >= n_warm) & (i < n_valid)
            if not bool(active.any()):
                continue
            terms = tuple(x[:, r, :] for x in terms_t)
            St = S[:, rows]
            t = _apply_terms(St, terms)
            if ledger:
                t = refunded(t, terms, fixed_pen[:, rows], pre_pen[:, rows])
            t, s, j = _masked(cand[:, r, :], t, St, jt)
            bt, _, bj = _lex_best(torch.cat([t, pt[:, r : r + 1]], 1),
                                  torch.cat([s, ps[:, r : r + 1]], 1),
                                  torch.cat([j, pj[:, r : r + 1]], 1), dim=1)
            l_i = anchors[:, i, 3].float()
            has_pred = bt > l_i
            S[:, i] = torch.where(active, torch.where(has_pred, bt, l_i),
                                  S[:, i])
            P_i = torch.where(has_pred, bj, torch.full_like(bj, -1))
            P[:, i] = torch.where(active, P_i, P[:, i])
            if ledger:
                pw = torch.clamp(P_i, 0, N - 1).long()
                win = _pair_terms(
                    tuple(anchors[:, i, c] for c in range(4)),
                    tuple(anchors[rows_b, pw, c] for c in range(4)),
                    skip_i[:, i], maxdiff_i[:, i], *args)
                win_col, win_bonus = win[5], win[3]
                fp_j = fixed_pen[rows_b, pw]
                pp_j = pre_pen[rows_b, pw]
                sk_i = skip_i[:, i]
                cont = (fp_j < 0) & (fp_j + win_bonus < 0)
                zero = torch.zeros_like(fp_j)
                new_fp = torch.where(
                    win_col, torch.where(cont, fp_j + win_bonus, zero),
                    -sk_i + win_bonus)
                new_pp = torch.where(win_col, torch.where(cont, pp_j, zero),
                                     sk_i)
                ok = has_pred & active
                fixed_pen[:, i] = torch.where(ok, new_fp, zero)
                pre_pen[:, i] = torch.where(ok, new_pp, zero)


def _unsorted_reads(anchors, n_valid, n_warm, local):
    """(B,) bool: a row in (n_warm, n_valid) has a smaller barrier than
    the row before it."""
    N = anchors.shape[1]
    barrier = anchors[:, :, 0] + (anchors[:, :, 3] if local else 0)
    jidx = torch.arange(1, N, dtype=torch.int32, device=anchors.device)
    return ((barrier[:, 1:] < barrier[:, :-1])
            & (jidx[None, :] > n_warm[:, None])
            & (jidx[None, :] < n_valid[:, None])).any(dim=1)


def chain_scores_batch_tiled_ref(
    anchors: torch.Tensor, n_valid: torch.Tensor, skip_i: torch.Tensor,
    maxdiff_i: torch.Tensor, *, kmersize: int = 15, maxdiff: int = 50,
    maxgap: int = 1000, skipcost: float = 40.0, variant: str = "global",
    tile: int = TILE, n_split: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``chain_scores_batch_ref`` computed the way csrc/chain_dp.cu does:
    tiles of ``tile`` rows, the candidates below a tile reduced in
    ``n_split`` parts (the warps and CTAs of the kernel), the in-tile walk
    over S-free records.  A read whose barriers are not sorted takes the
    row-at-a-time route, as in the kernel.  Equal to the plain version
    bit for bit."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown chain variant {variant!r}")
    asm_geo = variant == "global_nocov"
    v = "global" if asm_geo else variant
    B, N, _ = anchors.shape
    dev = anchors.device
    anchors = anchors.to(torch.int32)
    n_valid = torch.clamp(n_valid.to(torch.int32), 0, N)
    skip_i = skip_i.to(torch.float32)
    maxdiff_i = maxdiff_i.to(torch.int32)
    S = torch.zeros((B, N), dtype=torch.float32, device=dev)
    P = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    if B == 0:
        return S, P
    n_warm = torch.zeros_like(n_valid)
    bad = _unsorted_reads(anchors, n_valid, n_warm, v in ("fine", "mismatch"))
    if bool(bad.any()):
        S[bad], P[bad] = chain_scores_batch_ref(
            anchors[bad], n_valid[bad], skip_i[bad], maxdiff_i[bad],
            kmersize=kmersize, maxdiff=maxdiff, maxgap=maxgap,
            skipcost=skipcost, variant=variant)
    good = ~bad
    if bool(good.any()):
        Sg, Pg = S[good], P[good]
        _tiled_dp(anchors[good], n_valid[good], skip_i[good], maxdiff_i[good],
                  Sg, Pg, n_warm[good], 0, int(n_valid[good].max()),
                  v == "refund", _f32(0.01 * kmersize), maxgap, skipcost, v,
                  asm_geo, tile, n_split)
        S[good], P[good] = Sg, Pg
    return S, P


def chain_scores_batch(
    anchors: torch.Tensor, n_valid: torch.Tensor, skip_i: torch.Tensor,
    maxdiff_i: torch.Tensor, *, kmersize: int = 15, maxdiff: int = 50,
    maxgap: int = 1000, skipcost: float = 40.0, variant: str = "global",
    cluster: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact batched chaining DP; returns (S, P) of shape (B, N).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise DeviceKernelError).  ``cluster`` is the number of CTAs that
    share one read on the card (1, 2, 4 or 8; 0 lets the launch choose
    from B); it changes no result."""
    kw = dict(kmersize=kmersize, maxdiff=maxdiff, maxgap=maxgap,
              skipcost=skipcost, variant=variant)
    dev = anchors.device
    if dev.type == "cpu":
        return chain_scores_batch_ref(anchors, n_valid, skip_i, maxdiff_i, **kw)
    if dev.type != "cuda":
        raise DeviceKernelError(f"chain kernel: unsupported device {dev}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown chain variant {variant!r}")
    if anchors.dim() != 3 or anchors.shape[2] != 4:
        raise DeviceKernelError(f"anchors must be (B, N, 4), got {tuple(anchors.shape)}")
    B, N, _ = anchors.shape
    if N > MAX_N:
        if variant == "refund":
            raise DeviceKernelError(
                f"the refund chain kernel takes N <= {MAX_N}, got {N}")
        # the tiled kernel, cold: no frozen rows, S starts at 0
        zeros = torch.zeros((B, N), dtype=torch.float32, device=dev)
        return chain_scores_batch_warm(
            anchors, n_valid, skip_i, maxdiff_i, zeros,
            torch.zeros((B, N), dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev), **kw)
    check_tensor("anchors", anchors, torch.int32, (B, N, 4), dev)
    check_tensor("n_valid", n_valid, torch.int32, (B,), dev)
    check_tensor("skip_i", skip_i, torch.float32, (B, N), dev)
    check_tensor("maxdiff_i", maxdiff_i, torch.int32, (B, N), dev)
    if anchors.data_ptr() % 16:
        raise DeviceKernelError("anchors must be 16-byte aligned")
    lib = library()
    S = torch.empty((B, N), dtype=torch.float32, device=dev)
    P = torch.empty((B, N), dtype=torch.int32, device=dev)
    if variant == "refund":
        fixed_pen = torch.zeros((B, N), dtype=torch.float32, device=dev)
        pre_pen = torch.zeros((B, N), dtype=torch.float32, device=dev)
        ledger = (fixed_pen.data_ptr(), pre_pen.data_ptr())
    else:
        ledger = (None, None)
    rc = lib.chain_dp_launch(
        anchors.data_ptr(), n_valid.data_ptr(), skip_i.data_ptr(),
        maxdiff_i.data_ptr(), S.data_ptr(), P.data_ptr(), *ledger, B, N,
        VARIANTS.index(variant), _f32(0.01 * kmersize), int(maxgap),
        _f32(skipcost), int(cluster), cuda_stream(dev))
    if rc != 0:
        raise DeviceKernelError(f"chain_dp kernel launch failed: cudaError {rc}")
    count_launch(chain_scores_batch, (variant, B, N))
    return S, P


chain_scores_batch.launches = 0
chain_scores_batch.shapes = {}  # (variant, B, N) -> launches


def chain_scores_batch_warm_ref(
    anchors: torch.Tensor, n_valid: torch.Tensor, skip_i: torch.Tensor,
    maxdiff_i: torch.Tensor, warm_S: torch.Tensor, warm_P: torch.Tensor,
    n_warm: torch.Tensor, *, kmersize: int = 15, maxdiff: int = 50,
    maxgap: int = 1000, skipcost: float = 40.0, variant: str = "global",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the warm-start DP: the loop of
    ``chain_scores_batch_ref`` with the reference scan's frozen rows.  The
    first n_warm rows keep warm_S and their warm_P codes and are never
    scored; rows at or past n_valid keep warm_S and get P = -1.  "refund"
    is scored without its ledger, as the reference's warm scan does."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown chain variant {variant!r}")
    asm_geo = variant == "global_nocov"
    if asm_geo:
        variant = "global"  # penalties already flat in skip_i/maxdiff_i
    B, N, _ = anchors.shape
    dev = anchors.device
    local = variant in ("fine", "mismatch")
    anchors = anchors.to(torch.int32)
    n_valid = n_valid.to(torch.int32)
    n_warm = n_warm.to(torch.int32)
    skip_i = skip_i.to(torch.float32)
    maxdiff_i = maxdiff_i.to(torch.int32)
    warm_P = warm_P.to(torch.int32)
    barrier = anchors[:, :, 0] + (anchors[:, :, 3] if local else 0)
    Aj = tuple(anchors[:, :, k] for k in range(4))
    kcoef = _f32(0.01 * kmersize)
    jidx = torch.arange(N, dtype=torch.int32, device=dev)
    valid_j = jidx[None, :] < n_valid[:, None]

    S = warm_S.to(torch.float32).clone()
    P = torch.where(jidx[None, :] < n_warm[:, None], warm_P,
                    torch.full_like(warm_P, -1))
    # rows below every n_warm are frozen, rows past every n_valid inactive
    lo = int(n_warm.min()) if B else 0
    hi = int(n_valid.max()) if B else 0
    for i in range(lo, hi):
        ai = tuple(anchors[:, i, k : k + 1] for k in range(4))
        test, _colinear, _bonus = _pair_scores(
            ai, Aj, S, skip_i[:, i : i + 1], maxdiff_i[:, i : i + 1], kcoef,
            maxgap, skipcost, variant, asm_geo)
        mask = (barrier < barrier[:, i : i + 1]) & valid_j
        l_i = anchors[:, i, 3].float()
        S_i, P_i, _ = _row_winner(test, S, mask, l_i, jidx)
        active = (i < n_valid) & ~(i < n_warm)
        S[:, i] = torch.where(active, S_i, S[:, i])
        P[:, i] = torch.where(active, P_i, P[:, i])
    return S, P


def chain_scores_batch_warm_tiled_ref(
    anchors: torch.Tensor, n_valid: torch.Tensor, skip_i: torch.Tensor,
    maxdiff_i: torch.Tensor, warm_S: torch.Tensor, warm_P: torch.Tensor,
    n_warm: torch.Tensor, *, kmersize: int = 15, maxdiff: int = 50,
    maxgap: int = 1000, skipcost: float = 40.0, variant: str = "global",
    tile: int = TILE, n_split: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``chain_scores_batch_warm_ref`` computed the way
    csrc/chain_dp_large.cu does: tiles from the smallest n_warm on,
    frozen rows as candidates only, no ledger.  Rows past n_warm that are
    not sorted by barrier raise DeviceKernelError, as the kernel's wrapper
    does.  Equal to the plain version bit for bit."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown chain variant {variant!r}")
    asm_geo = variant == "global_nocov"
    v = "global" if asm_geo else variant
    B, N, _ = anchors.shape
    anchors = anchors.to(torch.int32)
    n_valid = torch.clamp(n_valid.to(torch.int32), 0, N)
    n_warm = torch.clamp(n_warm.to(torch.int32), 0, N)
    skip_i = skip_i.to(torch.float32)
    maxdiff_i = maxdiff_i.to(torch.int32)
    warm_P = warm_P.to(torch.int32)
    jidx = torch.arange(N, dtype=torch.int32, device=anchors.device)
    S = warm_S.to(torch.float32).clone()
    P = torch.where(jidx[None, :] < n_warm[:, None], warm_P,
                    torch.full_like(warm_P, -1))
    if B == 0 or N == 0:
        return S, P
    if bool(_unsorted_reads(anchors, n_valid, n_warm,
                            v in ("fine", "mismatch")).any()):
        raise DeviceKernelError(
            "warm chain kernel: rows past n_warm are not sorted by barrier")
    _tiled_dp(anchors, n_valid, skip_i, maxdiff_i, S, P, n_warm,
              int(n_warm.min()), int(n_valid.max()), False,
              _f32(0.01 * kmersize), maxgap, skipcost, v, asm_geo, tile,
              n_split)
    return S, P


def chain_scores_batch_warm(
    anchors: torch.Tensor, n_valid: torch.Tensor, skip_i: torch.Tensor,
    maxdiff_i: torch.Tensor, warm_S: torch.Tensor, warm_P: torch.Tensor,
    n_warm: torch.Tensor, *, kmersize: int = 15, maxdiff: int = 50,
    maxgap: int = 1000, skipcost: float = 40.0, variant: str = "global",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warm-start (frontier-carry) chaining DP, counterpart of the
    reference's ``chain_scores_batch_warm``: warm_S (B, N) f32 and warm_P
    (B, N) int32 hold the fixed scores and the (negative) predecessor
    codes of the first n_warm (B,) rows.  Returns (S, P) of shape (B, N).
    CPU tensors take the plain version; CUDA tensors launch the tiled
    kernel (or raise DeviceKernelError).  The kernel needs the rows in
    [n_warm, n_valid) sorted by barrier, as every caller's are."""
    kw = dict(kmersize=kmersize, maxdiff=maxdiff, maxgap=maxgap,
              skipcost=skipcost, variant=variant)
    dev = anchors.device
    if dev.type == "cpu":
        return chain_scores_batch_warm_ref(anchors, n_valid, skip_i,
                                           maxdiff_i, warm_S, warm_P, n_warm,
                                           **kw)
    if dev.type != "cuda":
        raise DeviceKernelError(f"chain kernel: unsupported device {dev}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown chain variant {variant!r}")
    if anchors.dim() != 3 or anchors.shape[2] != 4:
        raise DeviceKernelError(f"anchors must be (B, N, 4), got {tuple(anchors.shape)}")
    B, N, _ = anchors.shape
    check_tensor("anchors", anchors, torch.int32, (B, N, 4), dev)
    check_tensor("n_valid", n_valid, torch.int32, (B,), dev)
    check_tensor("skip_i", skip_i, torch.float32, (B, N), dev)
    check_tensor("maxdiff_i", maxdiff_i, torch.int32, (B, N), dev)
    check_tensor("warm_S", warm_S, torch.float32, (B, N), dev)
    check_tensor("warm_P", warm_P, torch.int32, (B, N), dev)
    check_tensor("n_warm", n_warm, torch.int32, (B,), dev)
    if anchors.data_ptr() % 16:
        raise DeviceKernelError("anchors must be 16-byte aligned")
    S = torch.empty((B, N), dtype=torch.float32, device=dev)
    P = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return S, P
    # the rows to score, and the kernel's precondition: between n_warm and
    # n_valid the barrier never decreases (one small reduction and one
    # read-back per call, against a DP of N^2 / 2 pair scores)
    unsorted = _unsorted_reads(anchors, n_valid, n_warm,
                               variant in ("fine", "mismatch")).any()
    row_lo, row_hi, bad = torch.stack(
        [n_warm.min(), n_valid.max(), unsorted.to(torch.int32)]).tolist()
    if bad:
        raise DeviceKernelError(
            "warm chain kernel: rows past n_warm are not sorted by barrier")
    row_lo, row_hi = max(min(row_lo, N), 0), max(min(row_hi, N), 0)
    lib = library()
    scratch = torch.empty(
        (max(int(lib.chain_dp_warm_scratch_bytes(B, N)), 1),),
        dtype=torch.uint8, device=dev)
    rc = lib.chain_dp_warm_launch(
        anchors.data_ptr(), n_valid.data_ptr(), n_warm.data_ptr(),
        skip_i.data_ptr(), maxdiff_i.data_ptr(), warm_S.data_ptr(),
        warm_P.data_ptr(), S.data_ptr(), P.data_ptr(), scratch.data_ptr(),
        B, N, row_lo, row_hi, VARIANTS.index(variant),
        _f32(0.01 * kmersize), int(maxgap), _f32(skipcost), cuda_stream(dev))
    if rc != 0:
        raise DeviceKernelError(
            f"chain_dp_warm kernel launch failed: cudaError {rc}")
    count_launch(chain_scores_batch_warm, (variant, B, N))
    return S, P


chain_scores_batch_warm.launches = 0
chain_scores_batch_warm.shapes = {}  # (variant, B, N) -> launches


def prepare_batch(anchor_list, variant: str, skipcost: float, maxdiff: int):
    """Pad a list of per-read (n,4) anchor arrays (already barrier-sorted)
    into device inputs, computing the adaptive per-anchor penalties on
    host (cheap O(n) bincounts)."""
    B = len(anchor_list)
    N = max((len(a) for a in anchor_list), default=1)
    # "global_nocov" (asm): global scoring, flat penalties
    # bucket N to powers of two (>=128) so each (variant, N) pair compiles
    # exactly once per process
    N = max(128, 1 << int(np.ceil(np.log2(max(N, 1)))))
    anchors = np.zeros((B, N, 4), np.int32)
    n_valid = np.zeros(B, np.int32)
    skip_i = np.full((B, N), float(skipcost), np.float32)
    maxdiff_i = np.full((B, N), maxdiff, np.int32)
    for b, a in enumerate(anchor_list):
        n = len(a)
        n_valid[b] = n
        anchors[b, :n] = a
        if variant == "global" and n:
            rp = a[:, 0].astype(np.int64)
            cov = np.minimum(np.bincount(rp)[rp], 20)
            skip_i[b, :n] = skipcost + cov
            maxdiff_i[b, :n] = np.maximum(maxdiff - cov, 10)
        # "global_nocov" keeps the flat defaults
    return anchors, n_valid, skip_i, maxdiff_i


def to_device(device, *arrays):
    """prepare_batch's numpy arrays -> contiguous tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def _int32_coords(A: np.ndarray) -> bool:
    """Every reference coordinate below 2^31 (the device anchors are
    int32)."""
    return len(A) == 0 or int(A[:, 1].max()) < 2**31


def device_chainable(A: np.ndarray) -> bool:
    """True when a batched launch of chain_dp.cu can take one read's
    (n, 4) anchors: at most MAX_N of them and int32 coordinates.  The
    host DP takes the others."""
    return len(A) <= MAX_N and _int32_coords(A)


def chain_results(device, anchor_list, variant: str, kmersize: int,
                  skipcost: float, maxdiff: int, maxgap: int,
                  pad_N: Optional[int] = None,
                  pad_B: Optional[int] = None, step=None) -> List[ChainResult]:
    """Chain DP of many reads as one launch on ``device``: pad them into
    one batch (at least pad_B rows of pad_N anchors; padded rows and
    columns lie past n_valid and change nothing), run
    chain_scores_batch, and cut the result back into one ChainResult per
    read.  Given ``step`` (a ``parallel.mesh.ShardedChainStep`` of these
    parameters), the batch runs split over the step's devices instead.
    Any failure of the device call raises DeviceKernelError."""
    anchors, n_valid, skip_i, maxdiff_i = prepare_batch(
        anchor_list, variant, skipcost, maxdiff)
    B, N = anchors.shape[:2]
    pb, pn = max(B, pad_B or 0) - B, max(N, pad_N or 0) - N
    if pb or pn:
        anchors = np.pad(anchors, ((0, pb), (0, pn), (0, 0)))
        n_valid = np.pad(n_valid, (0, pb))
        skip_i = np.pad(skip_i, ((0, pb), (0, pn)))
        maxdiff_i = np.pad(maxdiff_i, ((0, pb), (0, pn)))
    with device_call(f"{variant} chain device call"):
        if step is not None:
            S, P, _, _ = step(anchors, n_valid, skip_i, maxdiff_i)
        else:
            S, P = chain_scores_batch(
                *to_device(device, anchors, n_valid, skip_i, maxdiff_i),
                kmersize=kmersize, maxdiff=maxdiff, maxgap=maxgap,
                skipcost=skipcost, variant=variant,
            )
            S, P = S.cpu().numpy(), P.cpu().numpy()
        S = S.astype(np.float64)
        P = P.astype(np.int64)
    out = []
    for b, A in enumerate(anchor_list):
        n = len(A)
        Sb, Pb = S[b, :n], P[b, :n]
        out.append(ChainResult(int(np.argmax(Sb)) if n else -1, Sb, Pb))
    return out


class TorchChainBackend:
    """chain_read/chain_local-compatible backend: per-call batch of one
    (the batched executor batches through chain_results itself).  Above
    MAX_N anchors the call takes the tiled kernel.  Returns None, so the
    host DP takes over, for more than ``max_anchors`` anchors, for a
    reference coordinate of 2^31 or more, and for the refund variant
    above MAX_N (its ledger exists only in chain_dp.cu)."""

    def __init__(self, device, max_anchors: int = MAX_ANCHORS):
        self.device = torch.device(device)
        self.max_anchors = max_anchors

    def __call__(self, A: np.ndarray, variant: str, kmersize: int,
                 skipcost: float, maxdiff: int, maxgap: int):
        if len(A) > self.max_anchors or not _int32_coords(A):
            return None
        if variant == "refund" and len(A) > MAX_N:
            return None
        return chain_results(self.device, [A], variant, kmersize, skipcost,
                             maxdiff, maxgap)[0]


class TorchStreamChainBackend:
    """stream_chain-compatible device backend for the asm frontier-carry
    chain (counterpart of the reference's JaxStreamChainBackend): one
    warm-start call per anchor block, N padded to a power of two.

    ``calls`` counts the blocks offered, ``engaged`` those the device
    chained, ``device_s`` the wall time of the device calls (transfers
    included), ``rows`` and ``max_rows`` the anchors (frontier included)
    of the chained blocks in all and of the largest one, and ``declined``
    the blocks left to the native DP by cause:
    "variant" (scar, asm_fine: no device kernel), "size" (empty or over
    ``max_anchors``) and "coords" (a reference coordinate of 2^31 or
    more).  A failed device call raises DeviceKernelError."""

    def __init__(self, device, max_anchors: int = MAX_STREAM_ANCHORS):
        self.device = torch.device(device)
        self.max_anchors = max_anchors
        self.calls = 0
        self.engaged = 0
        self.device_s = 0.0
        self.rows = 0
        self.max_rows = 0
        self.declined = {"variant": 0, "size": 0, "coords": 0}

    def __call__(self, linked: np.ndarray, variant: str, kmersize: int,
                 skipcost: float, maxdiff: int, maxgap: int,
                 warm_S: np.ndarray, warm_P: np.ndarray):
        self.calls += 1
        n = len(linked)
        why = ("size" if n == 0 or n > self.max_anchors
               else "variant" if variant in ("scar", "asm_fine")
               else None if _int32_coords(linked) else "coords")
        if why is not None:
            self.declined[why] += 1
            return None
        t0 = time.perf_counter()
        anchors, n_valid, skip_i, maxdiff_i = prepare_batch(
            [linked.astype(np.int64)], variant, skipcost, maxdiff)
        N = anchors.shape[1]
        # the frontier's f64 scores become f32 here, as in the reference
        w_S = np.zeros((1, N), np.float32)
        w_P = np.zeros((1, N), np.int32)
        w_S[0, : len(warm_S)] = warm_S
        w_P[0, : len(warm_P)] = warm_P
        n_warm = np.array([len(warm_S)], np.int32)
        with device_call(f"{variant} warm chain device call"):
            S, P = chain_scores_batch_warm(
                *to_device(self.device, anchors, n_valid, skip_i, maxdiff_i,
                           w_S, w_P, n_warm),
                kmersize=kmersize, maxdiff=maxdiff, maxgap=maxgap,
                skipcost=skipcost, variant=variant)
            out = (S.cpu().numpy().astype(np.float64)[0][:n],
                   P.cpu().numpy().astype(np.int64)[0][:n])
        self.engaged += 1
        self.rows += n
        self.max_rows = max(self.max_rows, n)
        self.device_s += time.perf_counter() - t0
        return out
