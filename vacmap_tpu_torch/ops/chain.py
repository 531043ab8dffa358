"""Batched non-linear chaining DP (counterpart of
``vacmap_tpu/ops/chain_jax.py``).

Layout, as in the reference:
  anchors  (B, N, 4) int32 (readpos, refpos, strand, len), sorted by the
           variant's barrier key, zero-padded
  n_valid  (B,) int32
  skip_i   (B, N) float32 adaptive skipcost per anchor
  maxdiff_i (B, N) int32 adaptive maxdiff per anchor
Returns S (B, N) float32 and P (B, N) int32 (-1 = chain start).

``chain_scores_batch`` runs the CUDA kernel (csrc/chain_dp.cu) on CUDA
tensors and the plain version ``chain_scores_batch_ref`` on CPU tensors.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from vacmap_tpu.ops.chain_ref import ChainResult

from .._build import library
from ..device import (
    DeviceKernelError, check_tensor, count_launch, cuda_stream, device_call,
)

NEG = -1e30
VARIANTS = ("global", "global_nocov", "refund", "fine", "mismatch")
MAX_N = 8192  # the kernel keeps N anchors + N scores in shared memory


def _f32(x: float) -> float:
    """A python float holding exactly the f32 value the reference's
    weak-typed scalar becomes."""
    return float(np.float32(x))


def _extra_penalty(gapcost: torch.Tensor) -> torch.Tensor:
    g = torch.clamp_min(gapcost.float(), 1.0)
    gf = gapcost.float()
    return torch.minimum(
        torch.full_like(gf, 36.0),
        torch.minimum(
            30.0 + 0.5 * torch.log(g),
            torch.clamp_max(gf / 100.0, 10.0) + torch.clamp_max(gf / 1000.0, 30.0),
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


def _pair_scores(ai, Aj, Sj, skip_i, maxdiff_i, kcoef, maxgap, skipcost,
                 variant, asm_geo):
    """chain_jax._pair_scores on (B, N) tensors: ai holds (B, 1) columns,
    Aj (B, N) ones.  Returns (test, colinear, bonus)."""
    local = variant in ("fine", "mismatch")
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
    neg_full = torch.full((B, N), NEG, dtype=torch.float32, device=dev)
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
        test = torch.where(mask, test, neg_full)
        l_i = anchors[:, i, 3].float()
        m = test.max(dim=1).values
        has_pred = m > l_i
        # tie-break: among argmax, highest S[j]; then largest j
        is_max = test == m[:, None]
        s_best = torch.where(is_max, S, neg_full).max(dim=1).values
        cand = is_max & (S == s_best[:, None])
        p = torch.where(cand, jidx[None, :], -1).max(dim=1).values
        S_i = torch.where(has_pred, m, l_i)
        P_i = torch.where(has_pred, p, minus1)
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


def chain_scores_batch(
    anchors: torch.Tensor, n_valid: torch.Tensor, skip_i: torch.Tensor,
    maxdiff_i: torch.Tensor, *, kmersize: int = 15, maxdiff: int = 50,
    maxgap: int = 1000, skipcost: float = 40.0, variant: str = "global",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact batched chaining DP; returns (S, P) of shape (B, N).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise DeviceKernelError)."""
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
        raise DeviceKernelError(f"chain kernel takes N <= {MAX_N}, got {N}")
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
        _f32(skipcost), cuda_stream(dev))
    if rc != 0:
        raise DeviceKernelError(f"chain_dp kernel launch failed: cudaError {rc}")
    count_launch(chain_scores_batch)
    return S, P


chain_scores_batch.launches = 0


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


def to_device(device, anchors, n_valid, skip_i, maxdiff_i):
    """prepare_batch's numpy arrays -> contiguous tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (anchors, n_valid, skip_i, maxdiff_i))


def device_chainable(A: np.ndarray) -> bool:
    """True when the kernel can take one read's (n, 4) anchors: at most
    MAX_N of them and every reference coordinate below 2^31 (the device
    anchors are int32).  The host DP takes the others."""
    return len(A) <= MAX_N and (len(A) == 0 or int(A[:, 1].max()) < 2**31)


def chain_results(device, anchor_list, variant: str, kmersize: int,
                  skipcost: float, maxdiff: int, maxgap: int,
                  pad_N: Optional[int] = None,
                  pad_B: Optional[int] = None) -> List[ChainResult]:
    """Chain DP of many reads as one launch on ``device``: pad them into
    one batch (at least pad_B rows of pad_N anchors; padded rows and
    columns lie past n_valid and change nothing), run
    chain_scores_batch, and cut the result back into one ChainResult per
    read.  Any failure of the device call raises DeviceKernelError."""
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
        S, P = chain_scores_batch(
            *to_device(device, anchors, n_valid, skip_i, maxdiff_i),
            kmersize=kmersize, maxdiff=maxdiff, maxgap=maxgap,
            skipcost=skipcost, variant=variant,
        )
        S = S.cpu().numpy().astype(np.float64)
        P = P.cpu().numpy().astype(np.int64)
    out = []
    for b, A in enumerate(anchor_list):
        n = len(A)
        Sb, Pb = S[b, :n], P[b, :n]
        out.append(ChainResult(int(np.argmax(Sb)) if n else -1, Sb, Pb))
    return out


class TorchChainBackend:
    """chain_read/chain_local-compatible backend: per-call batch of one
    (the batched executor batches through chain_results itself).
    Returns None, so the host DP takes over, for more than MAX_N anchors
    or a reference coordinate of 2^31 or more."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def __call__(self, A: np.ndarray, variant: str, kmersize: int,
                 skipcost: float, maxdiff: int, maxgap: int):
        if not device_chainable(A):
            return None
        return chain_results(self.device, [A], variant, kmersize, skipcost,
                             maxdiff, maxgap)[0]
