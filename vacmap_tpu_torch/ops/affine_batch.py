"""Batched banded two-piece affine alignment on the card (counterpart of
``vacmap_tpu/ops/affine_jax.py``).

``affine_batch`` aligns many (target, query) pairs at once: the DP runs
row by row over the target with a band of W lanes a pair (offset
d = j - i in [dlo, dlo + W)), the row formulation of the host oracle
``affine_ref.align2p``.  Two modes, as in the reference:

* global (``glob=True``): every row's traceback bytes, a (B, T, W) uint8
  plane the host walks (``affine_ref._traceback``);
* z-drop extension (``glob=False``, ``zdrop >= 0``): the best cell, its
  row and column and whether the pair dropped, no plane.

On a CUDA tensor it launches csrc/affine_band.cu (one warp a pair, an
anti-diagonal wavefront over the band), which replaces the reference's
``lax.scan`` over rows (affine_jax.py:162); on a CPU tensor it runs
``affine_batch_ref``, a row loop that repeats the reference's step
(affine_jax.py:85-156) op for op in float32 with the same NEG = -1e9, so
that the planes of masked cells round as there too.
``affine_batch_wavefront_ref`` runs the kernel's order (cell (i, l) at
step 2i + l, with the carries it hands from lane to lane) on the same
float32 operations, for the CPU tests.

``BatchAligner`` is the host-facing aligner over it: pairs in length
buckets, bands of 128 / 256 / 512, the host traceback, and the host
``align2p`` for a pair outside the buckets or the band, as the
reference's class routes it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._build import library
from ..device import (
    DeviceKernelError, check_tensor, count_launch, device_call, launch_stream,
)
from .affine_ref import (
    _DEL1, _DEL2, _DIAG, _E1X, _E2X, _F1X, _F2X, _INS1, _INS2, AlignResult,
    _expand_eqx, _traceback, align2p,
)

NEG = -1e9
# the bands of BatchAligner (128, 256, 512) and of the mapping step (32):
# 1, 4, 8 or 16 band lanes a thread
BAND_WIDTHS = (32, 128, 256, 512)
MAX_Q = 48 * 1024  # the query staged in a block's shared memory
PLANE_BYTES = 128 << 20  # a global group's (B, T, W) plane cap


def band_start(t_len: torch.Tensor, q_len: torch.Tensor, W: int) -> torch.Tensor:
    """Each pair's first band offset dlo (int32), so that the band holds
    the end cell: floor division, as the reference's (affine_jax.py:71-72),
    also where W - (|q - t| + 1) is negative."""
    dq = q_len - t_len
    dlo = torch.clamp(dq, max=0) - torch.div(
        W - (dq.abs() + 1), 2, rounding_mode="floor")
    return torch.maximum(dlo, -t_len).to(torch.int32)


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """Lane l+1 to lane l, NEG into the last lane."""
    return F.pad(x[:, 1:], (0, 1), value=NEG)


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """Lane l-1 to lane l, NEG into lane 0."""
    return F.pad(x[:, :-1], (1, 0), value=NEG)


def affine_batch_ref(targets: torch.Tensor, queries: torch.Tensor,
                     t_len: torch.Tensor, q_len: torch.Tensor, *, W: int,
                     match=2, mismatch=-4, o1=4, e1=2, o2=24, e2=1,
                     zdrop=-1, glob=True):
    """The plain version: the reference's scan step as a loop over target
    rows, on the inputs' device.  Returns ``(tb, best, best_i, best_j,
    dead, dlo)`` with the reference's shapes and types: tb (B, T, W) uint8
    in the global mode, (T,) zeros in the extension mode.  Products that
    do not change from row to row (lane x e, the column-0 gap of each
    row) are made once, with the same float32 operations."""
    dev = targets.device
    B, T = targets.shape
    Q = queries.shape[1]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    f_o1, f_e1, f_o2, f_e2 = f32(o1), f32(e1), f32(o2), f32(e2)
    f_mat, f_mis, f_neg = f32(match), f32(mismatch), f32(NEG)
    t_len = t_len.to(torch.int32)
    q_len = q_len.to(torch.int32)
    lanes = torch.arange(W, dtype=torch.int32, device=dev)
    idxf = lanes.to(torch.float32)[None, :]
    idx_e1, idx_e2 = idxf * f_e1, idxf * f_e2
    dlo = band_start(t_len, q_len, W)
    ql, tl = q_len[:, None], t_len[:, None]
    rows = torch.arange(1, T + 1, dtype=torch.int32, device=dev)
    gap_rows = torch.minimum(f_o1 + f_e1 * rows, f_o2 + f_e2 * rows)

    j0 = lanes[None, :] + dlo[:, None]  # j_here - i
    inb0 = (j0 >= 0) & (j0 <= ql)
    gap0 = torch.minimum(f_o1 + f_e1 * j0, f_o2 + f_e2 * j0)
    H = torch.where(inb0 & (j0 > 0), -gap0,
                    torch.where(j0 == 0, f32(0.0), f_neg))
    E1 = torch.full((B, W), NEG, dtype=torch.float32, device=dev)
    E2 = E1.clone()
    best = torch.full((B,), NEG, dtype=torch.float32, device=dev)
    best_i = torch.zeros(B, dtype=torch.int32, device=dev)
    best_j = torch.zeros(B, dtype=torch.int32, device=dev)
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    tb = (torch.empty((B, T, W), dtype=torch.uint8, device=dev) if glob
          else torch.zeros(T, dtype=torch.uint8, device=dev))
    u8 = lambda v: torch.tensor(v, dtype=torch.uint8, device=dev)  # noqa: E731
    k_diag, k_del1, k_del2 = u8(_DIAG), u8(_DEL1), u8(_DEL2)
    k_ins1, k_ins2, zero = u8(_INS1), u8(_INS2), u8(0)
    k_e1x, k_e2x, k_f1x, k_f2x = u8(_E1X), u8(_E2X), u8(_F1X), u8(_F2X)

    for i in range(1, T + 1):
        j_here = j0 + i
        in_t = i <= t_len
        inb = (j_here >= 1) & (j_here <= ql) & in_t[:, None]
        qi = torch.gather(queries, 1, (j_here - 1).clamp(0, Q - 1).long())
        ti = targets[:, i - 1 : i]
        sub = torch.where(qi == ti, f_mat, f_mis)
        diag = H + sub
        H_up, E1u, E2u = _shift_down(H), _shift_down(E1), _shift_down(E2)
        E1 = torch.maximum(E1u - f_e1, H_up - f_o1 - f_e1)
        E2 = torch.maximum(E2u - f_e2, H_up - f_o2 - f_e2)
        H0 = torch.maximum(diag, torch.maximum(E1, E2))
        gapi = gap_rows[i - 1]
        col0 = j_here == 0
        H0 = torch.where(col0, -gapi, H0)
        okc = inb | col0
        masked = torch.where(okc, H0, f_neg)
        run1 = torch.cummax(masked + idx_e1, dim=1).values
        F1 = _shift_up(run1) - idx_e1 - f_o1
        run2 = torch.cummax(masked + idx_e2, dim=1).values
        F2 = _shift_up(run2) - idx_e2 - f_o2
        H = torch.maximum(H0, torch.maximum(F1, F2))
        H = torch.where(col0, -gapi, H)
        H = torch.where(okc, H, f_neg)

        if glob:
            # the reference's nested selects: DIAG > E2 > E1 > F2 > F1
            op = torch.where(H == F2, k_ins2,
                             torch.where(H == F1, k_ins1, k_diag))
            op = torch.where(H == E2, k_del2,
                             torch.where(H == E1, k_del1, op))
            op = torch.where(H == diag, k_diag, op)
            bits = op | torch.where(E1 == E1u - f_e1, k_e1x, zero)
            bits = bits | torch.where(E2 == E2u - f_e2, k_e2x, zero)
            bits = bits | torch.where(F1 == _shift_up(F1) - f_e1, k_f1x, zero)
            bits = bits | torch.where(F2 == _shift_up(F2) - f_e2, k_f2x, zero)
            tb[:, i - 1] = bits

        Hm = torch.where(inb, H, f_neg)
        p = torch.argmax(Hm, dim=1, keepdim=True)
        row_best = torch.gather(Hm, 1, p)[:, 0]
        improved = (row_best > best) & ~dead & in_t
        best = torch.where(improved, row_best, best)
        best_i = torch.where(improved, i, best_i)
        best_j = torch.where(improved, torch.gather(j_here, 1, p)[:, 0], best_j)
        if not glob and zdrop >= 0:
            dead = dead | ((best - row_best > zdrop) & in_t)
    return tb, best, best_i, best_j, dead, dlo


def affine_batch_wavefront_ref(targets: torch.Tensor, queries: torch.Tensor,
                               t_len: torch.Tensor, q_len: torch.Tensor, *,
                               W: int, match=2, mismatch=-4, o1=4, e1=2, o2=24,
                               e2=1, zdrop=-1, glob=True):
    """The kernel's order in plain PyTorch (csrc/affine_band.cu): cell
    (i, l) at step s = 2i + l, so that a step's cells are independent.
    Each lane keeps H, E1 and E2 of the last row it made (its right-hand
    neighbour reads them as the cell above, itself as the diagonal) and
    the carries its left-hand neighbour reads at the next step: the
    cummaxes run1 and run2 (``run[l] = max(run[l-1], base[l])``), F1, F2
    and the row's best so far (value, lane; a strict > keeps the lowest
    lane).  Lane W - 1 completes row i's best at step 2i + W - 1, where
    best, best_i, best_j and dead change.  Rows run to T in the global
    mode and to min(T, t_len) in the extension mode.  The same float32
    operations as ``affine_batch_ref``, so every output, the plane
    included, is equal bit for bit."""
    dev = targets.device
    B, T = targets.shape
    Q = queries.shape[1]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    f_o1, f_e1, f_o2, f_e2 = f32(o1), f32(e1), f32(o2), f32(e2)
    f_mat, f_mis, f_neg = f32(match), f32(mismatch), f32(NEG)
    t_len = t_len.to(torch.int32)
    q_len = q_len.to(torch.int32)
    lanes = torch.arange(W, dtype=torch.int32, device=dev)
    lf = lanes.to(torch.float32)
    le1, le2 = lf * f_e1, lf * f_e2
    dlo = band_start(t_len, q_len, W)
    # column 0's value, a constant of each lane: it lies on row -dlo - l
    i0 = (-dlo[:, None] - lanes[None, :]).to(torch.float32)
    col0_h = -torch.minimum(f_o1 + f_e1 * i0, f_o2 + f_e2 * i0)
    j0 = lanes[None, :] + dlo[:, None]
    inb0 = (j0 >= 0) & (j0 <= q_len[:, None])
    gap0 = torch.minimum(f_o1 + f_e1 * j0, f_o2 + f_e2 * j0)
    H = torch.where(inb0 & (j0 > 0), -gap0,
                    torch.where(j0 == 0, f32(0.0), f_neg))
    full = lambda v: torch.full((B, W), v, dtype=torch.float32, device=dev)  # noqa: E731
    E1, E2, R1, R2, F1, F2, BV = (full(NEG) for _ in range(7))
    BL = torch.zeros((B, W), dtype=torch.int32, device=dev)
    best = torch.full((B,), NEG, dtype=torch.float32, device=dev)
    best_i = torch.zeros(B, dtype=torch.int32, device=dev)
    best_j = torch.zeros(B, dtype=torch.int32, device=dev)
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    tb = (torch.zeros((B, T, W), dtype=torch.uint8, device=dev) if glob
          else torch.zeros(T, dtype=torch.uint8, device=dev))
    last = (torch.full((B,), T, dtype=torch.int32, device=dev) if glob
            else t_len.clamp(0, T))
    u8 = lambda v: torch.tensor(v, dtype=torch.uint8, device=dev)  # noqa: E731
    zero = u8(0)
    ql, tl = q_len[:, None], t_len[:, None]
    # the row's left and right edges: lane -1 (the carries' start; bv
    # -inf so that lane 0 always takes its own value) and lane W (NEG)
    neg_col = torch.full((B, 1), NEG, dtype=torch.float32, device=dev)
    ninf_col = torch.full((B, 1), -float("inf"), dtype=torch.float32,
                          device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    n_last = int(last.max()) if B else 0
    for s in range(2, 2 * n_last + W if n_last >= 1 else 0):
        L = lanes[s % 2 :: 2]
        i = (s - L) // 2  # each lane's row at this step
        act = (i[None, :] >= 1) & (i[None, :] <= last[:, None])
        if not bool(act.any()):
            continue
        j = L[None, :] + i[None, :] + dlo[:, None]
        ti = targets[:, (i - 1).clamp(0, T - 1).long()]
        qi = torch.gather(queries, 1, (j - 1).clamp(0, Q - 1).long())
        sub = torch.where(qi == ti, f_mat, f_mis)
        Hd = H[:, L]
        up = (L + 1).long()  # the cell above: lane l + 1's last row
        Hu = torch.cat([H, neg_col], 1)[:, up]
        E1u = torch.cat([E1, neg_col], 1)[:, up]
        E2u = torch.cat([E2, neg_col], 1)[:, up]
        left = L.long()  # lane l - 1's carries, at index l after the edge
        r1p = torch.cat([neg_col, R1], 1)[:, left]
        r2p = torch.cat([neg_col, R2], 1)[:, left]
        f1p = torch.cat([neg_col, F1], 1)[:, left]
        f2p = torch.cat([neg_col, F2], 1)[:, left]
        bvp = torch.cat([ninf_col, BV], 1)[:, left]
        blp = torch.cat([zero_col, BL], 1)[:, left]
        lane0 = (L == 0)[None, :]
        l_e1, l_e2 = le1[L], le2[L]

        diag = Hd + sub
        e1x, e2x = E1u - f_e1, E2u - f_e2
        e1n = torch.maximum(e1x, Hu - f_o1 - f_e1)
        e2n = torch.maximum(e2x, Hu - f_o2 - f_e2)
        h0 = torch.maximum(diag, torch.maximum(e1n, e2n))
        col0 = j == 0
        h0 = torch.where(col0, col0_h[:, L], h0)
        inb = (j >= 1) & (j <= ql) & (i[None, :] <= tl)
        okc = inb | col0
        m = torch.where(okc, h0, f_neg)
        b1, b2 = m + l_e1, m + l_e2
        r1 = torch.where(lane0, b1, torch.maximum(r1p, b1))
        r2 = torch.where(lane0, b2, torch.maximum(r2p, b2))
        f1 = r1p - l_e1 - f_o1
        f2 = r2p - l_e2 - f_o2
        h = torch.maximum(h0, torch.maximum(f1, f2))
        h = torch.where(col0, col0_h[:, L], h)
        h = torch.where(okc, h, f_neg)
        hm = torch.where(inb, h, f_neg)
        take = hm > bvp
        bv = torch.where(take, hm, bvp)
        bl = torch.where(take, L[None, :].expand_as(blp), blp)
        for state, new in ((H, h), (E1, e1n), (E2, e2n), (R1, r1), (R2, r2),
                           (F1, f1), (F2, f2), (BV, bv), (BL, bl)):
            state[:, L] = torch.where(act, new, state[:, L])
        if glob:
            op = torch.where(h == f2, u8(_INS2),
                             torch.where(h == f1, u8(_INS1), u8(_DIAG)))
            op = torch.where(h == e2n, u8(_DEL2),
                             torch.where(h == e1n, u8(_DEL1), op))
            op = torch.where(h == diag, u8(_DIAG), op)
            op = op | torch.where(e1n == e1x, u8(_E1X), zero)
            op = op | torch.where(e2n == e2x, u8(_E2X), zero)
            op = op | torch.where(f1 == f1p - f_e1, u8(_F1X), zero)
            op = op | torch.where(f2 == f2p - f_e2, u8(_F2X), zero)
            rows = (i - 1).clamp(0, T - 1).long()
            tb[:, rows, L] = torch.where(act, op, tb[:, rows, L])
        ic = (s - (W - 1)) // 2  # the row lane W - 1 completes at step s
        if s % 2 and ic >= 1:
            done = ic <= last
            in_t = done & (ic <= t_len)
            row_best, row_lane = BV[:, W - 1], BL[:, W - 1]
            improved = (row_best > best) & ~dead & in_t
            best = torch.where(improved, row_best, best)
            best_i = torch.where(improved, ic, best_i)
            best_j = torch.where(improved, row_lane + ic + dlo, best_j)
            if not glob and zdrop >= 0:
                dead = dead | ((best - row_best > zdrop) & in_t)
    return tb, best, best_i, best_j, dead, dlo


def affine_batch(targets: torch.Tensor, queries: torch.Tensor,
                 t_len: torch.Tensor, q_len: torch.Tensor, *, W: int,
                 match=2, mismatch=-4, o1=4, e1=2, o2=24, e2=1, zdrop=-1,
                 glob=True):
    """Banded two-piece affine DP of B pairs.  targets (B, T) uint8,
    queries (B, Q) uint8 (code 4 = pad), t_len, q_len (B,) int32 ->
    ``(tb, best, best_i, best_j, dead, dlo)`` as ``affine_batch_ref``.
    CPU tensors take the plain version; CUDA tensors launch
    csrc/affine_band.cu (W in BAND_WIDTHS, Q <= MAX_Q) or raise
    DeviceKernelError."""
    kw = dict(match=match, mismatch=mismatch, o1=o1, e1=e1, o2=o2, e2=e2,
              zdrop=zdrop, glob=glob)
    dev = targets.device
    if dev.type == "cpu":
        return affine_batch_ref(targets, queries, t_len, q_len, W=W, **kw)
    if dev.type != "cuda":
        raise DeviceKernelError(f"affine band kernel: unsupported device {dev}")
    if W not in BAND_WIDTHS:
        raise DeviceKernelError(
            f"affine band kernel takes W in {BAND_WIDTHS}, got {W}")
    if targets.dim() != 2 or queries.dim() != 2:
        raise DeviceKernelError(
            f"targets and queries must be (B, T) and (B, Q), got "
            f"{tuple(targets.shape)} and {tuple(queries.shape)}")
    B, T = targets.shape
    Q = queries.shape[1]
    if T < 1 or not 1 <= Q <= MAX_Q:
        raise DeviceKernelError(
            f"affine band kernel takes T >= 1 and Q in [1, {MAX_Q}], got "
            f"T={T} Q={Q}")
    check_tensor("targets", targets, torch.uint8, (B, T), dev)
    check_tensor("queries", queries, torch.uint8, (B, Q), dev)
    check_tensor("t_len", t_len, torch.int32, (B,), dev)
    check_tensor("q_len", q_len, torch.int32, (B,), dev)
    lib = library()
    # one buffer for every output: the plane (the extension mode's (T,)
    # zeros, which the kernel clears), then best, best_i, best_j, dlo and
    # dead; the kernel computes dlo
    plane = B * T * W if glob else T
    o = (plane + 15) & ~15
    alloc = torch.zeros if B == 0 else torch.empty
    buf = alloc(o + 17 * B, dtype=torch.uint8, device=dev)
    tb = buf[:plane].view(B, T, W) if glob else buf[:T]
    best, best_i, best_j, dlo = (
        buf[o + 4 * B * k : o + 4 * B * (k + 1)].view(dtype)
        for k, dtype in enumerate((torch.float32, torch.int32, torch.int32,
                                   torch.int32)))
    dead = buf[o + 16 * B :].view(torch.bool)
    if B == 0:
        return tb, best, best_i, best_j, dead, dlo
    with launch_stream(dev) as stream:
        rc = lib.affine_band_launch(
            targets.data_ptr(), queries.data_ptr(), t_len.data_ptr(),
            q_len.data_ptr(), buf.data_ptr(), best.data_ptr(),
            best_i.data_ptr(), best_j.data_ptr(), dlo.data_ptr(),
            dead.data_ptr(), B, T, Q, W, int(glob), match, mismatch, o1, e1,
            o2, e2, zdrop, stream)
    if rc != 0:
        raise DeviceKernelError(f"affine_band kernel launch failed: cudaError {rc}")
    count_launch(affine_batch, (B, T, W, bool(glob)))
    return tb, best, best_i, best_j, dead, dlo


affine_batch.launches = 0
affine_batch.shapes = {}  # (B, T, W, glob) -> launches


class BatchAligner:
    """Host-facing batched aligner with bucketed shapes and host traceback
    (counterpart of the reference's ``BatchAligner``).

    mode 'global': full end-to-end CIGARs (the band from the bucket).
    mode 'extend': z-drop extension; only (q_end, t_end) are used by the
    caller, so no traceback.  ``device``: where the DP runs (a card: the
    kernel; "cpu": the plain version).  A pair outside the buckets, or
    whose length difference the band cannot hold, goes to the host
    ``align2p``, as in the reference; a failed launch raises
    DeviceKernelError and is never answered from the host."""

    def __init__(self, match=2, mismatch=-4, o1=4, e1=2, o2=24, e2=1,
                 zdrop=-1, glob=True, len_buckets: Sequence[int] = None,
                 max_batch: int = 64, *, device):
        self.kw = dict(match=match, mismatch=mismatch, o1=o1, e1=e1, o2=o2,
                       e2=e2)
        self.zdrop = zdrop
        self.glob = glob
        if len_buckets is None:
            # global groups keep whole traceback planes: smaller buckets;
            # the extension mode (no plane) takes whole edge extensions
            len_buckets = ((256, 512, 1024, 2048, 4096) if glob
                           else (512, 2048, 8192, 32768))
        self.len_buckets = list(len_buckets)
        self.max_batch = max_batch
        self.device = torch.device(device)

    # the DP a group runs; the plain version for a subclass that holds
    # the kernel to it on the card
    _affine = staticmethod(affine_batch)

    def _bucket(self, n: int) -> int:
        for b in self.len_buckets:
            if n <= b:
                return b
        return -1

    def _band_for(self, bucket: int) -> int:
        if bucket <= 512:
            return 128
        if bucket <= 4096:
            return 256
        return 512

    def align_batch(self, pairs: List[Tuple[np.ndarray, np.ndarray]],
                    eqx=False) -> List[AlignResult]:
        """pairs: list of (target_codes, query_codes).  Returns a list of
        AlignResult in input order."""
        results: List[Optional[AlignResult]] = [None] * len(pairs)
        groups = {}
        for i, (t, q) in enumerate(pairs):
            tb_, qb_ = self._bucket(len(t)), self._bucket(len(q))
            bucket = max(tb_, qb_)
            # the band must hold |Q - T| and a drift margin, else the host
            if (tb_ < 0 or qb_ < 0
                    or abs(len(q) - len(t)) + 64 > self._band_for(bucket)
                    or len(t) == 0 or len(q) == 0):
                results[i] = align2p(
                    t, q, match=self.kw["match"],
                    mismatch=self.kw["mismatch"],
                    gap_open_1=self.kw["o1"], gap_extend_1=self.kw["e1"],
                    gap_open_2=self.kw["o2"], gap_extend_2=self.kw["e2"],
                    bw=-1 if self.glob else 256, zdrop=self.zdrop, eqx=eqx)
                continue
            groups.setdefault(bucket, []).append(i)
        for bucket, idxs in groups.items():
            max_b = self.max_batch
            if self.glob:  # bound the (B, T, W) traceback plane
                max_b = min(max_b, max(
                    1, PLANE_BYTES // (bucket * self._band_for(bucket))))
            for c0 in range(0, len(idxs), max_b):
                self._run_group(pairs, idxs[c0 : c0 + max_b], bucket, eqx,
                                results)
        return results

    def _run_group(self, pairs, idxs, bucket, eqx, results):
        B = len(idxs)
        targets = np.full((B, bucket), 4, np.uint8)
        queries = np.full((B, bucket), 4, np.uint8)
        lens = np.zeros((2, B), np.int32)
        for b, i in enumerate(idxs):
            t, q = pairs[i]
            targets[b, : len(t)] = t
            queries[b, : len(q)] = q
            lens[:, b] = (len(t), len(q))
        with device_call("batch aligner"):
            x = [torch.from_numpy(a).to(self.device)
                 for a in (targets, queries, lens[0], lens[1])]
            tb, best, best_i, best_j, dead, dlo = self._affine(
                *x, W=self._band_for(bucket), zdrop=self.zdrop,
                glob=self.glob, **self.kw)
            best, best_i, best_j, dead, dlo = (
                a.cpu().numpy() for a in (best, best_i, best_j, dead, dlo))
            if self.glob:
                tb = tb.cpu().numpy()
        if not self.glob:
            for b, i in enumerate(idxs):
                results[i] = AlignResult(
                    "", bool(dead[b]), int(best_j[b]), int(best_i[b]), 0, 0,
                    int(round(float(best[b]))))
            return
        for b, i in enumerate(idxs):
            t, q = pairs[i]
            cig, n_del, n_ins = _traceback(
                tb[b], len(t), len(q), int(dlo[b]), float(self.kw["e1"]),
                float(self.kw["e2"]))
            if eqx:
                cig = _expand_eqx(cig, t, q, len(t), len(q))
            results[i] = AlignResult(cig, False, len(q), len(t), n_del,
                                     n_ins, int(round(float(best[b]))))

    # the single-pair hook of the refine_chain aligner interface
    def __call__(self, t: np.ndarray, q: np.ndarray, eqx: bool = False):
        return self.align_batch([(t, q)], eqx=eqx)[0]
