"""Exact global edit distances in batches: bit-parallel Myers 1999
(counterpart of ``examples/myers_pallas_device.py``, which the reference
kept at ``vacmap_tpu/ops/myers_pallas.py``).

The divergence filter's second route: its span pairs go through the fill
service's edit job kind to ``TorchMyersAligner``, which answers the exact
distance of every pair (no band, no cap), so the caller's decision
``d > cap`` needs no escalation.

``myers_distances`` launches csrc/myers.cu on CUDA tensors (one thread
block a pair, one 64-bit pattern word a thread, stepped as a
word-by-column wavefront) and takes ``myers_distances_ref``, the plain
PyTorch version of the same recurrence, on CPU tensors.
``myers_distances_wavefront_ref`` computes it in the kernel's order, for
the tests.  The pattern is packed on the host into Peq bit tables
(``pack_peq``): bit j of word w of plane c is set where pattern[64 w + j]
== c.

Base code 4 (ambiguous, and the planes' padding) matches nothing, not
even another 4: the TPU kernel's rule.  The host's native Myers counts
4 against 4 as a match, so the two agree only on pairs without a 4; the
fill service sends no pair with a 4 here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._build import library
from ..device import (
    DeviceKernelError, check_tensor, count_launch, cuda_stream, device_call,
)

# buckets: (text columns T, pattern length in 32-bit words Wd), the
# reference's keys: text up to T bases, pattern up to 32 Wd bases, sized
# for m <= 1.4 T (the divergence filter sends |n - m| <= 0.4 min(n, m))
DEFAULT_BUCKETS = ((2048, 128), (8192, 384), (20480, 896))
# cap on the pairs of one launch, per bucket.  A pair is one thread
# block; the caps bound the launch's padded planes (text T + Peq 16 Wd
# bytes a pair: 4, 7 and 9 MB at these sizes) rather than any on-chip
# memory
DEFAULT_B = {2048: 1024, 8192: 512, 20480: 256}
MAX_WORDS = 448  # 64-bit pattern words one block of csrc/myers.cu holds


def pack_peq(queries: Sequence[np.ndarray], W: int) -> np.ndarray:
    """Peq tables of the patterns: (B, 4, W) int64, little-endian bits
    (pattern base 64 w + j at bit j of word w).  Code 4 sets no bit."""
    B = len(queries)
    plane = np.full((B, W * 64), 4, np.uint8)
    for j, q in enumerate(queries):
        plane[j, : len(q)] = q
    bits = np.stack([np.packbits(plane == c, axis=1, bitorder="little")
                     for c in range(4)], axis=1)  # (B, 4, 8 W) uint8
    return np.ascontiguousarray(bits).view("<i8")


def _shift_words(x: torch.Tensor, s: int) -> torch.Tensor:
    """Word w takes word w - s; zeros enter at the low words."""
    if s >= x.shape[1]:
        return torch.zeros_like(x)
    return torch.cat([x.new_zeros((x.shape[0], s)), x[:, :-s]], dim=1)


def _carry_in(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Carry into each word of a multi-word add from the words' generate
    and propagate flags (0/1): c[0] = 0, c[w] = g[w-1] | p[w-1] & c[w-1],
    composed in log2(W) doubling steps."""
    g = _shift_words(g, 1)
    p = _shift_words(p, 1)
    s = 1
    while s < g.shape[1]:
        g = g | (p & _shift_words(g, s))
        p = p & _shift_words(p, s)
        s *= 2
    return g


def _shl1(x: torch.Tensor, fill: int) -> torch.Tensor:
    """Multi-word x << 1; ``fill`` enters bit 0 of word 0."""
    msb = (x < 0).to(torch.int64)
    below = _shift_words(msb, 1)
    below[:, 0] = fill
    return (x << 1) | below


def _end_bits(m: torch.Tensor, W: int) -> torch.Tensor:
    """(B, W) int64: bit m - 1 of each pattern, the one the score reads."""
    own = torch.zeros((m.shape[0], W), dtype=torch.int64, device=m.device)
    return own.scatter_(1, ((m - 1) >> 6).unsqueeze(1),
                        (torch.ones_like(m) << ((m - 1) & 63)).unsqueeze(1))


def myers_distances_ref(text: torch.Tensor, peq: torch.Tensor,
                        n_len: torch.Tensor, m_len: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version of csrc/myers.cu: text (B, T) uint8, peq
    (B, 4, W) int64, n_len, m_len (B,) int32 -> (B,) int32 distances.
    One step a text column on (B, W) int64 tensors; int64 adds wrap, and
    the carry out of a word is read off the sign bits."""
    B, _, W = peq.shape
    dev = peq.device
    n_len = n_len.to(torch.int64)
    m = m_len.to(torch.int64).clamp(1, W * 64)
    own = _end_bits(m, W)
    rows = torch.arange(B, device=dev)
    Pv = torch.full((B, W), -1, dtype=torch.int64, device=dev)
    Mv = torch.zeros_like(Pv)
    score = torch.zeros(B, dtype=torch.int64, device=dev)
    for i in range(int(n_len.max()) if B else 0):
        c = text[:, i].to(torch.int64)
        Eq = peq[rows, c.clamp(max=3)] * (c < 4).to(torch.int64).unsqueeze(1)
        Xv = Eq | Mv
        X = Eq & Pv
        s = X + Pv
        g = (((X & Pv) | ((X | Pv) & ~s)) >> 63) & 1
        p = (s == -1).to(torch.int64)
        s = s + _carry_in(g, p)
        Xh = (s ^ Pv) | Eq
        Ph = Mv | ~(Xh | Pv)
        Mh = Pv & Xh
        active = (n_len > i).to(torch.int64)
        score += active * (((Ph & own) != 0).any(dim=1).to(torch.int64)
                           - ((Mh & own) != 0).any(dim=1).to(torch.int64))
        Phs = _shl1(Ph, 1)
        Mhs = _shl1(Mh, 0)
        Pv = Mhs | ~(Xv | Phs)
        Mv = Phs & Xv
    return (m + score).to(torch.int32)


def myers_distances_wavefront_ref(text: torch.Tensor, peq: torch.Tensor,
                                  n_len: torch.Tensor, m_len: torch.Tensor
                                  ) -> torch.Tensor:
    """The same distances in csrc/myers.cu's order, for the tests: a
    word-by-column wavefront on (B, W) int64 tensors.  Step s computes,
    for every word w at once, text column s - w; the carry into word w
    and the two bits its Ph and Mh shift in are word w - 1's outputs of
    the step before (that word's same column), not a scan.  A pair uses
    only its own ceil(m / 64) words, and a word keeps its state outside
    the pair's columns [0, n).  Word 0 takes carry 0, Ph bit 1, Mh bit
    0."""
    B, T = text.shape
    W = peq.shape[2]
    dev = peq.device
    n = n_len.to(torch.int64).clamp(0, T)
    m = m_len.to(torch.int64).clamp(1, W * 64)
    own = _end_bits(m, W)
    word = torch.arange(W, device=dev)
    used = word < ((m + 63) >> 6).unsqueeze(1)
    rows = torch.arange(B, device=dev).unsqueeze(1)
    Pv = torch.full((B, W), -1, dtype=torch.int64, device=dev)
    Mv = torch.zeros_like(Pv)
    score = torch.zeros(B, dtype=torch.int64, device=dev)
    # the bits word w takes from word w - 1 (word 0: carry 0, Ph 1, Mh 0)
    c_in = torch.zeros_like(Pv)
    p_in = torch.zeros_like(Pv)
    p_in[:, 0] = 1
    m_in = torch.zeros_like(Pv)
    steps = int((n + ((m + 63) >> 6) - 1).max()) if B else 0
    for s in range(steps):
        i = s - word
        live = (i >= 0) & (i < n.unsqueeze(1)) & used
        c = text[rows, i.clamp(0, T - 1)].to(torch.int64)
        Eq = peq[rows, c.clamp(max=3), word] * (c < 4).to(torch.int64)
        X = Eq & Pv
        s1 = X + Pv
        g = (((X & Pv) | ((X | Pv) & ~s1)) >> 63) & 1
        cout = g | (c_in & (s1 == -1).to(torch.int64))
        Xh = ((s1 + c_in) ^ Pv) | Eq
        Ph = Mv | ~(Xh | Pv)
        Mh = Pv & Xh
        lv = live.to(torch.int64)
        score += (lv * ((Ph & own) != 0).to(torch.int64)).sum(1) \
            - (lv * ((Mh & own) != 0).to(torch.int64)).sum(1)
        Phs = (Ph << 1) | p_in
        Mhs = (Mh << 1) | m_in
        Xv = Eq | Mv
        Pv = torch.where(live, Mhs | ~(Xv | Phs), Pv)
        Mv = torch.where(live, Phs & Xv, Mv)
        # word w's outputs of this column reach word w + 1 next step
        c_in = _shift_words(cout, 1)
        p_in = _shift_words((Ph >> 63) & 1, 1)
        p_in[:, 0] = 1
        m_in = _shift_words((Mh >> 63) & 1, 1)
    return (m + score).to(torch.int32)


def myers_distances(text: torch.Tensor, peq: torch.Tensor,
                    n_len: torch.Tensor, m_len: torch.Tensor) -> torch.Tensor:
    """Edit distance of B pairs.  text (B, T) uint8 codes 0-4, peq
    (B, 4, W) int64 (``pack_peq``), n_len (B,) int32 text lengths <= T,
    m_len (B,) int32 pattern lengths in [1, 64 W] -> (B,) int32.  CPU
    tensors take the plain version; CUDA tensors launch csrc/myers.cu (or
    raise DeviceKernelError)."""
    dev = text.device
    if dev.type == "cpu":
        return myers_distances_ref(text, peq, n_len, m_len)
    if dev.type != "cuda":
        raise DeviceKernelError(f"myers kernel: unsupported device {dev}")
    if text.dim() != 2 or peq.dim() != 3:
        raise DeviceKernelError(
            f"text must be (B, T) and peq (B, 4, W), got {tuple(text.shape)} "
            f"and {tuple(peq.shape)}")
    B, T = text.shape
    W = peq.shape[2]
    if not 1 <= W <= MAX_WORDS:
        raise DeviceKernelError(
            f"myers kernel takes 1 to {MAX_WORDS} pattern words, got {W}")
    check_tensor("text", text, torch.uint8, (B, T), dev)
    check_tensor("peq", peq, torch.int64, (B, 4, W), dev)
    check_tensor("n_len", n_len, torch.int32, (B,), dev)
    check_tensor("m_len", m_len, torch.int32, (B,), dev)
    lib = library()
    dist = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return dist
    rc = lib.myers_launch(text.data_ptr(), peq.data_ptr(), n_len.data_ptr(),
                          m_len.data_ptr(), dist.data_ptr(), B, T, W,
                          cuda_stream(dev))
    if rc != 0:
        raise DeviceKernelError(f"myers kernel launch failed: cudaError {rc}")
    count_launch(myers_distances, (B, T))
    return dist


myers_distances.launches = 0
myers_distances.shapes = {}  # (B, T) -> launches


def pack_jobs(jobs: Sequence[Tuple[np.ndarray, np.ndarray]], T: int, Wd: int):
    """(text, pattern) code arrays -> the kernel's inputs as numpy: text
    plane (B, T) uint8 padded with 4, Peq (B, 4, Wd / 2) int64, n and m
    (B,) int32."""
    B = len(jobs)
    text = np.full((B, T), 4, np.uint8)
    for j, (t, _) in enumerate(jobs):
        text[j, : len(t)] = t
    n = np.array([len(t) for t, _ in jobs], np.int32)
    m = np.array([len(q) for _, q in jobs], np.int32)
    return text, pack_peq([q for _, q in jobs], (Wd + 1) // 2), n, m


class TorchMyersAligner:
    """Batched exact global edit distances on ``device`` (counterpart of
    ``PallasMyersAligner``): the fill service's edit aligner.  A launch
    carries exactly the pairs it is given, at most ``shape_b[T]``."""

    def __init__(self, device, buckets=DEFAULT_BUCKETS,
                 shape_b: Optional[Dict[int, int]] = None):
        self.device = torch.device(device)
        self.buckets = tuple(sorted(buckets))
        self.shape_b = dict(DEFAULT_B)
        self.shape_b.update(shape_b or {})
        for T, _ in self.buckets:
            self.shape_b.setdefault(T, 256)

    def _bucket(self, n: int, m: int):
        for T, Wd in self.buckets:
            if n <= T and m <= Wd * 32:
                return (T, Wd)
        return None

    def prewarm(self, buckets=None):
        """One launch per bucket on a one-base pair: builds and loads the
        kernel library before traffic (no per-shape compiles)."""
        one = np.zeros(1, np.uint8)
        for T, Wd in (buckets if buckets is not None else self.buckets):
            self.fetch(self.dispatch_jobs([(one, one)], T, Wd))

    def dispatch_jobs(self, jobs: Sequence[Tuple[np.ndarray, np.ndarray]],
                      T: int, Wd: int):
        """Launch one bucket's batch and return a handle without waiting
        for it (``fetch`` waits).  Every pair has 1 <= len(t) <= T and
        1 <= len(q) <= 32 Wd."""
        if len(jobs) > self.shape_b[T]:
            raise ValueError(f"{len(jobs)} jobs over the cap of bucket {T}")
        with device_call("edit dispatch"):
            dist = myers_distances(*(
                torch.from_numpy(a).to(self.device)
                for a in pack_jobs(jobs, T, Wd)))
            if dist.device.type != "cuda":
                return dist, None
            host = torch.empty(dist.shape, dtype=dist.dtype, pin_memory=True)
            host.copy_(dist, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dist.device))
            return host, ev

    def fetch(self, handle) -> np.ndarray:
        """Blocking: handle -> int64 distances of the dispatched jobs."""
        host, ev = handle
        with device_call("edit download"):
            if ev is not None:
                ev.synchronize()
            return host.numpy().astype(np.int64)

    def distance_batch(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]]
                       ) -> List[int]:
        """Exact editDistance(t, q) per pair; max(n, m) when a side is
        empty, -1 for a pair over every bucket."""
        results = [-1] * len(pairs)
        groups: Dict[tuple, list] = {}
        for i, (t, q) in enumerate(pairs):
            if len(t) == 0 or len(q) == 0:
                results[i] = max(len(t), len(q))
                continue
            bk = self._bucket(len(t), len(q))
            if bk is not None:
                groups.setdefault(bk, []).append(i)
        for (T, Wd), idxs in groups.items():
            B = self.shape_b[T]
            handles = [(idxs[cs : cs + B], self.dispatch_jobs(
                [pairs[i] for i in idxs[cs : cs + B]], T, Wd))
                for cs in range(0, len(idxs), B)]
            for chunk, h in handles:
                for i, d in zip(chunk, self.fetch(h)):
                    results[i] = int(d)
        return results
