#!/usr/bin/env python3
"""Drive the vacmap_tpu_torch paths (mode H and asm) once on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --genome-layout [--other DIR]

The second form runs phases 1 to 3 and the genome layout phase (6b)
alone; with --other it then maps the layout's reads with DIR's executor
(DIR a checkout, e.g. the parent commit unpacked with `git archive`) on
the same .vmi and prints its chain stats line.

Phases (each prints one result line; any failure exits non-zero before
the final line):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds csrc/*.cu into build/vacmap_tpu_torch/ (one
     compiler process per source, all started together), and g++ builds
     the package's host C++ library beside them;
  3. data: the benchmark's 100 Mb genome (tandem arrays, a segmental
     duplication; seed 20260816), its first 256 reads of 20 kb at 5%
     ONT-like error (1/3 plain, 1/3 mid-read inversion, 1/3 3 kb
     deletion) and 16 more with a 120-250 bp deletion;
  4. kernels: every kernel against its plain PyTorch version on the card
     at main-path shapes (chain S within 1e-3 and P agreement >= 0.999;
     fill planes and scan op streams byte-identical); the chain kernel
     at four large batches, then at the executor's small ones (mismatch
     B = 8 at N = 8192, fine B = 16 and B = 8 at N = 2048: few reads,
     each spread over a thread block cluster) and with the refund
     ledger, three of these shapes also at every cluster size (1, 2, 4,
     8 CTAs a read: same bits, the times printed); the warm-start
     chain kernel at B = 1 with an unsorted frontier (frozen rows exact)
     at N = 4096 (phase 6's 2 Mb contig gives it 100 kb blocks of about
     2,800 anchors, co-diagonal seeds merged, and a frontier of a few),
     cold (no frontier) at N = 16,384 (phase 6's 480 kb contig), at
     N = 32,768 (a block of repeats or of diverged sequence, whose seeds
     do not merge), and at B = 3 behind ragged frontiers with one
     problem not sorted by barrier (the kernel takes it row by row);
     the three fill kernels at B = 256 and N (or T) = 256
     and 512, each also at the executor's launch size (B = 16 banded,
     B = EXEC_FULL_B full-width);
     then 2050
     realistic fill jobs against the host aligner's CIGARs, through
     TorchFillAligner and through the in-process fill service
     (AsyncFillAligner) on its default route and on the scan route
     (VACMAP_TPU_FILL_SCAN=1); the Myers edit-distance kernel at its three
     buckets' full widths (genome spans against copies at 5% and 30%
     error, length ratios to 1.4, some with an N), then at the divergence
     filter's launch size (B = 3, texts near T) at each bucket, against
     its plain version on the card and, on the pairs without N, against
     the native Myers, all exactly equal; the banded affine DP
     (csrc/affine_band.cu) against its plain version, all six outputs
     equal and the plane byte for byte, in the global mode at B = 64 T =
     512 W = 128 and T = 4096 W = 256 and the mapping step's B = 16 T =
     128 W = 32, and in the extension mode (the edge extension's scores,
     z-drop 50) at B = 64 T = 8192 and 32,768 W = 512, on genome pairs
     with ragged lengths, |q - t| >= W and queries that turn unrelated
     (the pair drops), and on band_edge_batches at each band width (the
     global, extension and zero-gap modes); then
     ops.affine_batch.BatchAligner on the card in
     both modes on 226 and 184 fill_pairs of up to 4,600 and 8,192 bases
     (global pairs the band or the buckets cannot hold go to the host
     align2p, as in the reference) against the same groups through the
     plain version: equal results, and every global CIGAR's walked score
     equal to the host align2p's; then 1,780 edit jobs through
     the service's edit kind on both transports (in this process, and a
     service process of its own behind a FillClient): every routed
     distance equal to the native one, exactly the oversized,
     empty-sided and N pairs answered None;
  5. end to end: the port's executor (--backend jax) maps the reads in
     this process; then three CLI processes of their own, each timed
     from its start to its exit: the port's host path (4 fork
     workers, host fills), the port's executor, and the port's default
     deployment (-t 4 fork workers sharing one CUDA fill service
     process, --device-fills on, service stats from
     VACMAP_TPU_FILL_STATS).  Every read must align, >= 99% of reads
     must have the host path's records (SAM columns 1-6) in both port
     deployments, the service must have served jobs, and every kernel of
     a path must have launched on it.  Each deployment's service stats
     line gives the share of fill jobs the kernels answered.  The executor
     and the fork pool run once more with VACMAP_TPU_EDIT_DEVICE=1 (the
     divergence filter's spans go to the Myers kernel through the
     service's edit kind): same record check, the edit counters printed,
     and the Myers kernel must have launched on the executor, whose every
     read asks for distances (the fork pool asks only for reads that found
     the service at its cap, and then mostly finds the gate shut).  Mode
     R (the global chain's refund variant) runs as two processes of its
     own, the port's host path and the executor on the card: >= 99% of
     reads with equal records, and the refund chain kernel launched (the
     executor's chain stats line counts it).  Last,
     ``python -m vacmap_tpu_torch.prewarm --all`` runs as a process of its
     own and must exit 0.
  6. asm: one contig of 2 Mb cut from the genome with 0.3% divergence,
     a 2.5 kb deletion and a 5 kb inversion (the streaming chain: about
     20 round-1 blocks of 100 kb) and one of 480 kb with 6% divergence
     (a diverged haplotype or a related species; the per-read path,
     more than 8192 anchors after co-diagonal seeds merge), mapped by `-mode asm --backend jax --device
     cuda` and by the port's host path `-mode asm --backend numpy`, each
     a process of its own.  The SAM records must be equal, every round-1
     block must have been chained by the warm kernel (none declined for
     size or coordinates), and the kernel must have launched; the
     stats line splits the stream chain's device calls into set-up,
     preparation and packing, copies and kernel.  Then, in this process,
     one read's anchors with 2^31 added to the reference coordinate (the
     kernels take them renumbered, ops.chain.device_coords): as a
     round-1 block the card's stream backend chains them and the
     streaming chain equals the native DP's, and the executor's device
     chain gives the shifted read the read's own S and P bit for bit; a
     copy that cannot fit even renumbered is declined as "coords";
  6b. genome layout: a reference laid out like a human one past 2^31 --
     chrA (20 Mb, a copy of the 100 Mb genome's start), a spacer of N,
     and the genome as chrB from 2^31 + 1 Mb on -- indexed once in this
     process into a .vmi that every CLI takes.  Phase 5's reads (all
     past 2^31) and 32 more from chrB's copied part (anchors on both
     sides of 2^31) are mapped by the executor on the card and by the
     host path, a 2 Mb contig from the copied part by `-mode asm` on the
     card and on the host path, each a process of its own.  Every read
     aligned, records (SAM columns 1-6) equal to the host path's for
     >= 99% of reads and for every read from the copied part, the asm
     records equal with every round-1 block chained by the warm kernel,
     no read, job or block declined for coordinates, and the executor's
     global chain on the card for every read (the `executor chain device
     stats` line's counts by cause);
  7. multi-process: two CLI processes of the port's executor started
     together on phase 5's corpus, `--backend jax --device cuda
     --coordinator 127.0.0.1:<free port> --num-processes 2 --process-id
     {0,1}` (a gloo group, both on the one card): both exit 0, process 0
     merges the parts into one SAM with one @HD and one @PG, no part file
     left, every read in it exactly once and aligned, records equal to the
     host path's for >= 99% of reads; the pair's wall time (start to the
     last exit) beside phase 5's one-process executor; launches from each
     process's chain stats log line and fill service stats line.
  8. start-up: four processes of their own, each timed from its start to
     its exit with a recorder of torch imports in it (TORCH_RECORDER):
     `import torch` alone, the port's host path, its asm host path (`-mode
     asm` on phase 6's contigs, the default --backend) and the fork pool
     with --device-fills on.  The host path and the asm host path must
     import torch in no process, the fork pool only in its fill service's
     process (not in the parent or its workers);
  9. mesh: parallel/mesh.ShardedChainStep over make_mesh() (every visible
     card) and over [cuda:0, cuda:0] (two parts, each on a stream of its
     own, on one card) at phase 4's global B = 64, fine B = 16 and refund
     B = 16 shapes (N = 2048): S and P bit-equal to one unsplit launch,
     the accepted count equal; entry.dryrun_multichip on every visible
     card; ShardedMappingStep over [cuda:0, cuda:0] against [cuda:0] with
     byte-equal outputs (the chains and the banded affine DP at W = 32,
     its best also equal to the plain version's; chain_dp and affine_band
     must launch); each step's wall time per call (copies, launches,
     read-back) beside the unsplit call's.
  10. entry: vacmap_tpu_torch.entry.entry()'s fn(*args) on the card against
     the plain version on the CPU (S within 1e-3, P agreement >= 0.999).
Launch counts are set to 0 just before each path and read just after.
The fill kernels' counts of both deployments come from their service's
stats line, which counts from the moment the service is ready, so the
prewarm launches are not in them.  Kernel times
are device time per call (CUDA events around calls queued behind a GPU
sleep, so no host work is in the window); "wrapper" is the stream time
per call of back-to-back wrapper calls, host work included, and "plain"
the stream time of one call of the plain PyTorch version.  "bound" is
the least time the card could take for the same work: the larger of the
operations these inputs need over 67 TFLOP/s (the H100's float32 rate
outside the tensor cores; integer operations are counted at that rate
too) and the bytes (each input read once, each output written once) over
3.35 TB/s.  A chain DP's operations are its candidate pairs (j < n_valid
with an earlier barrier than i, counted from the inputs) at 80 operations
a pair; a fill's are its cells (t_len x q_len, or t_len x 128 band lanes)
at 30 operations a cell; the banded affine DP's are its band cells (T x
W in the global mode; in the extension mode rows up to t_len, or for a
pair that drops up to its best row, a lower bound) at the reference
step's own count, OPS_PER_BAND_CELL; an edit distance's are its text
columns times its pattern's 64-bit words at 29 64-bit integer operations
a word and column (OPS_PER_WORD_STEP: the recurrence's own count, the
same whatever kernel computes it).  No single PyTorch call computes the chain DP, the
affine fills with their tracebacks or an edit distance, so "library" is
null.  The line
before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.  Exits non-zero, with no result, when no
CUDA card is visible or the package is not beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20260816
GENOME_LEN = 100_000_000
N_READS = 256
N_DEL_READS = 16
READ_LEN = 20_000
ERR = 0.05
CHAIN_ATOL = 1e-3
CHAIN_P_MIN = 0.999
E2E_AGREE_MIN = 0.99
_BASES = np.frombuffer(b"ACGT", np.uint8)
ASM_BIG, ASM_DIV = 2_000_000, 0.003
ASM_SMALL, ASM_SMALL_DIV = 480_000, 0.06
# the genome layout: chrA (chrB's first LAYOUT_A bases), a spacer of N,
# then chrB (the 100 Mb genome) from LAYOUT_B_START on, past 2^31
LAYOUT_A = 20_000_000
LAYOUT_B_START = 2**31 + 1_000_000
N_DUP_READS = 32
LAYOUT_ONLY = "--genome-layout"  # this script's genome layout phase alone
PEAK_OPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3
OPS_PER_PAIR = 80     # one pair score of the chain DP (csrc/chain_pair.cuh)
OPS_PER_CELL = 30     # one cell of the two-piece affine fill
# one band cell of ops/affine_jax.py's step (:85-156), counted as written:
# column and masks 7, clipped query read 4, substitution 2, diagonal 1,
# E1 and E2 4 each, H0 with column 0 4, okc 1, F1 and F2 7 each (select,
# two products, add, cummax, two subtracts), H 5, argmax's select and
# compare 2 (48); in the global mode also the op (5 compares, 5 selects)
# and the four flag bits (4 each): 74
OPS_PER_BAND_CELL = {True: 74, False: 48}
# the edge extension's scores and z-drop (vacmap_tpu_torch/pipeline/
# extend.py::_EXT_KW), for the extension mode
EXT_KW = dict(match=2, mismatch=-4, o1=4, e1=4, o2=4, e2=4, zdrop=50)
# one 64-bit pattern word of Myers' recurrence in one text column: Eq
# and X, the add with its carry in and out (8), Xh, Ph, Mh and the score
# bit (11), the two shifts with their bits in, Xv, Pv, Mv (10)
OPS_PER_WORD_STEP = 29
EXEC_FULL_B = 4       # the executor's full-width launches (profile_port.py)
EDIT_CHILD = "--edit-transport-child"  # this script's own child mode
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]
# a preamble for ``python -c``: every process of the run (forked children
# inherit the finder) that imports torch appends "<pid> <process name>"
# to $VACMAP_TORCH_LOG when the import starts (tests/test_torch_startup.py
# uses it too)
TORCH_RECORDER = """\
import os as _os, sys as _sys


class _TorchImports:
    def find_spec(self, name, path=None, target=None):
        if name == "torch":
            import multiprocessing as _mp

            with open(_os.environ["VACMAP_TORCH_LOG"], "a") as _f:
                _f.write(f"{_os.getpid()} {_mp.current_process().name}\\n")
        return None


_sys.meta_path.insert(0, _TorchImports())
"""


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# the benchmark corpus (same generator and seed as bench.py)
# ---------------------------------------------------------------------------


def make_genome_codes(rng, n):
    g = rng.integers(0, 4, n, dtype=np.uint8)
    # tandem-repeat arrays: 200 sites, 300-800 bp unit x 8-20 copies
    for _ in range(200):
        unit = rng.integers(0, 4, int(rng.integers(300, 800)), dtype=np.uint8)
        copies = int(rng.integers(8, 20))
        arr = np.tile(unit, copies)
        st = int(rng.integers(0, n - len(arr)))
        g[st : st + len(arr)] = arr
    # segmental duplication: one 50 kb block copied twice elsewhere
    st = int(rng.integers(0, n - 50_000))
    block = g[st : st + 50_000].copy()
    for _ in range(2):
        dst = int(rng.integers(0, n - 50_000))
        g[dst : dst + 50_000] = block
    return g


def mutate_codes(rng, codes, err):
    """ONT-like errors: ~40% mismatch, 30% ins, 30% del."""
    n = len(codes)
    r = rng.random(n)
    sub = r < err * 0.4
    ins = (r >= err * 0.4) & (r < err * 0.7)
    dele = (r >= err * 0.7) & (r < err)
    out = codes.copy()
    out[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.uint8)
    rep = np.ones(n, np.int64)
    rep[ins] = 2
    rep[dele] = 0
    expanded = np.repeat(out, rep)
    if ins.any():
        pos = np.cumsum(rep) - 1
        ins_slots = pos[ins]
        expanded[ins_slots] = rng.integers(0, 4, len(ins_slots), dtype=np.uint8)
    return expanded


def revcomp_codes(c):
    return (3 - c)[::-1]


def make_corpus():
    rng = np.random.default_rng(SEED)
    gcodes = make_genome_codes(rng, GENOME_LEN)
    reads = []
    for i in range(N_READS):
        st = int(rng.integers(0, GENOME_LEN - READ_LEN - 4000))
        frag = gcodes[st : st + READ_LEN].copy()
        kind = i % 3
        if kind == 1:
            a, b = READ_LEN // 3, 2 * READ_LEN // 3
            frag[a:b] = revcomp_codes(frag[a:b])
        elif kind == 2:
            a = READ_LEN // 2
            frag = np.concatenate(
                [frag[:a], gcodes[st + a + 3000 : st + READ_LEN + 3000]])
        reads.append((f"read_{i}", mutate_codes(rng, frag, ERR)))
    # a fourth class beside bench.py's mix: a mid-read 120-250 bp deletion,
    # whose fill job (|dq| > 95) takes the full-width kernel
    for i in range(N_DEL_READS):
        st = int(rng.integers(0, GENOME_LEN - READ_LEN - 4000))
        a, k = READ_LEN // 2, int(rng.integers(120, 251))
        frag = np.concatenate([gcodes[st : st + a],
                               gcodes[st + a + k : st + READ_LEN + k]])
        reads.append((f"del_read_{i}", mutate_codes(rng, frag, ERR)))
    return gcodes, reads


def write_fasta(path, records, width=80):
    with open(path, "wb") as f:
        for name, codes in records:
            f.write(b">" + name.encode() + b"\n")
            s = _BASES[codes]
            n_full = len(s) // width
            body = np.empty((n_full, width + 1), np.uint8)
            body[:, :width] = s[: n_full * width].reshape(n_full, width)
            body[:, width] = ord("\n")
            f.write(body.tobytes())
            if len(s) % width:
                f.write(s[n_full * width :].tobytes() + b"\n")


# ---------------------------------------------------------------------------
# kernel inputs at main-path shapes
# ---------------------------------------------------------------------------


def sv_anchors(rng, n, local):
    """n barrier-sorted anchors of an SV-bearing read: a forward block, an
    inverted block, a forward block past a 3 kb deletion, 10% noise."""
    n_noise = n // 10
    n_sig = n - n_noise
    read_len = 5 * n_sig + 100
    r = np.sort(rng.choice(read_len - 60, n_sig, replace=False))
    ref0 = int(rng.integers(1_000_000, 90_000_000))
    a, b = read_len // 3, 2 * read_len // 3
    y = ref0 + r + rng.integers(-3, 4, n_sig)
    strand = np.ones(n_sig, np.int64)
    inv = (r >= a) & (r < b)
    y[inv] = ref0 + a + (b - r[inv])
    strand[inv] = -1
    y[r >= b] += 3000
    ln = rng.integers(15, 40, n_sig) if not local else rng.integers(9, 20, n_sig)
    noise = np.stack([
        rng.integers(0, read_len, n_noise),
        rng.integers(0, 100_000_000, n_noise),
        rng.choice([-1, 1], n_noise),
        rng.integers(9, 20, n_noise),
    ], axis=1)
    A = np.concatenate([np.stack([r, y, strand, ln], axis=1), noise])
    key = A[:, 0] + (A[:, 3] if local else 0)
    return A[np.argsort(key, kind="stable")].astype(np.int64)


def fill_pairs(rng, gcodes, n, lo, hi, err=0.05, big_indel=0.0,
               random_frac=0.0, n_frac=0.0):
    """Realistic fill jobs: a reference window and its ONT-like read copy,
    some with a large insertion/deletion, some unrelated (adversarial),
    some with an ambiguous base (code 4)."""
    pairs = []
    while len(pairs) < n:
        L = int(rng.integers(lo, hi + 1))
        st = int(rng.integers(0, len(gcodes) - L))
        t = gcodes[st : st + L].copy()
        if rng.random() < random_frac:
            q = rng.integers(0, 4, int(rng.integers(max(1, L - 60), L + 60)),
                             dtype=np.uint8)
        else:
            q = mutate_codes(rng, t, err)
            if rng.random() < big_indel:
                k = int(rng.integers(96, 200))
                p = int(rng.integers(0, len(q)))
                if rng.random() < 0.5:
                    q = np.concatenate(
                        [q[:p], rng.integers(0, 4, k, dtype=np.uint8), q[p:]])
                else:
                    t = np.concatenate(
                        [t[:p], rng.integers(0, 4, k, dtype=np.uint8), t[p:]])
        if rng.random() < n_frac and len(q) > 2:
            q = q.copy()
            q[int(rng.integers(0, len(q)))] = 4
        # both ends stay anchored (no truncation), as between two anchors
        if not 0 < len(t) <= hi or not 0 < len(q) <= hi:
            continue
        pairs.append((t.astype(np.uint8), q.astype(np.uint8)))
    return pairs


def band_pairs(rng, gcodes, B, T, W, ext):
    """B pairs for one affine_band launch of T rows: a genome span of T / 2
    to T bases and its ONT-like copy; pair 3 of 7 bases (ragged lengths);
    every fourth query cut W to W + 20 bases shorter than its target
    (|q - t| >= W, beyond the band); ``ext``: every other query unrelated
    from a random point on, so that the extension drops there."""
    pairs = []
    for b in range(B):
        L = 7 if b == 3 else int(rng.integers(T // 2, T + 1))
        st = int(rng.integers(0, len(gcodes) - L))
        t = gcodes[st : st + L].copy()
        q = mutate_codes(rng, t, ERR)[:T]
        if b % 4 == 1:
            q = q[: max(1, L - W - int(rng.integers(0, 21)))]
        if ext and b % 2 == 0:
            p = int(rng.integers(len(q) // 4, 3 * len(q) // 4 + 1))
            q = np.concatenate([q[:p], rng.integers(0, 4, len(q) - p,
                                                    dtype=np.uint8)])
        pairs.append((t, q))
    return pairs


# the banded affine DP's edge batches: a target of at most EDGE_T bases
EDGE_T = 160
EDGE_ZDROP = 20
# zero gap costs: H never falls along a row or a column, so equal maxima
# stand at several lanes of a row and in several rows
ZERO_GAPS = dict(o1=0, e1=0, o2=0, e2=0)


def band_edge_batches(W, seed=17):
    """The banded affine DP's edge cases at band width W, as {mode: (x,
    kw, roles)}: x = (targets (B, EDGE_T), queries (B, EDGE_T + W + 32),
    t_len, q_len) numpy arrays padded with code 4, kw the call's
    keywords, roles {case: pair index}.  Cases: t_len = q_len = 1 (match
    and mismatch); a query W + 10 longer than its target (|q - t| >= W:
    the band misses the end cell), and where W < EDGE_T also one that
    much shorter; a 5 x 7 pair (dlo clamped at -t_len); an all-code-4
    target; a mutated copy, an identical pair (never drops) and an
    unrelated one (drops at its first rows).  Modes: "global" (default
    scores), "extension" (EXT_KW's scores, z-drop EDGE_ZDROP) and "ties"
    (global, ZERO_GAPS)."""
    rng = np.random.default_rng(seed + W)
    T = EDGE_T
    Q = T + W + 32
    rand = lambda n: rng.integers(0, 4, n, dtype=np.uint8)  # noqa: E731
    t_copy = rand(150)
    t_far = rand(100)
    t_same = rand(T)
    pairs = {
        "one": (np.array([0], np.uint8), np.array([0], np.uint8)),
        "one_mismatch": (np.array([1], np.uint8), np.array([2], np.uint8)),
        "far_long_query": (t_far, np.concatenate(
            [mutate_codes(rng, t_far, ERR), rand(W + 10)])[: 100 + W + 10]),
        "clamp": (rand(5), rand(7)),
        "all_n_target": (np.full(90, 4, np.uint8), rand(90)),
        "copy": (t_copy, mutate_codes(rng, t_copy, 0.08)[:T]),
        "same": (t_same, t_same.copy()),
        "unrelated": (rand(T), rand(T)),
    }
    if W + 5 < T:
        t = rand(T)
        pairs["far_short_query"] = (t, t[: T - W - 5].copy())
    roles = {name: b for b, name in enumerate(pairs)}
    B = len(pairs)
    x = (np.full((B, T), 4, np.uint8), np.full((B, Q), 4, np.uint8),
         np.zeros(B, np.int32), np.zeros(B, np.int32))
    for b, (t, q) in enumerate(pairs.values()):
        x[0][b, : len(t)], x[1][b, : len(q)] = t, q
        x[2][b], x[3][b] = len(t), len(q)
    return {"global": (x, dict(W=W, glob=True, zdrop=-1), roles),
            "extension": (x, dict(EXT_KW, W=W, glob=False, zdrop=EDGE_ZDROP),
                          roles),
            "ties": (x, dict(ZERO_GAPS, W=W, glob=True, zdrop=-1), roles)}


def cigar_score(cigar, t, q):
    """The two-piece affine score of a global CIGAR (default scores), or
    None when it does not consume t and q whole."""
    import re

    ti = qi = score = 0
    for m in re.finditer(r"(\d+)([MID=X])", cigar):
        n, op = int(m.group(1)), m.group(2)
        if op in "M=X":
            score += int(np.where(t[ti : ti + n] == q[qi : qi + n], 2, -4).sum())
            ti, qi = ti + n, qi + n
        else:
            score -= min(4 + 2 * n, 24 + n)
            ti, qi = (ti + n, qi) if op == "D" else (ti, qi + n)
    return score if (ti, qi) == (len(t), len(q)) else None


def myers_pairs(rng, gcodes, T, limit, B):
    """B edit jobs of one bucket (text <= T, pattern <= limit bases): a
    genome span and its copy at 5% or 30% ONT-like error; every fourth
    pattern grown by up to 0.4 n of unrelated bases, every fourth text cut
    to n / 1.4; every sixth pair with an N; the first text of exactly T
    bases, then a pattern of exactly ``limit`` bases, a one-base pattern, a
    one-base text, and four texts under T / 2 (the plain version's share
    at the largest bucket)."""
    pairs = []
    for i in range(B):
        n = T if i == 0 else int(rng.integers(
            T // 4, T // 2) if 4 <= i < 8 else rng.integers(T // 2, T + 1))
        st = int(rng.integers(0, len(gcodes) - n))
        t = gcodes[st : st + n].copy()
        q = mutate_codes(rng, t, 0.30 if i % 2 else 0.05)
        if i % 4 == 0:
            grow = int(rng.integers(0, int(0.4 * n) + 1))
            q = np.concatenate([q, rng.integers(0, 4, grow, dtype=np.uint8)])
        elif i % 4 == 2:
            t = t[: int(n / 1.4)]
        if i % 6 == 5:
            (t if i % 12 == 5 else q)[int(rng.integers(0, min(len(t), len(q))))] = 4
        if i == 1:
            q = np.resize(q, limit)
        elif i == 2:
            q = q[:1]
        elif i == 3:
            t = t[:1]
        pairs.append((t, q[:limit]))
    return pairs


def edit_service_pairs():
    """(pairs, routable) for the edit-service phase, from the seed alone
    (the child process makes the same): 1,500 pairs for the small bucket,
    200 for the middle one, 24 for the large one, then 8 oversized, 8 with
    an empty side and 40 with an N, shuffled."""
    rng = np.random.default_rng(SEED + 3)
    pairs, routable = [], []

    def pair(lo, hi):
        t = rng.integers(0, 4, int(rng.integers(lo, hi + 1)), dtype=np.uint8)
        q = mutate_codes(rng, t, 0.30 if rng.random() < 0.3 else 0.05)
        if rng.random() < 0.25:
            q = np.concatenate([q, rng.integers(
                0, 4, int(rng.integers(0, int(0.4 * len(t)) + 1)),
                dtype=np.uint8)])
        return t, q

    for lo, hi, k in ((20, 2048, 1500), (2049, 8192, 200), (8193, 20480, 24)):
        pairs += [pair(lo, hi) for _ in range(k)]
    routable += [True] * len(pairs)
    for i in range(8):  # over every bucket: the text, or the pattern
        t, q = pair(15_000, 20_000)
        pairs.append((np.resize(t, 20_481), q) if i % 2 else
                     (t, np.resize(q, 28_673)))
    for i in range(8):
        t, q = pair(20, 500)
        pairs.append((t[:0], q) if i % 2 else (t, q[:0]))
    for i in range(40):
        t, q = pair(20, 3000)
        (t if i % 2 else q)[int(rng.integers(0, min(len(t), len(q))))] = 4
        pairs.append((t, q))
    routable += [False] * (len(pairs) - len(routable))
    order = rng.permutation(len(pairs))
    return [pairs[i] for i in order], [routable[i] for i in order]


def edit_through(client, pairs, chunk=64):
    """The pairs through ``client.edit_batch`` in requests of ``chunk``."""
    got = []
    for c0 in range(0, len(pairs), chunk):
        got += client.edit_batch(pairs[c0 : c0 + chunk])
    return got


def edit_transport_child(out_path) -> int:
    """Child mode: the edit-service pairs through a fill service process
    of its own and a FillClient (this process never sets CUDA up, so the
    forked service can), results as JSON to ``out_path``."""
    from vacmap_tpu_torch.parallel import fill_service

    pairs, _ = edit_service_pairs()
    handle = fill_service.start_fill_server(1, "cuda", force=True)
    try:
        t0 = time.perf_counter()
        got = edit_through(handle.client(0), pairs)
        dt = time.perf_counter() - t0
    finally:
        msg = handle.stop()
    with open(out_path, "w") as f:
        json.dump({"dists": got, "seconds": dt, "stop": msg,
                   "routes": list(handle.edit_routes[:])}, f)
    return 0 if msg is None else 1


def bound(ops, nbytes):
    """(least ms the card could take, which resource sets it)."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def chain_pairs(anchors, n_valid, n_warm, local):
    """Candidate pairs a chain DP needs for these inputs: for every
    scored row i, the rows j < n_valid with barrier_j < barrier_i."""
    total = 0
    for b in range(len(n_valid)):
        a = anchors[b, : n_valid[b]].astype(np.int64)
        bar = a[:, 0] + (a[:, 3] if local else 0)
        total += int(np.searchsorted(np.sort(bar), bar[n_warm[b]:],
                                     side="left").sum())
    return total


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def sv_contig(gcodes, st):
    """ASM_BIG bases of the genome from st on, less a 2.5 kb deletion at
    700 kb, with a 5 kb inversion at 1.3 Mb."""
    big = gcodes[st : st + ASM_BIG + 2500].copy()
    big = np.concatenate([big[:700_000], big[702_500:]])
    big[1_300_000:1_305_000] = revcomp_codes(big[1_300_000:1_305_000])
    return big


def asm_contigs(rng, gcodes):
    """Two assembly contigs cut from the genome: 2 Mb with 0.3%
    divergence, a 2.5 kb deletion and a 5 kb inversion; 480 kb with 6%
    divergence, which leaves more than 8192 anchors (at assembly-like
    divergence co-diagonal seeds merge into a few thousand)."""
    big = sv_contig(gcodes,
                    int(rng.integers(0, len(gcodes) - ASM_BIG - 10_000)))
    st2 = int(rng.integers(0, len(gcodes) - ASM_SMALL))
    small = gcodes[st2 : st2 + ASM_SMALL]
    return [("asm_contig_2mb", mutate_codes(rng, big, ASM_DIV)),
            ("asm_contig_480kb", mutate_codes(rng, small, ASM_SMALL_DIV))]


def log_stats(stderr, tag):
    """A CLI's ``<tag>: k=v ...`` log line (its last) as {k: number}, or
    None."""
    lines = [ln for ln in stderr.splitlines() if f"{tag}:" in ln]
    if not lines:
        return None
    kv = lines[-1].split(f"{tag}:", 1)[1].split()
    return {k: float(v) for k, v in (x.split("=", 1) for x in kv)}


def mapping_seconds(stderr):
    """The seconds a CLI process logged for its mapping loop alone (its
    "Done:" line: after start-up and the index load)."""
    for line in stderr.splitlines():
        if " Done: " in line and " in " in line:
            return float(line.rsplit(" in ", 1)[1].split("s", 1)[0])
    return float("nan")


def padded(pairs, N):
    B = len(pairs)
    tT = np.full((B, N), 4, np.uint8)
    tQ = np.full((B, N), 4, np.uint8)
    lens = np.zeros((B, 2), np.int32)
    for b, (t, q) in enumerate(pairs):
        tT[b, : len(t)] = t
        tQ[b, : len(q)] = q
        lens[b] = (len(t), len(q))
    return tT, tQ, lens


def wall_ms(torch, fn, reps):
    """Mean time per call of fn() on the stream (CUDA events around reps
    back-to-back calls: device time plus the host work between launches),
    and fn's last result."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        out = fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps, out


def device_ms(torch, fn, reps):
    """Device time per call of fn(): reps calls queued behind a GPU sleep
    (about 25 ms), so the wrappers' host work overlaps the sleep and the
    CUDA events around the calls time the kernels alone."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def cli_process(args, env, cwd=None):
    """Run ``python <args>`` as a process of its own; returns (wall s,
    result).  The window is the process's whole life: interpreter start,
    imports, device set-up, index load, mapping, SAM closed."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, timeout=900, env=env, cwd=cwd)
    return time.perf_counter() - t0, p


def read_stats(path):
    """The fill service's stats line as {key: value}, its launches as
    {kernel: count}."""
    stats = dict(kv.split("=", 1) for kv in open(path).read().split())
    launches = {k: int(v) for k, v in
                (kv.split(":") for kv in stats["launches"].split(","))}
    return stats, launches


def sam_records(path):
    """{read name: sorted SAM columns 1-6 of its records}."""
    recs = {}
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            cols = line.rstrip("\n").split("\t")
            recs.setdefault(cols[0], []).append(tuple(cols[:6]))
    return {k: sorted(v) for k, v in recs.items()}


# the start-up phase's processes: (name, CLI argv or None for a bare
# ``import torch``, the process names that must import torch, in this tree)
STARTUP = (
    ("import torch", None, ["MainProcess"]),
    ("host path", ["-mode", "H", "--backend", "numpy", "--device-fills",
                   "off"], []),
    ("asm host path", ["-mode", "asm"], []),
    ("fork pool", ["-mode", "H", "-t", "4", "--device", "cuda",
                   "--device-fills", "on"], ["fill-service"]),
)


def startup_sam(wd, label, name):
    return os.path.join(wd, f"startup {label} {name}.sam".replace(" ", "_"))


def startup_windows(wd, ref, reads_fa, contigs_fa, env, card, trees,
                    runs=1, procs=STARTUP):
    """Start each process of ``procs`` (STARTUP's form) of each tree
    (label, checkout root) as a process of its own, from the tree's root
    (``python -c`` puts the working directory first on the path), in
    turns (the trees' order reversed every other round), with
    TORCH_RECORDER in it; time it from start to exit (cli_process).  The
    read modes map ``reads_fa``, the asm host path ``contigs_fa``, each
    into ``startup_sam(wd, label, name)``.  Each run's line also gives
    its kernel launches: the chain kernel's from the executor's log line,
    the fill kernels' from a fill service's stats line.  Returns
    {(label, name): [(seconds, [names of the processes that imported
    torch])]}."""
    log = os.path.join(wd, "torch_imports.log")
    stats = os.path.join(wd, "startup_fill_stats.txt")
    out = {}
    for r in range(runs):
        for label, root in (trees if r % 2 == 0 else trees[::-1]):
            tenv = dict(env, VACMAP_TORCH_LOG=log, VACMAP_TPU_FILL_STATS=stats,
                        PYTHONPATH=os.pathsep.join(
                            [root] + ([os.environ["PYTHONPATH"]]
                                      if os.environ.get("PYTHONPATH") else [])))
            for name, argv, _ in procs:
                code = "import torch\n"
                if argv is not None:
                    rd = contigs_fa if "asm" in argv else reads_fa
                    argv = ["-ref", ref, "-read", rd, *argv, "--force", "-o",
                            startup_sam(wd, label, name)]
                    code = ("import runpy, sys\n"
                            f"sys.argv = ['vacmap-tpu-torch', *{argv!r}]\n"
                            "runpy.run_module('vacmap_tpu_torch.cli', "
                            "run_name='__main__')\n")
                for f in (log, stats):
                    if os.path.exists(f):
                        os.remove(f)
                dt, p = cli_process(["-c", TORCH_RECORDER + code], tenv,
                                    cwd=root)
                if p.returncode != 0:
                    fail(f"start-up {label} {name} exited {p.returncode}: "
                         f"{p.stderr[-3000:]}")
                loaded = []
                if os.path.exists(log):
                    with open(log) as f:
                        loaded = [ln.split(" ", 1)[1].strip() for ln in f]
                ex = log_stats(p.stderr, "executor chain device stats")
                launches = {"chain_dp": int(ex["chain_launches"])} if ex else {}
                if os.path.exists(stats):
                    launches.update(read_stats(stats)[1])
                out.setdefault((label, name), []).append((dt, loaded))
                say(f"start-up {label}: {name} {dt:.3f} s, torch imported by "
                    f"{loaded or 'no process'}"
                    + (f", launches {launches}" if launches else "")
                    + f" [{card}]")
    return out


def multi_process_phase(wd, common, env, host_recs, names, one_s, card):
    """Two CLI processes of the executor, one gloo group on a free port,
    started together; returns their kernel launches summed."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(wd, "multi_process.sam")
    err_paths = [os.path.join(wd, f"multi_process_{pid}.log") for pid in (0, 1)]
    procs = []
    t0 = time.perf_counter()
    try:
        for pid in (0, 1):
            penv = dict(env, VACMAP_TPU_FILL_STATS=os.path.join(
                wd, f"multi_process_{pid}_fill_stats.txt"))
            with open(err_paths[pid], "w") as log_f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "vacmap_tpu_torch.cli", *common,
                     "--backend", "jax", "--device", "cuda", "-o", out,
                     "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                     "2", "--process-id", str(pid)],
                    env=penv, stdout=subprocess.DEVNULL, stderr=log_f))
        for p in procs:
            p.wait(timeout=900)
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errs = [open(path).read() for path in err_paths]
    for pid, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            fail(f"multi-process: process {pid} exited {p.returncode}: "
                 f"{err[-3000:]}")
        if "joined the gloo group" not in err:
            fail(f"multi-process: process {pid} never joined the group")
    left = [f for f in os.listdir(wd) if ".part" in f]
    if left:
        fail(f"multi-process: part files left after the merge: {left}")
    tags, primaries = [], {}
    with open(out) as f:
        for ln in f:
            cols = ln.split("\t", 2)
            if ln.startswith("@"):
                tags.append(cols[0])
            elif not int(cols[1]) & 0x900:
                primaries[cols[0]] = primaries.get(cols[0], 0) + 1
    recs = sam_records(out)
    same = sum(recs.get(n) == host_recs.get(n) for n in names)
    aligned = sum(any(not int(r[1]) & 4 for r in recs.get(n, []))
                  for n in names)
    launches = {"chain_dp": 0}
    for pid, err in enumerate(errs):
        ex = log_stats(err, "executor chain device stats")
        if ex is None:
            fail(f"multi-process: process {pid} printed no chain stats line")
        launches["chain_dp"] += int(ex["chain_launches"])
        try:
            _, fills = read_stats(os.path.join(
                wd, f"multi_process_{pid}_fill_stats.txt"))
        except (OSError, KeyError, ValueError) as err_:
            fail(f"multi-process: process {pid} wrote no stats line: {err_!r}")
        for k, v in fills.items():
            launches[k] = launches.get(k, 0) + v
    say(f"multi-process (2 executor processes, gloo group, one card): "
        f"exit 0 both; merged SAM {tags.count('@HD')} @HD, "
        f"{tags.count('@PG')} @PG, no part left; {len(primaries)}/"
        f"{len(names)} reads with one primary record each; aligned "
        f"{aligned}/{len(names)}; records equal to the host path for "
        f"{same}/{len(names)} ({same / len(names):.4f}); pair {wall:.3f} s "
        f"start to the last exit, one-process executor {one_s:.3f} s; "
        f"launches {launches} [{card}]")
    if tags.count("@HD") != 1 or tags.count("@PG") != 1:
        fail(f"multi-process: merged header has {tags}")
    if set(primaries) != set(names) or any(v != 1 for v in primaries.values()):
        fail("multi-process: not every read once in the merged SAM: "
             f"{sorted(set(names) - set(primaries))[:10]} missing, "
             f"{[k for k, v in primaries.items() if v != 1][:10]} repeated")
    if aligned != len(names):
        fail(f"multi-process: only {aligned}/{len(names)} reads aligned")
    if same / len(names) < E2E_AGREE_MIN:
        fail(f"multi-process: record agreement {same / len(names):.4f} < "
             f"{E2E_AGREE_MIN}")
    for k in ("chain_dp", "fill_banded"):
        if launches.get(k, 0) <= 0:
            fail(f"multi-process: {k} never launched: {launches}")
    return launches


def coords_phase(dev, index, cfg, read, card):
    """One corpus read's anchors with 2^31 added to every reference
    coordinate (the kernels' anchors are int32; each problem's reference
    column is renumbered, ops.chain.device_coords).  As a round-1 block
    (sorted by read position) the card's stream backend chains it, and
    the streaming chain equals the native DP's; the executor's device
    chain gives the shifted read the result of the read as it is, bit for
    bit.  A copy whose last anchor sits 2^29 read bases on and 2^32
    further on the reference cannot fit even renumbered (one cut gap
    alone passes 2^30): declined as "coords", chained by the native DP."""
    from vacmap_tpu_torch.ops.chain import TorchStreamChainBackend
    from vacmap_tpu_torch.pipeline.asm import stream_chain
    from vacmap_tpu_torch.pipeline.chaining import prepare_read_anchors
    from vacmap_tpu_torch.pipeline.executor import TorchBatchExecutor
    from vacmap_tpu_torch.pipeline.mapper import Mapper

    seq = _BASES[read[1]].tobytes().decode()
    _, A = prepare_read_anchors(index.seeds(seq, check_num=cfg.check_num),
                                len(seq))
    shifted = A.copy()
    shifted[:, 1] += 2**31
    block = shifted[np.argsort(shifted[:, 0], kind="stable")]
    wide = block.copy()
    wide[-1, 0] = 2**29
    wide[-1, 1] += 2**32
    skip, maxdiff, maxgap = cfg.chain_params_global()
    be = TorchStreamChainBackend(dev)
    args = (15, skip, maxdiff, maxgap, "global_nocov", None)
    got = [stream_chain(iter([b]), *args, chain_backend=be)
           for b in (block, wide)]
    want = [stream_chain(iter([b]), *args) for b in (block, wide)]
    ex = TorchBatchExecutor(Mapper(index, cfg), device=dev, device_fills=False)
    res = ex._device_chain([A, shifted], "global", skip, maxdiff, maxgap, 15)
    same = (None not in res
            and np.array_equal(res[0].S.view(np.int64), res[1].S.view(np.int64))
            and np.array_equal(res[0].P, res[1].P))
    say(f"coords at 2^31: a block of {len(block)} anchors ({read[0]}, "
        f"+2^31 on the reference coordinate) and a copy that cannot fit: "
        f"stream backend engaged {be.engaged}, declined {be.declined}; "
        f"streaming chains equal to the native DP's: "
        f"{[g == w for g, w in zip(got, want)]} ({len(got[0])} path "
        f"anchors); executor device chain of [read, shifted read]: "
        f"{['None' if r is None else 'result' for r in res]}, bit-equal "
        f"{same}, declined {ex.declined} [{card}]")
    if be.engaged != 1 or be.declined != {"variant": 0, "size": 0,
                                          "coords": 1}:
        fail(f"coords at 2^31: the stream backend did not chain the block "
             f"and decline only the copy that cannot fit: engaged "
             f"{be.engaged}, declined {be.declined}")
    if got != want or len(got[0]) <= 1:
        fail("coords at 2^31: a streaming chain differs from the native DP")
    if not same or any(ex.declined.values()):
        fail("coords at 2^31: the executor's device chain of the shifted "
             "read is not the read's")


def layout_reads(gcodes, reads):
    """The genome layout's reads: phase 5's, then N_DUP_READS of 20 kb at
    5% error from chrB's first LAYOUT_A bases, which chrA copies."""
    rng = np.random.default_rng(SEED + 14)
    dup = []
    for i in range(N_DUP_READS):
        st = int(rng.integers(0, LAYOUT_A - READ_LEN))
        dup.append((f"dup_read_{i}",
                    mutate_codes(rng, gcodes[st : st + READ_LEN], ERR)))
    return reads + dup


def genome_layout_phase(wd, gcodes, reads, env, card, other=None):
    """A reference laid out like a human one past 2^31: chrA (chrB's first
    LAYOUT_A bases), a spacer of N, chrB (the 100 Mb genome) from
    LAYOUT_B_START on.  Its .vmi is built here once and every CLI takes
    it.  Maps layout_reads with the executor on the card and with the
    host path, then a 2 Mb asm contig cut from chrB's copied part with
    -mode asm on the card and on the host path, each a process of its own.
    Every read aligned; records equal to the host path's for >= 99% of
    reads and for every read from the copied part; the asm records equal
    and every round-1 block chained by the warm kernel; no read, job or
    block declined for coordinates; the executor's global chain took
    every read.  Given ``other`` (a checkout root), its executor then maps
    the same reads on the same .vmi, and its stats line is printed.
    Returns the card processes' launches."""
    from vacmap_tpu_torch.config import AlignerConfig
    from vacmap_tpu_torch.index import ReferenceIndex

    t0 = time.perf_counter()
    contigs = {"chrA": _BASES[gcodes[:LAYOUT_A]].tobytes().decode(),
               "spacer": "N" * (LAYOUT_B_START - LAYOUT_A),
               "chrB": _BASES[gcodes].tobytes().decode()}
    vmi = os.path.join(wd, "layout.vmi")
    index = ReferenceIndex.build(contigs, k=15, w=10)
    index.save(vmi)
    del contigs
    build_s = time.perf_counter() - t0
    lreads = layout_reads(gcodes, reads)
    names = [n for n, _ in lreads]
    # the copied part's reads whose anchors lie on both sides of 2^31
    check_num = AlignerConfig(mode="H").check_num
    across = 0
    for _, codes in lreads[len(reads):]:
        y = index.seeds(_BASES[codes].tobytes().decode(),
                        check_num=check_num)[:, 1]
        across += bool(len(y)) and (y.min() < LAYOUT_A
                                    and y.max() >= LAYOUT_B_START)
    del index
    rds = os.path.join(wd, "layout_reads.fa")
    write_fasta(rds, lreads)
    ctg = os.path.join(wd, "layout_contig.fa")
    rng = np.random.default_rng(SEED + 15)
    big = sv_contig(gcodes,
                    int(rng.integers(0, LAYOUT_A - ASM_BIG - 10_000)))
    write_fasta(ctg, [("layout_contig_2mb", mutate_codes(rng, big, ASM_DIV))])
    out = {k: os.path.join(wd, f"layout_{k}.sam")
           for k in ("executor", "host", "asm_cuda", "asm_host", "other")}
    fill_stats = os.path.join(wd, "layout_fill_stats.txt")
    common = ["-m", "vacmap_tpu_torch.cli", "-ref", vmi]
    runs = {
        "executor": [*common, "-read", rds, "-mode", "H", "--backend", "jax",
                     "--device", "cuda", "-o", out["executor"]],
        "host": [*common, "-read", rds, "-mode", "H", "--backend", "numpy",
                 "--device-fills", "off", "-o", out["host"]],
        "asm_cuda": [*common, "-read", ctg, "-mode", "asm", "--backend",
                     "jax", "--device", "cuda", "-o", out["asm_cuda"]],
        "asm_host": [*common, "-read", ctg, "-mode", "asm", "--backend",
                     "numpy", "-o", out["asm_host"]],
    }
    secs, errs = {}, {}
    for name, argv in runs.items():
        penv = dict(env, VACMAP_TPU_FILL_STATS=fill_stats) \
            if name == "executor" else env
        secs[name], p = cli_process(argv, penv)
        errs[name] = p.stderr
        if p.returncode != 0:
            fail(f"genome layout: {name} CLI process exited {p.returncode}: "
                 f"{p.stderr[-3000:]}")
    ex = log_stats(errs["executor"], "executor chain device stats")
    asm = log_stats(errs["asm_cuda"], "asm chain device stats")
    if ex is None or asm is None:
        fail("genome layout: a card process printed no chain stats line")
    try:
        fills = read_stats(fill_stats)[1]
    except (OSError, KeyError, ValueError) as err:
        fail(f"genome layout: the executor's fill service wrote no stats "
             f"line: {err!r}")
    recs = {k: sam_records(v) for k, v in out.items() if os.path.exists(v)}
    same = [n for n in names if recs["executor"].get(n) == recs["host"].get(n)]
    dup_names = names[len(reads):]
    dup_same = [n for n in dup_names if n in same]
    aligned = sum(any(not int(r[1]) & 4 for r in recs["executor"].get(n, []))
                  for n in names)
    on = {c: sum(r[2] == c for v in recs["host"].values() for r in v)
          for c in ("chrA", "chrB")}
    asm_same = recs["asm_cuda"] == recs["asm_host"] and bool(recs["asm_host"])
    round1 = int(asm["stream_calls"] - asm["declined_variant"])
    declines = {k: int(v) for k, v in ex.items() if "declined" in k}
    declines.update({f"asm_{k}": int(v) for k, v in asm.items()
                     if "declined" in k})
    say(f"genome layout (chrA {LAYOUT_A} bp, N spacer, chrB {GENOME_LEN} bp "
        f"from {LAYOUT_B_START}): .vmi built and saved in this process in "
        f"{build_s:.1f} s; {len(names)} reads ({len(dup_names)} from chrB's "
        f"copied part): executor {secs['executor']:.3f} s, host path "
        f"{secs['host']:.3f} s (one CLI process each, start to exit); "
        f"aligned {aligned}/{len(names)}; records equal to the host path for "
        f"{len(same)}/{len(names)} ({len(same) / len(names):.4f}), of the "
        f"copied part's {len(dup_same)}/{len(dup_names)} ({across} with "
        f"anchors on both sides of 2^31); host records on "
        f"chrA {on['chrA']}, on chrB {on['chrB']}; global chain on the card "
        f"{int(ex['global_chained'])} reads, local and other jobs "
        f"{int(ex['backend_chained'])}; chain_dp launches "
        f"{int(ex['chain_launches'])}, fill launches {fills} [{card}]")
    say(f"genome layout asm (2 Mb contig from chrB's copied part): card "
        f"{secs['asm_cuda']:.3f} s, host path {secs['asm_host']:.3f} s; "
        f"records equal: {asm_same}; round-1 blocks chained by the kernel "
        f"{int(asm['stream_engaged'])}/{round1} ({int(asm['stream_rows'])} "
        f"anchors, {int(asm['stream_max_rows'])} in the largest block); "
        f"warm launches {int(asm['warm_launches'])}, chain_dp "
        f"{int(asm['chain_launches'])}; declines by cause {declines} "
        f"[{card}]")
    if other is not None:
        oenv = dict(env, PYTHONPATH=os.pathsep.join(
            [other] + ([os.environ["PYTHONPATH"]]
                       if os.environ.get("PYTHONPATH") else [])))
        argv = [*runs["executor"][:-1], out["other"]]
        dt, p = cli_process(argv, oenv, cwd=other)
        line = [ln for ln in p.stderr.splitlines()
                if "executor chain device stats" in ln]
        o_recs = sam_records(out["other"]) if p.returncode == 0 else {}
        o_same = sum(o_recs.get(n) == recs["host"].get(n) for n in names)
        say(f"genome layout, {other}'s executor on the same .vmi: exit "
            f"{p.returncode} in {dt:.3f} s; records equal to the host path "
            f"for {o_same}/{len(names)}; "
            f"{line[-1][line[-1].index('executor chain'):] if line else 'no stats line'} "
            f"[{card}]")
    if not across:
        fail("genome layout: no read has anchors on both sides of 2^31")
    if aligned != len(names):
        fail(f"genome layout: only {aligned}/{len(names)} reads aligned")
    if len(same) / len(names) < E2E_AGREE_MIN or dup_same != dup_names:
        fail(f"genome layout: records differ from the host path: "
             f"{[n for n in names if n not in same][:20]}")
    if not asm_same:
        fail("genome layout: the asm records differ from the host path's")
    if any(v for k, v in declines.items() if k.endswith("coords")):
        fail(f"genome layout: declined for coordinates: {declines}")
    if ex["global_chained"] != len(names) or not ex["chain_launches"]:
        fail(f"genome layout: the executor's global chain took "
             f"{int(ex['global_chained'])} of {len(names)} reads")
    if asm["stream_engaged"] != round1 or round1 < ASM_BIG // 100_000:
        fail(f"genome layout: not every round-1 block was chained by the "
             f"kernel: {asm}")
    return {"executor": {"chain_dp": int(ex["chain_launches"]), **fills},
            "asm": {"chain_dp_large": int(asm["warm_launches"]),
                    "chain_dp": int(asm["chain_launches"])}}


def per_call_s(torch, fn, reps):
    """Wall seconds per call of fn() (it synchronizes itself), and fn's
    last result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps, out


def mesh_phase(torch, dev, gcodes, cfg0, card, reset_launches,
               read_launches):
    """ShardedChainStep over every visible card and over two streams of
    cuda:0 against one unsplit launch, the multi-device dry run, and
    ShardedMappingStep split against unsplit; returns the steps'
    launches (the unsplit launches they are held to are left out)."""
    from vacmap_tpu_torch import entry
    from vacmap_tpu_torch.ops import chain
    from vacmap_tpu_torch.parallel import mesh

    rng = np.random.default_rng(SEED + 11)
    skip_g, maxdiff_g, maxgap_g = cfg0.chain_params_global()
    skip_l, maxdiff_l, maxgap_l = cfg0.chain_params_local()
    meshes = {"make_mesh()": mesh.make_mesh(), "[cuda:0, cuda:0]": [dev, dev]}
    steps_launches = {}
    inputs = {}

    def add(launches):
        for k, v in launches.items():
            if v:
                steps_launches[k] = steps_launches.get(k, 0) + v

    for variant, B in (("global", 64), ("fine", 16), ("refund", 16)):
        local = variant == "fine"
        k, skip, md, mg = ((cfg0.local_kmersize, skip_l, maxdiff_l, maxgap_l)
                           if local else (15, skip_g, maxdiff_g, maxgap_g))
        alist = [sv_anchors(rng, int(rng.integers(1025, 2049)), local)
                 for _ in range(B)]
        arrays = chain.prepare_batch(alist, variant, skip, md)
        inputs[variant] = arrays
        kw = dict(kmersize=k, maxdiff=md, maxgap=mg, skipcost=skip,
                  variant=variant)

        def unsplit():
            S, P = chain.chain_scores_batch(*chain.to_device(dev, *arrays),
                                            **kw)
            return S.cpu().numpy(), P.cpu().numpy()

        S0, P0 = unsplit()
        want_acc = int((S0.max(axis=1) > 60.0).sum())
        one_s, _ = per_call_s(torch, unsplit, 5)
        times = []
        for name, devices in meshes.items():
            step = mesh.ShardedChainStep(devices, **kw)
            reset_launches()
            S, P, best, n_acc = step(*arrays)
            torch.cuda.synchronize()
            add(read_launches())
            ok = (np.array_equal(S.view(np.int32), S0.view(np.int32))
                  and np.array_equal(P, P0) and n_acc == want_acc
                  and np.array_equal(best, S0.max(axis=1)))
            if not ok:
                fail(f"mesh: ShardedChainStep {variant} B={B} over {name} "
                     f"differs from the unsplit launch")
            s, _ = per_call_s(torch, lambda: step(*arrays), 5)
            times.append(f"{name} ({len(devices)} parts) {s * 1e3:.3f} ms")
        say(f"mesh chain {variant} B={B} N={arrays[0].shape[1]}: S and P "
            f"bit-equal to one unsplit launch over both device lists, "
            f"accepted {want_acc}; wall per call (copies, launches, "
            f"read-back): unsplit {one_s * 1e3:.3f} ms, "
            + ", ".join(times) + f" [{card}]")

    n_cards = torch.cuda.device_count()
    reset_launches()
    t0 = time.perf_counter()
    try:
        entry.dryrun_multichip(n_cards)
        torch.cuda.synchronize()
    except Exception as err:  # noqa: BLE001
        fail(f"mesh: dryrun_multichip({n_cards}) raised: {err!r}")
    add(read_launches())
    say(f"mesh dryrun_multichip({n_cards}): ok in "
        f"{time.perf_counter() - t0:.3f} s [{card}]")

    # the mapping step: both chains and the banded affine DP (W = 32,
    # T = 128), split in two against one part; its best against the plain
    # version's
    from vacmap_tpu_torch.ops import affine_batch as ab

    g, l = inputs["global"], inputs["fine"]
    B = 16
    T, W = mesh.ShardedMappingStep.fill_len, mesh.ShardedMappingStep.fill_band
    tT, tQ, lens = padded(band_pairs(rng, gcodes, B, T, W, False), T)
    args = (*(a[:B] for a in g), *l, tT, tQ, lens[:, 0].copy(),
            lens[:, 1].copy())
    outs, secs = {}, {}
    for name, devices in (("[cuda:0]", [dev]), ("[cuda:0, cuda:0]", [dev, dev])):
        step = mesh.ShardedMappingStep(devices)
        reset_launches()
        outs[name] = step(*args)
        torch.cuda.synchronize()
        add(read_launches())
        secs[name], _ = per_call_s(torch, lambda: step(*args), 3)
    a, b = outs.values()
    same = all(np.array_equal(np.asarray(x).view(np.uint8),
                              np.asarray(y).view(np.uint8))
               for x, y in zip(a[:5], b[:5])) and a[5] == b[5]
    want = ab.affine_batch_ref(
        *(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
          for x in (tT, tQ, lens[:, 0], lens[:, 1])), W=W)[1].cpu().numpy()
    best_ok = a[4].dtype == np.float32 and np.array_equal(a[4], want)
    say(f"mesh ShardedMappingStep B={B} (global and fine N=2048, banded "
        f"affine T={T} W={W}, {int((np.abs(lens[:, 1] - lens[:, 0]) >= W).sum())}"
        f" pairs with |q - t| >= {W}): outputs byte-equal split in two and "
        f"unsplit: {same}; best equal to the plain version's: {best_ok}; "
        f"mapped {a[5]}; wall per call "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in secs.items())
        + f" [{card}]")
    if not same:
        fail("mesh: ShardedMappingStep split in two differs from one part")
    if not best_ok:
        fail("mesh: ShardedMappingStep's best differs from affine_batch_ref's")
    for k in ("chain_dp", "affine_band"):
        if steps_launches.get(k, 0) <= 0:
            fail(f"mesh: {k} never launched: {steps_launches}")
    return steps_launches


def entry_phase(torch, reset_launches, read_launches):
    """entry()'s function on the card against its plain version on the
    CPU; returns its launches."""
    from vacmap_tpu_torch import entry
    from vacmap_tpu_torch.ops import chain

    fn, args = entry.entry()
    reset_launches()
    S, P = fn(*args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    cpu_args = [a.cpu() for a in args]
    S0, P0 = chain.chain_scores_batch_ref(*cpu_args, **fn.keywords)
    valid = (np.arange(S.shape[1])[None, :]
             < cpu_args[1].numpy()[:, None])
    err = float(np.abs(S.cpu().numpy() - S0.numpy())[valid].max())
    agree = float((P.cpu().numpy() == P0.numpy())[valid].mean())
    ok = err <= CHAIN_ATOL and agree >= CHAIN_P_MIN
    say(f"entry: fn(*args) {tuple(S.shape)} on the card against the plain "
        f"version on the CPU: max|dS|={err:.3g} P agreement={agree:.6f} "
        f"launches {launches} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("entry: the card's chain DP disagrees with its plain version")
    if launches.get("chain_dp", 0) != 1:
        fail(f"entry: chain_dp launched {launches} times, not once")
    return launches


# ---------------------------------------------------------------------------


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == EDIT_CHILD:
        return edit_transport_child(sys.argv[2])
    layout_only = sys.argv[1:2] == [LAYOUT_ONLY]
    other = (sys.argv[3] if layout_only and sys.argv[2:3] == ["--other"]
             else None)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    try:
        from vacmap_tpu_torch import _build, cli, native
        from vacmap_tpu_torch.ops import affine_batch as ab
        from vacmap_tpu_torch.ops import affine_fill as af
        from vacmap_tpu_torch.ops import chain, myers
        from vacmap_tpu_torch.ops.affine_ref import align2p
        from vacmap_tpu_torch.parallel import fill_service
    except ImportError as err:
        fail(f"vacmap_tpu_torch is not importable beside this script: {err}")
    kernels = {"chain_dp": chain.chain_scores_batch,
               "chain_dp_large": chain.chain_scores_batch_warm,
               "fill_full": af.fill_rowruns,
               "fill_banded": af.fill_rowruns_banded,
               "fill_scan": af.fill_traceback,
               "myers": myers.myers_distances,
               "affine_band": ab.affine_batch}

    def reset_launches():
        for w in kernels.values():
            w.launches = 0

    def read_launches():
        return {k: w.launches for k, w in kernels.items()}

    # ---- 1. device ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    try:
        smi = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as err:
        fail(f"nvidia-smi gave no name and power limit: {err!r}")
    card = smi
    say(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {count} visible)")
    say(smi)
    dev = torch.device("cuda:0")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    try:
        so = _build.build()
        _build.library()
    except Exception as err:  # noqa: BLE001
        fail(f"kernel build failed: {err}")
    ptxas = [ln.strip() for ln in (_build.BUILD_DIR / "nvcc.log").read_text()
             .splitlines() if "Used" in ln or "Compiling entry" in ln] \
        if (_build.BUILD_DIR / "nvcc.log").exists() else []
    say(f"build: ok {so} in {time.perf_counter() - t0:.1f} s")
    for ln in ptxas:
        say(f"  {ln}")
    # the host C++ library (asm streaming has no numpy fallback for it)
    t0 = time.perf_counter()
    if not native.available():
        fail("the package's native host library did not build (g++)")
    if not os.path.samefile(os.path.dirname(native._SO), _build.BUILD_DIR):
        fail(f"the native host library is not under the build directory: "
             f"{native._SO}")
    say(f"build: ok {native._SO} in {time.perf_counter() - t0:.1f} s")

    # ---- 3. data --------------------------------------------------------
    t0 = time.perf_counter()
    gcodes, reads = make_corpus()
    read_bases = sum(len(c) for _, c in reads)
    say(f"data: genome {len(gcodes)} bp, {len(reads)} reads, {read_bases} bp "
        f"in {time.perf_counter() - t0:.1f} s")

    if layout_only:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        with tempfile.TemporaryDirectory(prefix="vacmap_layout_") as wd:
            genome_layout_phase(wd, gcodes, reads, env, card,
                                other and os.path.abspath(other))
        return 0

    # ---- 4. kernel phases -----------------------------------------------
    rng = np.random.default_rng(SEED + 1)
    args0 = cli.build_parser().parse_args(
        ["-ref", "-", "-read", "-", "-mode", "H"])
    cfg0 = cli.config_from_args(args0)
    skip_g, maxdiff_g, maxgap_g = cfg0.chain_params_global()
    skip_l, maxdiff_l, maxgap_l = cfg0.chain_params_local()
    summary = {}

    def chain_phase(variant, B, N, rng=rng, sweep=False):
        local = variant in ("fine", "mismatch")
        k, skip, md, mg = ((cfg0.local_kmersize, skip_l, maxdiff_l, maxgap_l)
                           if local else (15, skip_g, maxdiff_g, maxgap_g))
        alist = [sv_anchors(rng, int(rng.integers(N // 2 + 1, N + 1)), local)
                 for _ in range(B)]
        arrays = chain.prepare_batch(alist, variant, skip, md)
        kw = dict(kmersize=k, maxdiff=md, maxgap=mg, skipcost=skip,
                  variant=variant)
        x = chain.to_device(dev, *arrays)
        chain.chain_scores_batch(*x, **kw)  # warm-up
        launch = lambda: chain.chain_scores_batch(*x, **kw)  # noqa: E731
        wrap_ms, (S, P) = wall_ms(torch, launch, 10)
        ms = device_ms(torch, launch, 5)
        plain_ms, (S0, P0) = wall_ms(
            torch, lambda: chain.chain_scores_batch_ref(*x, **kw), 1)
        nv = arrays[1]
        valid = np.arange(arrays[0].shape[1])[None, :] < nv[:, None]
        S, P = S.cpu().numpy(), P.cpu().numpy()
        S0, P0 = S0.cpu().numpy(), P0.cpu().numpy()
        err = float(np.abs(S - S0)[valid].max())
        agree = float((P == P0)[valid].mean())
        ok = err <= CHAIN_ATOL and agree >= CHAIN_P_MIN
        pairs = chain_pairs(arrays[0], nv, np.zeros_like(nv), local)
        b_ms, b_by = bound(pairs * OPS_PER_PAIR,
                           nbytes(*x, torch.as_tensor(S), torch.as_tensor(P)))
        say(f"kernel chain_dp {variant} B={B} N={N}: max|dS|={err:.3g} "
            f"P agreement={agree:.6f} kernel {ms:.3f} ms (wrapper "
            f"{wrap_ms:.3f} ms) plain {plain_ms:.1f} ms bound {b_ms:.4f} ms "
            f"({b_by}, {pairs} pairs) [{card}] {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"chain_dp {variant} B={B} N={N} disagrees with its plain version")
        if sweep:
            # the same launch at every cluster size (CTAs a read): the same
            # bits, and the time each takes beside the launch's own choice
            times = []
            for c in (1, 2, 4, 8):
                at_c = lambda: chain.chain_scores_batch(*x, **kw, cluster=c)  # noqa: E731
                S_c, P_c = at_c()
                if not (np.array_equal(S_c.cpu().numpy().view(np.int32),
                                       S.view(np.int32))
                        and np.array_equal(P_c.cpu().numpy(), P)):
                    fail(f"chain_dp {variant} B={B} N={N}: a cluster of {c} "
                         f"changes the result")
                times.append(f"{c}: {device_ms(torch, at_c, 3):.3f} ms")
            say(f"kernel chain_dp {variant} B={B} N={N} by CTAs a read (the "
                f"launch's choice took {ms:.3f} ms; results bit-identical): "
                + ", ".join(times) + f" [{card}]")
        return err, ms, wrap_ms, plain_ms, b_ms, b_by

    def warm_phase(n, n_warm):
        """The tiled kernel at B = 1, global_nocov (the asm round-1 block):
        n barrier-sorted anchors behind a frontier of n_warm anchors in
        score order, with rebased scores and negative predecessor codes;
        n_warm = 0 is the cold DP of a contig under 500 kb, launched
        through chain_scores_batch and held to chain_scores_batch_ref."""
        a = sv_anchors(rng, n, False)
        a[:, 0] += 5000
        f = a[rng.permutation(n)[:n_warm]].copy()
        f[:, 0] -= rng.integers(100, 4000, n_warm)
        linked = np.concatenate([f, a]) if n_warm else a
        arrays = chain.prepare_batch([linked], "global_nocov", skip_g, maxdiff_g)
        N = arrays[0].shape[1]
        w_S = np.zeros((1, N), np.float32)
        w_P = np.zeros((1, N), np.int32)
        w_S[0, :n_warm] = np.sort(1000.0 - rng.random(n_warm) * 96.0)
        w_P[0, :n_warm] = -rng.integers(0, 30000, n_warm) - 2
        nw = np.array([n_warm], np.int32)
        kw = dict(kmersize=15, maxdiff=maxdiff_g, maxgap=1000,
                  skipcost=skip_g, variant="global_nocov")
        x = chain.to_device(dev, *arrays, w_S, w_P, nw)
        if n_warm:
            launch = lambda: chain.chain_scores_batch_warm(*x, **kw)  # noqa: E731
            plain = lambda: chain.chain_scores_batch_warm_ref(*x, **kw)  # noqa: E731
        else:
            # cold: chain_scores_batch goes to the tiled kernel above MAX_N
            launch = lambda: chain.chain_scores_batch(*x[:4], **kw)  # noqa: E731
            plain = lambda: chain.chain_scores_batch_ref(*x[:4], **kw)  # noqa: E731
        launch()  # warm-up
        wrap_ms, (S, P) = wall_ms(torch, launch, 5)
        ms = device_ms(torch, launch, 3)
        plain_ms, (S0, P0) = wall_ms(torch, plain, 1)
        S, P = S.cpu().numpy()[0], P.cpu().numpy()[0]
        S0, P0 = S0.cpu().numpy()[0], P0.cpu().numpy()[0]
        nv = len(linked)
        scored = slice(n_warm, nv)
        err = float(np.abs(S - S0)[scored].max())
        agree = float((P == P0)[scored].mean())
        frozen_ok = (np.array_equal(S[:n_warm], w_S[0, :n_warm])
                     and np.array_equal(P[:n_warm], w_P[0, :n_warm])
                     and np.array_equal(S[nv:], w_S[0, nv:])
                     and bool((P[nv:] == -1).all()))
        linked_in = int(((P[scored] >= 0) & (P[scored] < n_warm)).sum())
        ok = err <= CHAIN_ATOL and agree >= CHAIN_P_MIN and frozen_ok
        pairs = chain_pairs(arrays[0], arrays[1], nw, False)
        b_ms, b_by = bound(pairs * OPS_PER_PAIR,
                           nbytes(*x, torch.as_tensor(S), torch.as_tensor(P)))
        say(f"kernel chain_dp_large global_nocov B=1 N={N} n={nv} "
            f"n_warm={n_warm}: max|dS|={err:.3g} P agreement={agree:.6f} "
            f"frozen rows and rows past n_valid exact={frozen_ok} rows linked "
            f"into the frontier={linked_in} kernel {ms:.3f} ms (wrapper "
            f"{wrap_ms:.3f} ms) plain {plain_ms:.1f} ms bound {b_ms:.4f} ms "
            f"({b_by}, {pairs} pairs) [{card}] {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"chain_dp_large N={N} n_warm={n_warm} disagrees with its "
                 f"plain version")
        return err, ms, wrap_ms, plain_ms, b_ms, b_by

    def warm_unsorted_phase():
        """The tiled kernel at B = 3, global_nocov: round-1 blocks of
        2,800, 1,500 and 900 anchors behind frontiers of 40, 7 and 0
        (n_valid and n_warm ragged, N = 4096), the middle one with two
        rows swapped past its frontier: that problem takes the kernel's
        row-at-a-time route, the others the tiles.  A generator of its
        own, so that every later phase keeps its inputs."""
        rng_u = np.random.default_rng(SEED + 6)
        n_warm = np.array([40, 7, 0], np.int32)
        alist = []
        for n, nw in zip((2_800, 1_500, 900), n_warm):
            a = sv_anchors(rng_u, n, False)
            a[:, 0] += 5000
            f = a[rng_u.permutation(n)[:nw]].copy()
            f[:, 0] -= rng_u.integers(100, 4000, nw)
            alist.append(np.concatenate([f, a]) if nw else a)
        i, j = 7 + 100, 7 + 1_000
        alist[1][[i, j]] = alist[1][[j, i]]
        arrays = chain.prepare_batch(alist, "global_nocov", skip_g, maxdiff_g)
        N = arrays[0].shape[1]
        w_S = np.zeros((3, N), np.float32)
        w_P = np.zeros((3, N), np.int32)
        for b, nw in enumerate(n_warm):
            w_S[b, :nw] = np.sort(1000.0 - rng_u.random(nw) * 96.0)
            w_P[b, :nw] = -rng_u.integers(0, 30000, nw) - 2
        kw = dict(kmersize=15, maxdiff=maxdiff_g, maxgap=1000,
                  skipcost=skip_g, variant="global_nocov")
        x = chain.to_device(dev, *arrays, w_S, w_P, n_warm)
        unsorted = chain._unsorted_reads(x[0], x[1], x[6], False).tolist()
        if unsorted != [False, True, False]:
            fail(f"chain_dp_large unsorted case is not what it claims: "
                 f"{unsorted}")
        launch = lambda: chain.chain_scores_batch_warm(*x, **kw)  # noqa: E731
        launch()  # warm-up
        wrap_ms, (S, P) = wall_ms(torch, launch, 5)
        ms = device_ms(torch, launch, 3)
        plain_ms, (S0, P0) = wall_ms(
            torch, lambda: chain.chain_scores_batch_warm_ref(*x, **kw), 1)
        S, P, S0, P0 = (t.cpu().numpy() for t in (S, P, S0, P0))
        idx = np.arange(N)[None, :]
        scored = (idx >= n_warm[:, None]) & (idx < arrays[1][:, None])
        err = float(np.abs(S - S0)[scored].max())
        agree = float((P == P0)[scored].mean())
        rest_ok = (np.array_equal(S[~scored], S0[~scored])
                   and np.array_equal(P[~scored], P0[~scored]))
        ok = err <= CHAIN_ATOL and agree >= CHAIN_P_MIN and rest_ok
        pairs = chain_pairs(arrays[0], arrays[1], n_warm, False)
        b_ms, b_by = bound(pairs * OPS_PER_PAIR,
                           nbytes(*x, torch.as_tensor(S), torch.as_tensor(P)))
        say(f"kernel chain_dp_large global_nocov B=3 N={N} n={arrays[1].tolist()} "
            f"n_warm={n_warm.tolist()}, problem 1 unsorted (row by row): "
            f"max|dS|={err:.3g} P agreement={agree:.6f} frozen rows and rows "
            f"past n_valid exact={rest_ok} kernel {ms:.3f} ms (wrapper "
            f"{wrap_ms:.3f} ms) plain {plain_ms:.1f} ms bound {b_ms:.4f} ms "
            f"({b_by}, {pairs} pairs) [{card}] {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail("chain_dp_large B=3 with an unsorted problem disagrees with "
                 "its plain version")
        return err, ms, wrap_ms, plain_ms, b_ms, b_by

    try:
        res = [chain_phase("global", 16, 8192, sweep=True),
               chain_phase("global", 64, 2048),
               chain_phase("fine", 64, 1024, sweep=True),
               chain_phase("mismatch", 64, 1024)]
        # the executor's local launches have few reads (the aggregator pads
        # a group to 8 or 16), and refund is the R-mode ledger; a generator
        # of their own, so that every later phase keeps its inputs
        rng_small = np.random.default_rng(SEED + 5)
        res += [chain_phase("mismatch", 8, 8192, rng_small),
                chain_phase("fine", 16, 2048, rng_small),
                chain_phase("fine", 8, 2048, rng_small, sweep=True),
                chain_phase("refund", 16, 2048, rng_small)]
    except SystemExit:
        raise
    except Exception as err:  # noqa: BLE001
        fail(f"chain_dp phase raised: {err!r}")
    def summarize(res):
        # errors over every phase; times and bound of the first shape; no
        # single PyTorch call computes any of these functions
        return dict(max_abs_err=max(r[0] for r in res), ms=res[0][1],
                    wrapper_ms=res[0][2], plain_ms=res[0][3],
                    bound_ms=res[0][4], bound_by=res[0][5], library_ms=None)

    summary["chain_dp"] = summarize(res)
    try:
        # the asm phase's shapes first: a round-1 block of the 2 Mb contig
        # (2,800 anchors behind a frontier of 4, N = 4096) and the cold DP
        # of the 480 kb contig (9,900 anchors, N = 16,384); then a block
        # whose seeds do not merge (18,000 anchors behind a 300-anchor
        # frontier, N = 32,768); then three ragged problems, one unsorted
        res = [warm_phase(2_800, 4), warm_phase(9_900, 0),
               warm_phase(18_000, 300), warm_unsorted_phase()]
    except SystemExit:
        raise
    except Exception as err:  # noqa: BLE001
        fail(f"chain_dp_large phase raised: {err!r}")
    summary["chain_dp_large"] = summarize(res)

    def fill_phase(name, wrapper, ref, N, pairs, banded):
        tT, tQ, lens = padded(pairs, N)
        if banded:
            qs = af.make_qshift(tQ, lens[:, 0], lens[:, 1], N)
            x = [torch.from_numpy(a).to(dev) for a in (tT, qs, lens)]
        else:
            x = [torch.from_numpy(a).to(dev) for a in (tT, tQ, lens)]
        wrapper(*x)  # warm-up
        wrap_ms, got = wall_ms(torch, lambda: wrapper(*x), 20)
        ms = device_ms(torch, lambda: wrapper(*x), 5)
        plain_ms, want = wall_ms(torch, lambda: ref(*x), 1)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        err = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
        extra = ""
        if banded:
            extra = f" escalated={int(((want[:, N] & 0x80) != 0).sum())}"
        cells = int((lens[:, 0].astype(np.int64)
                     * (af.BAND_W if banded else lens[:, 1])).sum())
        b_ms, b_by = bound(cells * OPS_PER_CELL,
                           nbytes(*x, torch.as_tensor(got)))
        say(f"kernel {name} B={len(pairs)} N={N}: planes "
            f"{'byte-identical' if err == 0 else 'DIFFER'}{extra} kernel "
            f"{ms:.4f} ms (wrapper {wrap_ms:.4f} ms) plain {plain_ms:.1f} ms "
            f"bound {b_ms:.4f} ms ({b_by}, {cells} cells) [{card}]")
        if err:
            fail(f"{name} N={N} planes differ from its plain version")
        return err, ms, wrap_ms, plain_ms, b_ms, b_by

    def scan_phase(N, pairs):
        tT, tQ, lens = padded(pairs, N)
        x = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (tT, tQ, lens[:, 0], lens[:, 1])]
        af.fill_traceback(*x)  # warm-up
        wrap_ms, got = wall_ms(torch, lambda: af.fill_traceback(*x), 20)
        ms = device_ms(torch, lambda: af.fill_traceback(*x), 5)
        plain_ms, want = wall_ms(torch, lambda: af.fill_traceback_ref(*x), 1)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        err = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
        cells = int((lens[:, 0].astype(np.int64) * lens[:, 1]).sum())
        b_ms, b_by = bound(cells * OPS_PER_CELL,
                           nbytes(*x, torch.as_tensor(got)))
        say(f"kernel fill_scan B={len(pairs)} N={N}: packed op streams "
            f"{'byte-identical' if err == 0 else 'DIFFER'} kernel {ms:.3f} ms "
            f"(wrapper {wrap_ms:.3f} ms) plain {plain_ms:.1f} ms bound "
            f"{b_ms:.4f} ms ({b_by}, {cells} cells) [{card}]")
        if err:
            fail(f"fill_scan N={N} op streams differ from its plain version")
        return err, ms, wrap_ms, plain_ms, b_ms, b_by

    # the executor's full-width launch shape; a generator of its own, so
    # that every other phase keeps its inputs
    rng_full = np.random.default_rng(SEED + 7)
    full_exec = {N: fill_pairs(rng_full, gcodes, EXEC_FULL_B, N // 4, N,
                               big_indel=0.3, random_frac=0.05)
                 for N in (256, 512)}
    try:
        res = []
        for N in (256, 512):
            pairs = fill_pairs(rng, gcodes, 256, N // 4, N, big_indel=0.3,
                               random_frac=0.05)
            res.append(fill_phase("fill_full", af.fill_rowruns,
                                  af.fill_rowruns_ref, N, pairs, False))
        for N in (256, 512):
            res.append(fill_phase("fill_full", af.fill_rowruns,
                                  af.fill_rowruns_ref, N, full_exec[N], False))
        summary["fill_full"] = summarize(res)
        res = []
        for T in (256, 512):
            pairs = fill_pairs(rng, gcodes, 256, T // 4, T - 100,
                               random_frac=0.05)
            res.append(fill_phase("fill_banded", af.fill_rowruns_banded,
                                  af.fill_rowruns_banded_ref, T, pairs, True))
        # the executor's launch shape (about 16 jobs a launch); a generator
        # of its own, so that every later phase keeps its inputs
        rng_b16 = np.random.default_rng(SEED + 6)
        for T in (256, 512):
            pairs = fill_pairs(rng_b16, gcodes, 16, T // 4, T - 100,
                               random_frac=0.05)
            res.append(fill_phase("fill_banded", af.fill_rowruns_banded,
                                  af.fill_rowruns_banded_ref, T, pairs, True))
        summary["fill_banded"] = summarize(res)
        res = []
        for N in (256, 512):
            pairs = fill_pairs(rng, gcodes, 256, N // 4, N, big_indel=0.3,
                               random_frac=0.05)
            res.append(scan_phase(N, pairs))
        for N in (256, 512):
            res.append(scan_phase(N, full_exec[N]))
        summary["fill_scan"] = summarize(res)
    except SystemExit:
        raise
    except Exception as err:  # noqa: BLE001
        fail(f"fill phase raised: {err!r}")

    def myers_phase(T, Wd, B, rng=rng, n_max=None):
        """csrc/myers.cu at one bucket's full width against its plain
        version on the card (one step a text column: on the pairs with a
        text up to n_max, by default T, or T / 2 at the largest bucket)
        and against the native Myers on the pairs without N."""
        pairs = myers_pairs(rng, gcodes, T, Wd * 32, B)
        x = [torch.from_numpy(a).to(dev) for a in myers.pack_jobs(pairs, T, Wd)]
        launch = lambda: myers.myers_distances(*x)  # noqa: E731
        launch()  # warm-up
        wrap_ms, got = wall_ms(torch, launch, 5)
        ms = device_ms(torch, launch, 3)
        got = got.cpu().numpy()
        if n_max is None:
            n_max = T if T <= 8192 else T // 2
        sub = [i for i, (t, _) in enumerate(pairs) if len(t) <= n_max]
        idx = torch.as_tensor(sub, device=dev)
        plain_ms, want = wall_ms(
            torch, lambda: myers.myers_distances_ref(*(a[idx] for a in x)), 1)
        err = int(np.abs(got[sub] - want.cpu().numpy()).max())
        clean = [i for i, (t, q) in enumerate(pairs)
                 if not ((t == 4).any() or (q == 4).any())]
        nat = np.array([native.edit_distance_native(*pairs[i]) for i in clean])
        nat_bad = [i for i, d in zip(clean, nat) if got[i] != d]
        steps = sum(len(t) * ((len(q) + 63) // 64) for t, q in pairs)
        b_ms, b_by = bound(steps * OPS_PER_WORD_STEP,
                           nbytes(*x, torch.as_tensor(got)))
        longest = max(len(t) for t, _ in pairs)
        ok = err == 0 and not nat_bad
        say(f"kernel myers B={B} T={T} pattern<={Wd * 32}: "
            f"{len(sub)}/{B} pairs held to the plain version (max abs "
            f"difference {err}), {len(clean)}/{B} without N held to the native "
            f"Myers ({len(clean) - len(nat_bad)} equal); distances "
            f"{int(got.min())}..{int(got.max())}; kernel {ms:.4f} ms (wrapper "
            f"{wrap_ms:.4f} ms; {ms * 1e6 / longest:.1f} ns a column of the "
            f"longest text, {longest}) plain {plain_ms:.1f} ms ({len(sub)} "
            f"pairs) bound {b_ms:.5f} ms ({b_by}, {steps} word-steps at "
            f"{OPS_PER_WORD_STEP} operations) [{card}] "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"myers T={T} disagrees with its plain version or the native "
                 f"Myers (pairs {nat_bad[:10]})")
        return err, ms, wrap_ms, plain_ms, b_ms, b_by

    try:
        res = [myers_phase(2048, 128, 256), myers_phase(8192, 384, 64),
               myers_phase(20480, 896, 32)]
        # the divergence filter's launch size: about three pairs of texts
        # near T (a generator of its own, so that later phases keep their
        # inputs)
        rng_b3 = np.random.default_rng(SEED + 9)
        res += [myers_phase(T, Wd, 3, rng_b3, T) for T, Wd in
                myers.DEFAULT_BUCKETS]
        summary["myers"] = summarize(res)
    except SystemExit:
        raise
    except Exception as err:  # noqa: BLE001
        fail(f"myers phase raised: {err!r}")

    def affine_phase(B, T, W, glob, reps, rng):
        """csrc/affine_band.cu against affine_batch_ref on the card, on
        band_pairs: all six outputs equal, the plane byte for byte."""
        kw = (dict(W=W, glob=True, zdrop=-1) if glob
              else dict(EXT_KW, W=W, glob=False))
        pairs = band_pairs(rng, gcodes, B, T, W, not glob)
        tT, tQ, lens = padded(pairs, T)
        x = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (tT, tQ, lens[:, 0], lens[:, 1])]
        launch = lambda: ab.affine_batch(*x, **kw)  # noqa: E731
        launch()  # warm-up
        wrap_ms, got = wall_ms(torch, launch, reps)
        ms = device_ms(torch, launch, reps)
        plain_ms, want = wall_ms(torch, lambda: ab.affine_batch_ref(*x, **kw),
                                 1)
        names = ("tb", "best", "best_i", "best_j", "dead", "dlo")
        differ = [n for n, g, w in zip(names, got, want)
                  if g.dtype != w.dtype or g.shape != w.shape
                  or not torch.equal(g, w)]
        dead = want[4].cpu().numpy()
        far = int((np.abs(lens[:, 1] - lens[:, 0]) >= W).sum())
        # rows these inputs need: every row of the plane in the global
        # mode; up to t_len, or for a dropped pair past its best row (the
        # drop comes later), in the extension mode
        rows = (np.full(B, T) if glob else np.where(
            dead, want[2].cpu().numpy() + 1, np.minimum(lens[:, 0], T)))
        cells = int(rows.sum()) * W
        b_ms, b_by = bound(cells * OPS_PER_BAND_CELL[glob],
                           nbytes(*x, *(g for g in got if g.dim())))
        mode = "global" if glob else f"extension zdrop {EXT_KW['zdrop']}"
        verdict = ("all six outputs equal (plane byte for byte)"
                   if not differ else f"DIFFER in {differ}")
        say(f"kernel affine_band {mode} B={B} T={T} W={W}: {verdict}; "
            f"{int(dead.sum())} pairs dropped, {far} with |q - t| >= W, "
            f"t_len {int(lens[:, 0].min())}..{int(lens[:, 0].max())}; kernel "
            f"{ms:.4f} ms (wrapper {wrap_ms:.4f} ms) plain {plain_ms:.1f} ms "
            f"bound {b_ms:.5f} ms ({b_by}, {cells} cells at "
            f"{OPS_PER_BAND_CELL[glob]} operations) [{card}]")
        if differ:
            fail(f"affine_band B={B} T={T} W={W} glob={glob} differs from "
                 f"its plain version in {differ}")
        return 0, ms, wrap_ms, plain_ms, b_ms, b_by

    def affine_edge_phase(W):
        """csrc/affine_band.cu against affine_batch_ref on the card on
        band_edge_batches(W) (the CPU twin's edge cases): all six outputs
        equal in each mode, the plane byte for byte."""
        for mode, (xn, kw, roles) in band_edge_batches(W).items():
            x = [torch.from_numpy(a).to(dev) for a in xn]
            got = ab.affine_batch(*x, **kw)
            torch.cuda.synchronize()
            want = ab.affine_batch_ref(*x, **kw)
            names = ("tb", "best", "best_i", "best_j", "dead", "dlo")
            differ = [n for n, g, w in zip(names, got, want)
                      if g.dtype != w.dtype or g.shape != w.shape
                      or not torch.equal(g, w)]
            say(f"kernel affine_band edge W={W} {mode}: {len(roles)} pairs "
                f"({', '.join(roles)}): "
                f"{'all six outputs equal' if not differ else f'DIFFER in {differ}'}"
                f" [{card}]")
            if differ:
                fail(f"affine_band edge W={W} {mode} differs from its plain "
                     f"version in {differ}")

    class PlainBatchAligner(ab.BatchAligner):
        # the same groups through the plain version on the card's tensors
        _affine = staticmethod(ab.affine_batch_ref)

    def batch_aligner_phase(glob, pairs):
        """ab.BatchAligner on the card against the same groups through the
        plain version: equal results (CIGARs, endpoints, scores, drops);
        every global CIGAR's walked score equal to the host align2p's.
        Returns the kernel's launches on the card's run."""
        kw = (dict(glob=True) if glob
              else {**EXT_KW, "glob": False})
        reset_launches()
        t0 = time.perf_counter()
        try:
            got = ab.BatchAligner(**kw, device=dev).align_batch(pairs, eqx=glob)
            torch.cuda.synchronize()
        except Exception as err:  # noqa: BLE001
            fail(f"BatchAligner glob={glob} raised: {err!r}")
        dt = time.perf_counter() - t0
        launches = read_launches()["affine_band"]
        want = PlainBatchAligner(**kw, device=dev).align_batch(pairs, eqx=glob)
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        # the pairs the aligner sends to the host align2p
        ba = ab.BatchAligner(**kw, device=dev)
        bucket = [(ba._bucket(len(t)), ba._bucket(len(q))) for t, q in pairs]
        routed = sum(1 for (t, q), (bt, bq) in zip(pairs, bucket)
                     if min(bt, bq) < 0 or abs(len(q) - len(t)) + 64
                     > ba._band_for(max(bt, bq)))
        extra = ""
        if glob:
            off = [i for i, ((t, q), r) in enumerate(zip(pairs, got))
                   if cigar_score(r.cigar, t, q) != align2p(
                       t, q, bw=-1, zdrop=-1).score]
            extra = (f"; walked CIGAR scores equal to the host align2p's for "
                     f"{len(pairs) - len(off)}/{len(pairs)}")
            bad += off
        else:
            extra = f"; {sum(r.zdropped for r in got)} dropped"
        say(f"BatchAligner {'global' if glob else 'extension'} on the card: "
            f"{len(pairs)} pairs ({len(pairs) - routed} in the buckets, "
            f"{routed} to the host align2p); results equal to the same groups "
            f"through the plain version for {len(pairs) - len(bad)}/"
            f"{len(pairs)}{extra}; {launches} affine_band launches in "
            f"{dt:.3f} s [{card}]")
        if bad:
            fail(f"BatchAligner glob={glob}: pairs {sorted(set(bad))[:20]} "
                 f"differ: {[(got[i], want[i]) for i in sorted(set(bad))[:3]]}")
        if launches <= 0:
            fail(f"BatchAligner glob={glob}: affine_band never launched")
        return {"affine_band": launches}

    try:
        # a generator of its own, so that every later phase keeps its inputs
        rng_band = np.random.default_rng(SEED + 12)
        res = [affine_phase(64, 512, 128, True, 10, rng_band),
               affine_phase(64, 4096, 256, True, 5, rng_band),
               affine_phase(64, 8192, 512, False, 5, rng_band),
               affine_phase(64, 32768, 512, False, 3, rng_band),
               affine_phase(16, 128, 32, True, 10, rng_band)]
        summary["affine_band"] = summarize(res)
        for W in ab.BAND_WIDTHS:
            affine_edge_phase(W)
        glob_pairs = (fill_pairs(rng_band, gcodes, 160, 30, 512, big_indel=0.1)
                      + fill_pairs(rng_band, gcodes, 48, 513, 2048,
                                   big_indel=0.1)
                      + fill_pairs(rng_band, gcodes, 16, 2049, 4096)
                      + fill_pairs(rng_band, gcodes, 2, 4200, 4600))
        ext_pairs = [(t, q) if k % 2 else (t, np.concatenate([q[: len(q) // 2],
                     rng_band.integers(0, 4, len(q) - len(q) // 2,
                                       dtype=np.uint8)]))
                     for k, (t, q) in enumerate(
                         fill_pairs(rng_band, gcodes, 120, 100, 512)
                         + fill_pairs(rng_band, gcodes, 48, 513, 2048,
                                      big_indel=0.1)
                         + fill_pairs(rng_band, gcodes, 16, 2049, 8192))]
        path_launches = {
            "batch_aligner_global": batch_aligner_phase(True, glob_pairs),
            "batch_aligner_extension": batch_aligner_phase(False, ext_pairs)}
    except SystemExit:
        raise
    except Exception as err:  # noqa: BLE001
        fail(f"affine_band phase raised: {err!r}")

    # realistic jobs through the aligner and the service vs the host aligner
    pairs = (fill_pairs(rng, gcodes, 1800, 10, 500, big_indel=0.05, n_frac=0.03)
             + fill_pairs(rng, gcodes, 150, 300, 700)
             + fill_pairs(rng, gcodes, 100, 1, 12))
    host = af.native.align2p_batch_native(pairs, eqx=True)
    if host is None:
        fail("native host aligner unavailable")
    host = [af.native.ops_to_cigar(h) for h in host]

    def held_to_host(what, align):
        t0 = time.perf_counter()
        try:
            got = align()
            torch.cuda.synchronize()
        except Exception as err:  # noqa: BLE001
            fail(f"{what} raised: {err!r}")
        dt = time.perf_counter() - t0
        bad = [i for i, (g, h) in enumerate(zip(got, host)) if g.cigar != h]
        say(f"{what}: {len(pairs) - len(bad)}/{len(pairs)} CIGARs equal to "
            f"the host aligner (eqx) in {dt:.3f} s [{card}]")
        if bad:
            fail(f"{what} CIGARs differ from the host aligner on jobs {bad[:20]}")

    held_to_host("aligner", lambda: af.TorchFillAligner(device=dev)
                 .align_batch(pairs, eqx=True))
    for route, scan in (("service_default", False), ("service_scan", True)):
        if scan:
            os.environ["VACMAP_TPU_FILL_SCAN"] = "1"
        svc = fill_service.async_fill_aligner(dev)
        try:
            if not svc.ready.wait(300) or svc.core.error is not None:
                fail(f"{route}: the fill service did not come up: "
                     f"{svc.core.error}")
            reset_launches()
            held_to_host(f"{route} (AsyncFillAligner)",
                         lambda: svc.align_batch(pairs, eqx=True))
            path_launches[route] = read_launches()
        finally:
            svc.stop()
            os.environ.pop("VACMAP_TPU_FILL_SCAN", None)
        say(f"{route} launches: {path_launches[route]}")
    need = {"service_default": ("fill_banded", "fill_full"),
            "service_scan": ("fill_banded", "fill_scan")}
    for route, names in need.items():
        if min(path_launches[route][k] for k in names) <= 0:
            fail(f"{route}: a kernel of the route never launched: "
                 f"{path_launches[route]}")

    # the edit kind on both transports, against the native Myers
    e_pairs, routable = edit_service_pairs()
    e_want = [native.edit_distance_native(t, q) if r else None
              for (t, q), r in zip(e_pairs, routable)]

    def held_to_native(what, got, dt, launches):
        bad = [i for i, (g, w) in enumerate(zip(got, e_want)) if g != w]
        say(f"{what}: {len(e_pairs) - len(bad)}/{len(e_pairs)} edit jobs as "
            f"expected ({sum(routable)} routed distances equal to the native "
            f"Myers, {len(e_pairs) - sum(routable)} oversized, empty-sided or "
            f"N pairs answered None) in {dt:.3f} s, myers launches "
            f"{launches} [{card}]")
        if bad or len(got) != len(e_want):
            fail(f"{what}: edit jobs {bad[:20]} differ: "
                 f"{[(got[i], e_want[i]) for i in bad[:20]]}")
        if launches <= 0:
            fail(f"{what}: the myers kernel never launched")

    svc = fill_service.async_fill_aligner(
        dev, edit_aligner=myers.TorchMyersAligner(dev))
    try:
        if not svc.ready.wait(300) or svc.core.error is not None:
            fail(f"edit service: did not come up: {svc.core.error}")
        reset_launches()
        t0 = time.perf_counter()
        try:
            got = edit_through(svc, e_pairs)
        except Exception as err:  # noqa: BLE001
            fail(f"edit service (AsyncFillAligner) raised: {err!r}")
        held_to_native("edit service (AsyncFillAligner)", got,
                       time.perf_counter() - t0, read_launches()["myers"])
        say(f"edit service (AsyncFillAligner) routes [submitted, sent, capped, "
            f"governed, not live]: {list(svc.core.edit_routes[:])}")
        path_launches["edit_service"] = {"myers": read_launches()["myers"]}
    finally:
        svc.stop()

    # ---- 5. end to end ----------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="vacmap_smoke_") as wd:
        # the same jobs through a service process of its own (FillClient);
        # the latency governor is held open, so that no routable job is
        # bounced: this phase checks answers, not admission
        child_out = os.path.join(wd, "edit_child.json")
        child_stats = os.path.join(wd, "edit_child_stats.txt")
        child_env = dict(os.environ, VACMAP_TPU_EDIT_DEVICE="1",
                         VACMAP_TPU_FILL_LAT_S="600",
                         VACMAP_TPU_FILL_STATS=child_stats)
        dt, p = cli_process([os.path.abspath(__file__), EDIT_CHILD, child_out],
                            child_env)
        if p.returncode != 0:
            fail(f"edit service (FillClient) process exited {p.returncode}: "
                 f"{p.stderr[-3000:]}")
        with open(child_out) as f:
            child = json.load(f)
        try:
            child_st, _ = read_stats(child_stats)
        except (OSError, KeyError, ValueError) as err:
            fail(f"the edit service process wrote no stats line: {err!r}")
        held_to_native("edit service (FillClient, a service process)",
                       child["dists"], child["seconds"],
                       int(child_st["edit_launches"]))
        say(f"edit service (FillClient) routes [submitted, sent, capped, "
            f"governed, not live]: {child['routes']}; process {dt:.3f} s")
        ref = os.path.join(wd, "ref.fa")
        rds = os.path.join(wd, "reads.fa")
        out = {k: os.path.join(wd, f"{k}.sam")
               for k in ("executor", "host", "executor_timed", "fork_pool",
                         "executor_edit", "fork_pool_edit", "host_R",
                         "executor_R", "executor_R_plain")}
        stats_path = {k: os.path.join(wd, f"{k}_fill_stats.txt")
                      for k in ("executor", "fork_pool", "executor_edit",
                                "fork_pool_edit", "executor_R")}
        write_fasta(ref, [("chr1", gcodes)])
        write_fasta(rds, reads)
        t0 = time.perf_counter()
        index = cli.load_or_build_index(ref, 15, 10, True)
        say(f"index: built and saved in {time.perf_counter() - t0:.1f} s")
        common = ["-ref", ref, "-read", rds, "-mode", "H"]

        # the executor path, in this process, for its launch counts
        # (chain_dp's from its wrapper, the fills' from the stats line)
        os.environ["VACMAP_TPU_FILL_STATS"] = stats_path["executor"]
        reset_launches()
        try:
            rc = cli.main([*common, "--backend", "jax", "--device", "cuda",
                           "-o", out["executor"]])
            torch.cuda.synchronize()
        except Exception as err:  # noqa: BLE001
            fail(f"port executor CLI raised: {err!r}")
        finally:
            os.environ.pop("VACMAP_TPU_FILL_STATS", None)
        chain_launches = read_launches()["chain_dp"]
        if rc != 0:
            fail(f"port executor CLI exited {rc}")

        # five CLIs as processes of their own, timed over the same window
        # (the host path writes the records the port is held to; the last
        # two are the executor and the fork pool with the edit route on)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        runs = {
            "host": ["-m", "vacmap_tpu_torch.cli", *common, "--backend",
                     "numpy", "--device-fills", "off", "-o", out["host"]],
            "executor_timed": ["-m", "vacmap_tpu_torch.cli", *common,
                               "--backend", "jax", "--device", "cuda", "-o",
                               out["executor_timed"]],
            "fork_pool": ["-m", "vacmap_tpu_torch.cli", *common, "-t", "4",
                          "--device", "cuda", "--device-fills", "on", "-o",
                          out["fork_pool"]],
        }
        for name in ("executor_timed", "fork_pool"):
            base = name.split("_timed")[0]
            runs[f"{base}_edit"] = [*runs[name][:-1], out[f"{base}_edit"]]
        # mode R (the global chain's refund variant): the host path, the
        # executor on the card, and the executor on the plain versions
        # (--device cpu, host fills), which gives the JAX package's
        # executor's records
        for name in ("host", "executor_timed"):
            base = name.split("_timed")[0]
            argv = runs[name][:-1]
            argv[argv.index("-mode") + 1] = "R"
            runs[f"{base}_R"] = [*argv, out[f"{base}_R"]]
        argv = runs["executor_R"][:-2]
        argv[argv.index("--device") + 1] = "cpu"
        runs["executor_R_plain"] = [*argv, "--device-fills", "off", "-o",
                                    out["executor_R_plain"]]
        secs, errs = {}, {}
        for name, argv in runs.items():
            penv = dict(env)
            if name in stats_path:
                penv["VACMAP_TPU_FILL_STATS"] = stats_path[name]
            if name.endswith("_edit"):
                penv["VACMAP_TPU_EDIT_DEVICE"] = "1"
            secs[name], p = cli_process(argv, penv)
            errs[name] = p.stderr
            if p.returncode != 0:
                fail(f"{name} CLI process exited {p.returncode}: "
                     f"{p.stderr[-3000:]}")
            if name.startswith("fork_pool"):
                bad = [ln for ln in p.stderr.splitlines()
                       if "degraded" in ln or "device error" in ln]
                if bad:
                    fail(f"fork-pool service reported: {bad[:5]}")
        stats = {}
        for path in stats_path:
            try:
                stats[path], path_launches[path] = read_stats(stats_path[path])
                path_launches[path]["myers"] = int(stats[path]["edit_launches"])
            except (OSError, KeyError, ValueError) as err:
                fail(f"the {path}'s fill service wrote no stats line: {err!r}")
        path_launches["executor"]["chain_dp"] = chain_launches
        kv = log_stats(errs["executor_R"], "executor chain device stats")
        if kv is None:
            fail("the mode R executor printed no chain stats line")
        path_launches["executor_R"]["chain_dp"] = int(kv["chain_launches"])
        refund_launches = {"executor_R": int(kv["refund_launches"])}

        # the prewarm entry point, a process of its own
        prewarm_s, p = cli_process(["-m", "vacmap_tpu_torch.prewarm", "--all"],
                                   env)
        if p.returncode != 0 or "prewarm complete" not in p.stdout:
            fail(f"prewarm process exited {p.returncode}: "
                 f"{(p.stdout + p.stderr)[-3000:]}")
        say(f"prewarm --all: exit 0 in {prewarm_s:.3f} s as a process of its "
            f"own, {sum('kernel' in ln for ln in p.stdout.splitlines()) - 1} "
            f"kernel shapes launched; it reports: "
            f"{p.stdout.strip().splitlines()[-1]} [{card}]")
        recs = {k: sam_records(v) for k, v in out.items()}

        # ---- 6. asm: two contigs, device chain DPs against the host path
        contigs = asm_contigs(np.random.default_rng(SEED + 2), gcodes)
        ctg = os.path.join(wd, "contigs.fa")
        write_fasta(ctg, contigs)
        asm_out = {k: os.path.join(wd, f"asm_{k}.sam") for k in ("host", "cuda")}
        asm_common = ["-m", "vacmap_tpu_torch.cli", "-ref", ref, "-read", ctg,
                      "-mode", "asm"]
        asm_runs = {
            "host": [*asm_common, "--backend", "numpy", "-o", asm_out["host"]],
            "cuda": [*asm_common, "--backend", "jax", "--device", "cuda",
                     "-o", asm_out["cuda"]],
        }
        asm_secs, asm_err = {}, {}
        for name, argv in asm_runs.items():
            asm_secs[name], p = cli_process(argv, env)
            if p.returncode != 0:
                fail(f"asm {name} CLI process exited {p.returncode}: "
                     f"{p.stderr[-3000:]}")
            asm_err[name] = p.stderr
        asm_recs = {k: sam_records(v) for k, v in asm_out.items()}
        astats = log_stats(asm_err["cuda"], "asm chain device stats")
        if astats is None:
            fail("the asm CLI printed no chain device stats line: "
                 + asm_err["cuda"][-2000:])
        coords_phase(dev, index, cfg0, reads[0], card)

        # ---- 6b. genome layout: chrB past 2^31, chrA a copy of its start
        path_launches.update(
            (f"genome_layout_{k}", v) for k, v in
            genome_layout_phase(wd, gcodes, reads, env, card).items())

        # ---- 7. multi-process: two executor processes, one gloo group
        path_launches["multi_process"] = multi_process_phase(
            wd, common, env, recs["host"], [n for n, _ in reads],
            secs["executor_timed"], card)

        # ---- 8. start-up: which processes import torch, and their windows
        here = os.path.dirname(os.path.abspath(__file__))
        windows = startup_windows(wd, ref, rds, ctg, env, card,
                                  [("this tree", here)])
        for name, _, want in STARTUP:
            (dt, loaded), = windows[("this tree", name)]
            if loaded != want:
                fail(f"start-up: {name} imported torch in {loaded}, "
                     f"expected {want or 'no process'}")

    names = [n for n, _ in reads]
    for path in stats:
        say(f"{path} fill service stats: "
            + " ".join(f"{k}={v}" for k, v in stats[path].items())
            + f" [{card}]")
        st = stats[path]
        say(f"{path} fill jobs: {st['submitted']} submitted; the kernels "
            f"answered {int(st['jobs']) - int(st['escal'])} (device share "
            f"{st['device_share']}); host fills: {st['capped']} bounced by "
            f"the in-flight cap, {st['governed']} by the latency governor, "
            f"{st['not_ready']} before the service was ready, "
            f"{st['host_slot']} in the service's host slot, {st['escal']} "
            f"band escalations")
        say(f"{path} edit jobs: {st['edit_submitted']} submitted by the "
            f"divergence filter; {st['edit_sent']} sent to the service "
            f"({st['edit_served']} answered by the myers kernel in "
            f"{st['edit_calls']} batches, {st['edit_unrouted']} unrouted); "
            f"answered None at once: {st['edit_not_live']} no live kernel, "
            f"{st['edit_capped']} in-flight cap, {st['edit_governed']} latency "
            f"governor")
        say(f"{path} launches: {path_launches[path]}"
            + (f"; chain_dp refund launches {refund_launches[path]}"
               if path in refund_launches else ""))
    checks = []
    for path in stats:
        port_recs = recs[path]
        # the executor's refund chain evaluates every candidate, as the
        # JAX package's does; the host DP stops at the reference's early
        # break, so in mode R the plain versions' executor is the reference
        held_to = "executor_R_plain" if path == "executor_R" else "host"
        host_recs = recs[held_to]
        aligned = sum(1 for n in names if any(
            not int(r[1]) & 4 for r in port_recs.get(n, [])))
        same = [n for n in names if port_recs.get(n) == host_recs.get(n)]
        differ = [n for n in names if port_recs.get(n) != host_recs.get(n)]
        agree = len(same) / len(names)
        say(f"e2e {path}: aligned {aligned}/{len(names)}; records equal to "
            f"the {held_to} path for {len(same)}/{len(names)} reads "
            f"({agree:.4f}); differ: {differ}")
        checks.append((path, aligned, agree))
    timed_same = recs["executor_timed"] == recs["executor"]
    say(f"e2e (one CLI process each, start to exit): host path "
        f"{read_bases / secs['host'] / 1e6:.4f} Mbp/s ({secs['host']:.3f} s, 4 "
        f"fork workers, host fills); port executor "
        f"{read_bases / secs['executor_timed'] / 1e6:.4f} Mbp/s "
        f"({secs['executor_timed']:.3f} s, --backend jax; records equal to the "
        f"in-process run: {timed_same}); port fork pool "
        f"{read_bases / secs['fork_pool'] / 1e6:.4f} Mbp/s "
        f"({secs['fork_pool']:.3f} s, -t 4, one CUDA fill service); with "
        f"the edit route (VACMAP_TPU_EDIT_DEVICE=1): executor "
        f"{read_bases / secs['executor_edit'] / 1e6:.4f} Mbp/s "
        f"({secs['executor_edit']:.3f} s), fork pool "
        f"{read_bases / secs['fork_pool_edit'] / 1e6:.4f} Mbp/s "
        f"({secs['fork_pool_edit']:.3f} s) [{card}]")
    host_same = [n for n in names
                 if recs["executor_R"].get(n) == recs["host_R"].get(n)]
    plain_host = sum(recs["executor_R_plain"].get(n) == recs["host_R"].get(n)
                     for n in names)
    say(f"e2e mode R (one CLI process each, start to exit): host path "
        f"{read_bases / secs['host_R'] / 1e6:.4f} Mbp/s ({secs['host_R']:.3f} "
        f"s); port executor {read_bases / secs['executor_R'] / 1e6:.4f} Mbp/s "
        f"({secs['executor_R']:.3f} s, --backend jax, chain_dp refund "
        f"launches {refund_launches['executor_R']}); the executor on the "
        f"plain versions {secs['executor_R_plain']:.3f} s (--device cpu). "
        f"Records equal to the mode R host path: the card's executor "
        f"{len(host_same)}/{len(names)}, the plain versions' {plain_host}/"
        f"{len(names)} (their refund chain evaluates every candidate; the "
        f"host DP stops at the reference's early break) [{card}]")
    need = {"executor": ("chain_dp", "fill_banded", "fill_full"),
            "fork_pool": ("fill_banded",),
            "executor_edit": ("fill_banded", "myers"),
            "fork_pool_edit": ("fill_banded",),
            "executor_R": ("chain_dp", "fill_banded")}
    for path in ("executor", "fork_pool"):
        if path_launches[path]["myers"] or int(stats[path]["edit_sent"]):
            fail(f"{path}: edit jobs reached the service with the switch off: "
                 f"{stats[path]}")
    for path, ks in need.items():
        if min(path_launches[path][k] for k in ks) <= 0:
            fail(f"{path}: a kernel of the path never launched: "
                 f"{path_launches[path]}")
    if refund_launches["executor_R"] <= 0:
        fail("executor_R: the refund chain kernel never launched")
    for path in stats:
        if int(stats[path]["jobs"]) <= 0:
            fail(f"the {path}'s fill service served no jobs")
    for path, aligned, agree in checks:
        if aligned != len(names):
            fail(f"{path}: only {aligned}/{len(names)} reads aligned")
        if agree < E2E_AGREE_MIN:
            fail(f"{path}: record agreement {agree:.4f} < {E2E_AGREE_MIN}")
    contig_bases = sum(len(c) for _, c in contigs)
    round1 = int(astats["stream_calls"] - astats["declined_variant"])
    say("asm chain device stats: "
        + " ".join(f"{k}={v:g}" for k, v in astats.items()) + f" [{card}]")
    asm_same = [n for n, _ in contigs
                if asm_recs["cuda"].get(n) == asm_recs["host"].get(n)]
    say(f"asm: {len(contigs)} contigs, {contig_bases} bp; records equal to "
        f"the port's host path for {len(asm_same)}/{len(contigs)} contigs "
        f"({sum(len(v) for v in asm_recs['host'].values())} host records); "
        f"round-1 blocks chained by the kernel {int(astats['stream_engaged'])}/"
        f"{round1} ({int(astats['stream_rows'])} anchors in all, frontier "
        f"included, {int(astats['stream_max_rows'])} in the largest block); device {asm_secs['cuda']:.3f} s "
        f"({contig_bases / asm_secs['cuda'] / 1e6:.4f} Mbp/s; mapping alone "
        f"{mapping_seconds(asm_err['cuda']):.1f} s, stream chain device calls "
        f"{astats['stream_device_s']:.6f} s of it: set-up "
        f"{astats['setup_s']:.6f} s, prepare and pack {astats['prep_s']:.6f} "
        f"s, copies {astats['copy_s']:.6f} s, kernel {astats['kernel_s']:.6f} "
        f"s), host path "
        f"{asm_secs['host']:.3f} s ({contig_bases / asm_secs['host'] / 1e6:.4f} "
        f"Mbp/s; mapping alone {mapping_seconds(asm_err['host']):.1f} s), one "
        f"CLI process each, start to exit [{card}]")
    path_launches["asm"] = {"chain_dp_large": int(astats["warm_launches"]),
                            "chain_dp": int(astats["chain_launches"])}
    for n, _ in contigs:
        if not any(not int(r[1]) & 4 for r in asm_recs["host"].get(n, [])):
            fail(f"asm: the host path aligned no record of {n}")
    if len(asm_same) != len(contigs):
        fail(f"asm: records differ from the port's host path: "
             f"{ {n: (asm_recs['cuda'].get(n), asm_recs['host'].get(n)) for n, _ in contigs if n not in asm_same} }"[:3000])
    if (astats["stream_engaged"] != round1 or round1 < ASM_BIG // 100_000
            or astats["declined_size"] or astats["declined_coords"]):
        fail(f"asm: not every round-1 block was chained by the kernel: {astats}")
    # every block is one launch, and the 480 kb contig's cold DP one more
    if astats["warm_launches"] < round1 + 1:
        fail(f"asm: the warm kernel launched {astats['warm_launches']} times for "
             f"{round1} blocks and one contig under 500 kb")
    # ---- 9. mesh and 10. entry ----------------------------------------
    path_launches["mesh"] = mesh_phase(torch, dev, gcodes, cfg0, card,
                                       reset_launches, read_launches)
    path_launches["entry"] = entry_phase(torch, reset_launches,
                                         read_launches)
    if "jax" in sys.modules or "vacmap_tpu" in sys.modules:
        fail("jax or the JAX package was imported")

    replaces = {
        "chain_dp": ("vacmap_tpu_torch/csrc/chain_dp.cu",
                     "vacmap_tpu/ops/chain_jax.py:147"),
        "chain_dp_large": ("vacmap_tpu_torch/csrc/chain_dp_large.cu",
                           "vacmap_tpu/ops/chain_jax.py:247"),
        "fill_full": ("vacmap_tpu_torch/csrc/fill_full.cu",
                      "vacmap_tpu/ops/affine_pallas.py:172"),
        "fill_banded": ("vacmap_tpu_torch/csrc/fill_banded.cu",
                        "vacmap_tpu/ops/affine_pallas.py:423"),
        "fill_scan": ("vacmap_tpu_torch/csrc/fill_scan.cu",
                      "vacmap_tpu/ops/affine_pallas.py:291"),
        "myers": ("vacmap_tpu_torch/csrc/myers.cu",
                  "examples/myers_pallas_device.py:151"),
        "affine_band": ("vacmap_tpu_torch/csrc/affine_band.cu",
                        "vacmap_tpu/ops/affine_jax.py:51"),
    }
    lines = []
    for k, (src, rep) in replaces.items():
        by_path = {p: n[k] for p, n in path_launches.items()
                   if n.get(k, 0) > 0}
        if not by_path:
            fail(f"{k} never launched on any path: {path_launches}")
        lines.append(dict(name=k, route="cuda", source=src, replaces=rep,
                          launches=sum(by_path.values()),
                          launches_by_path=by_path, **summary[k]))
    say(json.dumps({"kernels": lines}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
