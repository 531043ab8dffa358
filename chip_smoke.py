#!/usr/bin/env python3
"""Drive the vacmap_tpu_torch mode-H path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one result line; any failure exits non-zero before
the final line):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds csrc/*.cu into build/vacmap_tpu_torch/;
  3. data: the benchmark's 100 Mb genome (tandem arrays, a segmental
     duplication; seed 20260816), its first 256 reads of 20 kb at 5%
     ONT-like error (1/3 plain, 1/3 mid-read inversion, 1/3 3 kb
     deletion) and 16 more with a 120-250 bp deletion;
  4. kernels: every kernel against its plain PyTorch version on the card
     at main-path shapes (chain S within 1e-3 and P agreement >= 0.999;
     fill planes byte-identical), plus >= 2000 realistic fill jobs through
     TorchFillAligner against the host aligner's CIGARs;
  5. end to end: the port's CLI maps the reads (--device cuda) in this
     process; every kernel of the path must have launched, every read
     must align, and >= 99% of reads must have the same records (SAM
     columns 1-6) as the vacmap_tpu host path.  The throughput of both
     comes from one more run of each CLI as a process of its own, timed
     from its start to its exit.
Kernel times are device time per call (CUDA events around calls queued
behind a GPU sleep, so no host work is in the window); "wrapper" is the
stream time per call of back-to-back wrapper calls, host work included,
and "plain" the stream time of one call of the plain PyTorch version.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.  Exits non-zero, with no result, when
no CUDA card is visible or the package is not beside this script.
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
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


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


def cli_process(args, env):
    """Run ``python <args>`` as a process of its own; returns (wall s,
    result).  The window is the process's whole life: interpreter start,
    imports, device set-up, index load, mapping, SAM closed."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, timeout=900, env=env)
    return time.perf_counter() - t0, p


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


# ---------------------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    try:
        from vacmap_tpu_torch import _build, cli
        from vacmap_tpu_torch.ops import affine_fill as af
        from vacmap_tpu_torch.ops import chain
    except ImportError as err:
        fail(f"vacmap_tpu_torch is not importable beside this script: {err}")

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

    # ---- 3. data --------------------------------------------------------
    t0 = time.perf_counter()
    gcodes, reads = make_corpus()
    read_bases = sum(len(c) for _, c in reads)
    say(f"data: genome {len(gcodes)} bp, {len(reads)} reads, {read_bases} bp "
        f"in {time.perf_counter() - t0:.1f} s")

    # ---- 4. kernel phases -----------------------------------------------
    rng = np.random.default_rng(SEED + 1)
    args0 = cli.parser().parse_args(["-ref", "-", "-read", "-", "-mode", "H"])
    cfg0 = cli.config_from_args(args0)
    skip_g, maxdiff_g, maxgap_g = cfg0.chain_params_global()
    skip_l, maxdiff_l, maxgap_l = cfg0.chain_params_local()
    summary = {}

    def chain_phase(variant, B, N):
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
        say(f"kernel chain_dp {variant} B={B} N={N}: max|dS|={err:.3g} "
            f"P agreement={agree:.6f} kernel {ms:.3f} ms (wrapper "
            f"{wrap_ms:.3f} ms) plain {plain_ms:.1f} ms [{card}] "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"chain_dp {variant} B={B} N={N} disagrees with its plain version")
        return err, ms, wrap_ms, plain_ms

    try:
        res = [chain_phase("global", 16, 8192), chain_phase("global", 64, 2048),
               chain_phase("fine", 64, 1024), chain_phase("mismatch", 64, 1024)]
    except SystemExit:
        raise
    except Exception as err:  # noqa: BLE001
        fail(f"chain_dp phase raised: {err!r}")
    def summarize(res):
        # errors over every phase; times of the first (largest) shape
        return dict(max_abs_err=max(r[0] for r in res), ms=res[0][1],
                    wrapper_ms=res[0][2], plain_ms=res[0][3])

    summary["chain_dp"] = summarize(res)

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
        say(f"kernel {name} B={len(pairs)} N={N}: planes "
            f"{'byte-identical' if err == 0 else 'DIFFER'}{extra} kernel "
            f"{ms:.3f} ms (wrapper {wrap_ms:.3f} ms) plain {plain_ms:.1f} ms "
            f"[{card}]")
        if err:
            fail(f"{name} N={N} planes differ from its plain version")
        return err, ms, wrap_ms, plain_ms

    try:
        res = []
        for N in (256, 512):
            pairs = fill_pairs(rng, gcodes, 256, N // 4, N, big_indel=0.3,
                               random_frac=0.05)
            res.append(fill_phase("fill_full", af.fill_rowruns,
                                  af.fill_rowruns_ref, N, pairs, False))
        summary["fill_full"] = summarize(res)
        res = []
        for T in (256, 512):
            pairs = fill_pairs(rng, gcodes, 256, T // 4, T - 100,
                               random_frac=0.05)
            res.append(fill_phase("fill_banded", af.fill_rowruns_banded,
                                  af.fill_rowruns_banded_ref, T, pairs, True))
        summary["fill_banded"] = summarize(res)
    except SystemExit:
        raise
    except Exception as err:  # noqa: BLE001
        fail(f"fill phase raised: {err!r}")

    # realistic jobs through the aligner vs the host aligner
    pairs = (fill_pairs(rng, gcodes, 1800, 10, 500, big_indel=0.05, n_frac=0.03)
             + fill_pairs(rng, gcodes, 150, 300, 700)
             + fill_pairs(rng, gcodes, 100, 1, 12))
    t0 = time.perf_counter()
    try:
        got = af.TorchFillAligner(device=dev).align_batch(pairs, eqx=True)
        torch.cuda.synchronize()
    except Exception as err:  # noqa: BLE001
        fail(f"TorchFillAligner raised: {err!r}")
    dt = time.perf_counter() - t0
    host = af.native.align2p_batch_native(pairs, eqx=True)
    if host is None:
        fail("native host aligner unavailable")
    bad = [i for i, (g, h) in enumerate(zip(got, host))
           if g.cigar != af.native.ops_to_cigar(h)]
    say(f"aligner: {len(pairs) - len(bad)}/{len(pairs)} CIGARs equal to the "
        f"host aligner (eqx) in {dt:.2f} s [{card}]")
    if bad:
        fail(f"TorchFillAligner CIGARs differ from the host aligner on jobs {bad[:20]}")

    # ---- 5. end to end ----------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="vacmap_smoke_") as wd:
        ref = os.path.join(wd, "ref.fa")
        rds = os.path.join(wd, "reads.fa")
        out = os.path.join(wd, "port.sam")
        host_out = os.path.join(wd, "host.sam")
        timed_out = os.path.join(wd, "port_timed.sam")
        write_fasta(ref, [("chr1", gcodes)])
        write_fasta(rds, reads)
        t0 = time.perf_counter()
        cli.load_or_build_index(ref, 15, 10, True)
        say(f"index: built and saved in {time.perf_counter() - t0:.1f} s")

        # the main path, in this process, for the launch counts
        for k in (chain.chain_scores_batch, af.fill_rowruns,
                  af.fill_rowruns_banded):
            k.launches = 0
        try:
            rc = cli.main(["-ref", ref, "-read", rds, "-mode", "H",
                           "--device", "cuda", "-o", out])
            torch.cuda.synchronize()
        except Exception as err:  # noqa: BLE001
            fail(f"port CLI raised: {err!r}")
        launches = {
            "chain_dp": chain.chain_scores_batch.launches,
            "fill_full": af.fill_rowruns.launches,
            "fill_banded": af.fill_rowruns_banded.launches,
        }
        if rc != 0:
            fail(f"port CLI exited {rc}")

        # both CLIs again as processes of their own, timed over the same
        # window (the host path writes the records the port is held to)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        common = ["-ref", ref, "-read", rds, "-mode", "H"]
        host_s, hp = cli_process(
            ["-m", "vacmap_tpu.cli", *common, "--backend", "numpy",
             "--device-fills", "off", "-o", host_out], env)
        if hp.returncode != 0:
            fail(f"host path exited {hp.returncode}: {hp.stderr[-2000:]}")
        port_s, pp = cli_process(
            ["-m", "vacmap_tpu_torch.cli", *common, "--device", "cuda", "-o",
             timed_out], env)
        if pp.returncode != 0:
            fail(f"port CLI process exited {pp.returncode}: {pp.stderr[-2000:]}")
        port_recs, host_recs = sam_records(out), sam_records(host_out)
        timed_same = sam_records(timed_out) == port_recs

    names = [n for n, _ in reads]
    aligned = sum(1 for n in names if any(
        not int(r[1]) & 4 for r in port_recs.get(n, [])))
    same = [n for n in names if port_recs.get(n) == host_recs.get(n)]
    differ = [n for n in names if port_recs.get(n) != host_recs.get(n)]
    agree = len(same) / len(names)
    say(f"e2e launches: chain_dp={launches['chain_dp']} "
        f"fill_banded={launches['fill_banded']} "
        f"fill_full={launches['fill_full']}")
    say(f"e2e: aligned {aligned}/{len(names)}; records equal to the host path "
        f"for {len(same)}/{len(names)} reads ({agree:.4f}); differ: {differ}")
    say(f"e2e (one CLI process each, start to exit): port "
        f"{read_bases / port_s / 1e6:.4f} Mbp/s ({port_s:.3f} s, --device "
        f"cuda, -t 4; records equal to the in-process run: {timed_same}) "
        f"host path {read_bases / host_s / 1e6:.4f} Mbp/s ({host_s:.3f} s, "
        f"4 fork workers) [{card}]")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path never launched: {launches}")
    if aligned != len(names):
        fail(f"only {aligned}/{len(names)} reads aligned")
    if agree < E2E_AGREE_MIN:
        fail(f"record agreement {agree:.4f} < {E2E_AGREE_MIN}")
    if "jax" in sys.modules:
        fail("jax was imported")

    replaces = {
        "chain_dp": ("vacmap_tpu_torch/csrc/chain_dp.cu",
                     "vacmap_tpu/ops/chain_jax.py:147"),
        "fill_full": ("vacmap_tpu_torch/csrc/fill_full.cu",
                      "vacmap_tpu/ops/affine_pallas.py:172"),
        "fill_banded": ("vacmap_tpu_torch/csrc/fill_banded.cu",
                        "vacmap_tpu/ops/affine_pallas.py:423"),
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches[k], **summary[k])
               for k, (src, rep) in replaces.items()]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
