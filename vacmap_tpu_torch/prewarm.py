"""Build the port's libraries and launch every kernel once per shape
family (counterpart of ``vacmap_tpu/prewarm.py``).

    python -m vacmap_tpu_torch.prewarm [--fills] [--chain] [--asm] [--all]
                                       [--device cuda|cpu]

On this card there is no per-shape compile to hide and no cache directory
to fill: "warm" means that the host C++ library and the CUDA kernel
library stand built under ``build/vacmap_tpu_torch/`` (once per checkout;
every later start loads them) and that each kernel has launched at each
of its shape families, so a fault in the build or in a launch shows here
and not in the middle of a run.

Shapes launched:
  fills  -- the fill service's buckets at their launch caps, banded, full
            width and the scan route (fill_service.DEFAULT_SHAPE_B), and
            the three Myers edit-distance buckets (ops.myers)
  chain  -- the batched executor's chain buckets (executor.N_BUCKETS) in
            the global variant and the two local ones (fine, mismatch)
  asm    -- the asm streaming warm-start chain, N = 1024 to 32,768

Without a card it raises, unless ``--device cpu``: then it builds the
host library and runs each wrapper's plain version once at a small batch
(a check of the entry point, nothing is warmed).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import _build, native
from .device import resolve_device
from .ops import affine_fill, myers
from .ops.affine_fill import BANDED, TorchFillAligner
from .ops.chain import (
    chain_scores_batch, chain_scores_batch_warm, prepare_batch, to_device,
)
from .parallel.fill_service import DEFAULT_SHAPE_B
from .pipeline.executor import N_BUCKETS


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prewarm_build(device) -> None:
    """The host library (g++) and, for a card, the kernel library (nvcc)."""
    t0 = time.time()
    if native.get_lib() is None:
        raise RuntimeError("the host C++ library did not build")
    print(f"host library: {time.time() - t0:.1f}s", flush=True)
    if device.type == "cuda":
        t0 = time.time()
        _build.library()
        print(f"kernel library ({_build.BUILD_DIR / _build.LIB_NAME}): "
              f"{time.time() - t0:.1f}s", flush=True)


def prewarm_fills(device) -> None:
    pa = TorchFillAligner(device=device)
    for bucket, b_max in sorted(DEFAULT_SHAPE_B.items()):
        B = b_max if device.type == "cuda" else 2
        for bid in ([bucket | BANDED, bucket] if pa.banded else [bucket]):
            t0 = time.time()
            pa.prewarm(batch_sizes=(B,), buckets=(bid,))
            name = f"banded {bucket}" if bid & BANDED else f"{bucket}"
            print(f"fill kernel (B={B}, N={name}): {time.time() - t0:.2f}s",
                  flush=True)
        t0 = time.time()
        plane = torch.full((B, bucket), 4, dtype=torch.uint8, device=device)
        plane[:, 0] = 1
        ones = torch.ones(B, dtype=torch.int32, device=device)
        affine_fill.fill_traceback(plane, plane.clone(), ones, ones)
        _sync(device)
        print(f"scan fill kernel (B={B}, N={bucket}): "
              f"{time.time() - t0:.2f}s", flush=True)
    ma = myers.TorchMyersAligner(device)
    for T, Wd in ma.buckets:
        t0 = time.time()
        ma.prewarm(buckets=((T, Wd),))
        print(f"myers kernel (T={T}, pattern <= {Wd * 32}): "
              f"{time.time() - t0:.2f}s", flush=True)


def _anchors(rng, n: int, span: int) -> np.ndarray:
    a = np.zeros((n, 4), np.int32)
    a[:, 0] = np.sort(rng.integers(0, span, n))
    a[:, 1] = rng.integers(0, 10 * span, n)
    a[:, 3] = 15
    return a


def prewarm_chain(device) -> None:
    rng = np.random.default_rng(0)
    for n in (N_BUCKETS if device.type == "cuda" else N_BUCKETS[:1]):
        t0 = time.time()
        a = _anchors(rng, n, 10_000)
        for variant in ("global", "fine", "mismatch"):
            batch = prepare_batch([a], variant, 40.0, 50)
            chain_scores_batch(*to_device(device, *batch), variant=variant)
        _sync(device)
        print(f"chain kernel (N={n}): {time.time() - t0:.2f}s", flush=True)


def prewarm_asm_stream(device, max_n: int = 1 << 15) -> None:
    """The warm-start (frontier-carry) chain kernel at the asm streaming
    path's block sizes: 100 kb blocks at w = 10 give 16 to 33 thousand
    anchors."""
    rng = np.random.default_rng(0)
    n = 1024
    while n <= (max_n if device.type == "cuda" else 1024):
        t0 = time.time()
        batch = prepare_batch([_anchors(rng, n, 100_000)], "global_nocov",
                              40.0, 50)
        N = batch[0].shape[1]
        chain_scores_batch_warm(
            *to_device(device, *batch, np.zeros((1, N), np.float32),
                       np.zeros((1, N), np.int32), np.zeros(1, np.int32)),
            variant="global_nocov")
        _sync(device)
        print(f"asm stream chain kernel (N={N}): {time.time() - t0:.2f}s",
              flush=True)
        n *= 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vacmap-tpu-torch prewarm",
                                description=__doc__.splitlines()[0])
    p.add_argument("--fills", action="store_true")
    p.add_argument("--chain", action="store_true")
    p.add_argument("--asm", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if not (args.fills or args.chain or args.asm):
        args.all = True
    device = resolve_device(args.device)  # raises when no card is visible
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain versions)")
    print(f"device: {kind}", flush=True)
    t0 = time.time()
    prewarm_build(device)
    if args.all or args.fills:
        prewarm_fills(device)
    if args.all or args.chain:
        prewarm_chain(device)
    if args.all or args.asm:
        prewarm_asm_stream(device)
    print(f"prewarm complete in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
