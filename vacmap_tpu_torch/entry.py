"""Entry points (counterpart of the JAX package's
``__graft_entry__.py``).

``entry(device)`` -> ``(fn, args)``: the batched non-linear chaining
kernel (csrc/chain_dp.cu on a card, its plain version on the CPU) with
the reference's arguments, and an example batch on ``device``.

``dryrun_multichip(n_devices, device)``: the whole device step of the read
path split over ``make_mesh(n_devices, device)``, then one real read batch
through ``TorchBatchExecutor`` over the same devices.

    python -m vacmap_tpu_torch.entry      # both, on every visible card
"""

from __future__ import annotations

import functools

import numpy as np


def _example_batch(B=4, N=128, seed=0):
    from .ops.chain import prepare_batch

    rng = np.random.default_rng(seed)
    alist = []
    for _ in range(B):
        r = np.arange(0, 1000, 40)
        y = r + 5000 + rng.integers(-3, 4, len(r))
        a = np.stack(
            [r, y, np.ones(len(r), np.int64), np.full(len(r), 15)], axis=1
        )
        alist.append(a)
    return prepare_batch(alist, "global", 40.0, 50)


def entry(device="cuda"):
    from .device import resolve_device
    from .ops.chain import chain_scores_batch, to_device

    dev = resolve_device(str(device))
    fn = functools.partial(
        chain_scores_batch,
        kmersize=15,
        maxdiff=50,
        maxgap=1000,
        skipcost=40.0,
        variant="global",
    )
    return fn, to_device(dev, *_example_batch())


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Every device kernel of the read path (global chain, local
    re-chain, full-width fill) split over ``n_devices`` devices in one
    step, the R-mode refund chain over the same devices, then one batch of
    real reads through the production executor with both chain DPs split
    over them.  ``device="cuda"`` raises DeviceKernelError when fewer
    cards are visible; ``"cpu"`` runs the plain versions on n CPU
    entries."""
    from .config import AlignerConfig
    from .index import ReferenceIndex
    from .ops.chain import prepare_batch
    from .parallel.device_service import TorchAggregatingChainBackend
    from .parallel.mesh import ShardedChainStep, ShardedMappingStep, make_mesh
    from .pipeline.executor import TorchBatchExecutor
    from .pipeline.mapper import Mapper

    devices = make_mesh(n_devices, device)
    B = n_devices * 2
    anchors, n_valid, skip_i, maxdiff_i = _example_batch(B=B, N=128)

    # local (k=9) anchors: a fine-scale colinear run per read
    rng = np.random.default_rng(1)
    l_list = []
    for _ in range(B):
        r = np.arange(0, 400, 12)
        y = r + 9000 + rng.integers(-2, 3, len(r))
        l_list.append(np.stack(
            [r, y, np.ones(len(r), np.int64), np.full(len(r), 9)], axis=1
        ))
    l_anchors, l_valid, l_skip, l_maxdiff = prepare_batch(
        l_list, "fine", 30.0, 30
    )
    # fill pairs: mutated copies
    T = 128
    tg = rng.integers(0, 4, (B, T)).astype(np.uint8)
    qr = tg.copy()
    mut = rng.random((B, T)) < 0.05
    qr[mut] = rng.integers(0, 4, int(mut.sum()))
    t_len = np.full(B, T - 8, np.int32)
    q_len = np.full(B, T - 8, np.int32)

    step = ShardedMappingStep(devices)
    out = step(
        anchors, n_valid, skip_i, maxdiff_i,
        l_anchors, l_valid, l_skip, l_maxdiff, tg, qr, t_len, q_len,
    )
    assert out[0].shape[0] == B and out[4].shape == (B, 2 * T)
    assert out[5] >= 0

    # R-mode refund ledger path over the same devices
    step_r = ShardedChainStep(devices, variant="refund", skipcost=30.0)
    step_r(anchors, n_valid, skip_i, maxdiff_i)

    # the production executor over the same devices: the global chain
    # through its ShardedChainStep, the local fine/mismatch DPs through the
    # aggregating backend's; one real read batch end to end
    bases = np.frombuffer(b"ACGT", np.uint8)
    g = rng.integers(0, 4, 60_000)
    genome = {"c1": bases[g].tobytes().decode()}
    idx = ReferenceIndex.build(genome, k=15, w=10)
    reads = []
    for i in range(n_devices):
        st = int(rng.integers(0, 50_000))
        reads.append((f"d{i}", genome["c1"][st : st + 8_000]))
    ex = TorchBatchExecutor(
        Mapper(idx, AlignerConfig(mode="H"), device=devices[0]), devices[0],
        devices=devices)
    try:
        assert ex.devices is not None and len(ex.devices) == n_devices
        be = ex.mapper.chain_backend
        assert isinstance(be, TorchAggregatingChainBackend)
        assert be.devices == ex.devices
        lines = ex.map_batch(reads, n_threads=2)
    finally:
        ex.close()
    assert sum(len(x) for x in lines) >= n_devices  # every read mapped
    assert ex._sharded_steps  # the global chain ran the split step
    assert be._steps  # the local DPs ran it too


if __name__ == "__main__":
    import torch

    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", [tuple(x.shape) for x in out])
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip ok on", torch.cuda.device_count(), "devices")
