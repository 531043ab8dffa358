"""Device lists and data-parallel steps over them (counterpart of
``vacmap_tpu/parallel/mesh.py``).

The reference shards a read batch along the 'dp' axis of a
``jax.sharding.Mesh`` and runs the chaining and fill kernels pjit-ted over
it.  torch has no mesh: here a "mesh" is a list of ``torch.device``s.  A
step cuts the batch into contiguous parts, one a device, launches every
part on its device (on a CUDA stream of the part's own) before it reads
any result back, and concatenates the parts on the host.  Reads never
talk to each other, so no device collective is needed: the reference's
one cross-device reduction (a psum of accepted chains) is a sum on the
host.  Multi-host runs boot a gloo process group from ``--coordinator``
(``initialize_distributed``); the reads themselves are sharded by the
CLI, across processes, with no collective at all.

Measured so far on one card only (two parts on one H100, each on a
stream of its own); no multi-card number exists yet.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import threading
from typing import ClassVar, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceKernelError
from ..ops.chain import chain_scores_batch, to_device

# a missing peer ends the rendezvous and the boot barrier with an error
# after this many seconds instead of a hang
DIST_TIMEOUT_S = 300.0


def make_mesh(n_devices: Optional[int] = None,
              device: str = "cuda") -> List[torch.device]:
    """The device list of a data-parallel step.  ``device="cuda"``: the
    visible cards ``cuda:0 .. cuda:k-1``, or the first ``n_devices`` of
    them; raises DeviceKernelError when fewer are visible (there is no
    fallback to the CPU).  ``device="cpu"``: ``n_devices`` (default 1)
    entries of ``torch.device("cpu")``, the plain versions' stand-in for
    a multi-device host."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    visible = torch.cuda.device_count()
    want = visible if n_devices is None else n_devices
    if visible < 1 or want > visible:
        raise DeviceKernelError(
            f"a mesh of {want} CUDA devices requested but torch sees "
            f"{visible}")
    return [torch.device("cuda", i) for i in range(want)]


class _Parts:
    """One CUDA stream per part of a step, made at first use.  A CPU part
    has none and runs in the calling thread."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a step needs at least one device")
        self._streams = None
        self._lock = threading.Lock()

    def streams(self):
        with self._lock:
            if self._streams is None:
                self._streams = [
                    torch.cuda.Stream(device=d) if d.type == "cuda" else None
                    for d in self.devices]
        return self._streams

    def run(self, launch, arrays):
        """``launch(*tensors)`` on one contiguous part a device of
        ``arrays`` (numpy, batch first, the batch a multiple of the device
        count): all parts launched, then all read back.  Returns each
        output's numpy parts concatenated."""
        per = arrays[0].shape[0] // len(self.devices)
        pending = []
        for k, (dev, stream) in enumerate(zip(self.devices, self.streams())):
            # the part's inputs are copied on its own stream (and its
            # device; a CPU part has no stream), so nothing it reads was
            # made on another stream
            with torch.cuda.stream(stream):
                part = to_device(dev, *(a[k * per : (k + 1) * per]
                                        for a in arrays))
                pending.append((stream, launch(*part)))
        host = []
        for stream, outs in pending:
            with torch.cuda.stream(stream):
                host.append([o.cpu().numpy() for o in outs])
        return [np.concatenate(col) for col in zip(*host)]


@dataclasses.dataclass
class ShardedChainStep:
    """The batched chaining step over a device list: the batch cut into
    one contiguous part a device, ``chain_scores_batch`` launched on each
    (csrc/chain_dp.cu on a card, its plain version on the CPU), and the
    count of accepted chains summed on the host (the reference's psum).

    ``__call__`` takes prepare_batch's numpy arrays and returns ``(S, P,
    best, n_accepted)``: S, P and best cut back to the B rows given,
    n_accepted an int over the padded batch, as in the reference."""

    devices: Sequence[torch.device]
    kmersize: int = 15
    maxdiff: int = 50
    maxgap: int = 1000
    skipcost: float = 40.0
    variant: str = "global"
    accept_score: float = 60.0

    def __post_init__(self):
        self._parts = _Parts(self.devices)
        self.devices = self._parts.devices

    def _launch(self, anchors, n_valid, skip_i, maxdiff_i):
        S, P = chain_scores_batch(
            anchors, n_valid, skip_i, maxdiff_i, kmersize=self.kmersize,
            maxdiff=self.maxdiff, maxgap=self.maxgap,
            skipcost=self.skipcost, variant=self.variant)
        return S, P, S.max(dim=1).values

    def pad_batch(self, anchors, n_valid, skip_i, maxdiff_i):
        """Pad the batch dim to a multiple of the device count with zero
        rows (n_valid = 0: they change nothing)."""
        B = anchors.shape[0]
        pad = -B % len(self.devices)
        return (*(np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
                  for a in (anchors, n_valid, skip_i, maxdiff_i)), B)

    def __call__(self, anchors, n_valid, skip_i, maxdiff_i):
        anchors, n_valid, skip_i, maxdiff_i, B = self.pad_batch(
            anchors, n_valid, skip_i, maxdiff_i)
        S, P, best = self._parts.run(
            self._launch, (anchors, n_valid, skip_i, maxdiff_i))
        n_accepted = int((best > self.accept_score).sum())
        return S[:B], P[:B], best[:B], n_accepted


def cached_chain_step(cache: dict, devices, variant: str, kmersize: int,
                      skipcost: float, maxdiff: int, maxgap: int):
    """The ShardedChainStep of one chain parameter set over ``devices``,
    kept in ``cache`` (None without a device list).  Two threads may both
    make one; setdefault keeps the first."""
    if devices is None:
        return None
    key = (variant, kmersize, float(skipcost), int(maxdiff), int(maxgap))
    step = cache.get(key)
    if step is None:
        step = cache.setdefault(key, ShardedChainStep(
            devices, kmersize=kmersize, maxdiff=maxdiff, maxgap=maxgap,
            skipcost=skipcost, variant=variant))
    return step


@dataclasses.dataclass
class ShardedMappingStep:
    """Every device kernel of the reference's mapping step, split over a
    device list in one step: the global chain DP and the local (fine)
    re-chain DP (csrc/chain_dp.cu), then the banded global affine DP of
    the step's target/query pairs at W = fill_band with the reference's
    default scores (``ops/affine_batch.affine_batch``, csrc/affine_band.cu),
    as ``vacmap_tpu/parallel/mesh.py::ShardedMappingStep`` runs them.  Host
    glue (backtrack, harvest, SAM) runs between production calls; here the
    kernels run back to back, so a dry run shows that the whole device
    step builds and runs on n devices.

    ``__call__(anchors, n_valid, skip_i, maxdiff_i, l_anchors, l_valid,
    l_skip, l_maxdiff, targets, queries, t_len, q_len)``, numpy arrays
    with the batch first (a multiple of the device count, as the
    reference's sharded step requires; targets (B, T) and queries (B, Q)
    uint8 planes), returns ``(S_g, P_g, S_l, P_l, best, n_mapped)``: numpy
    arrays, ``best`` each pair's best cell (float32, (B,)), and the count
    of reads whose best global chain scores over 60."""

    devices: Sequence[torch.device]
    # the reference step's fill_len and fill_band, fixed here: the pair
    # length a dry run builds and the band the fill runs at
    fill_len: ClassVar[int] = 128
    fill_band: ClassVar[int] = 32

    def __post_init__(self):
        self._parts = _Parts(self.devices)
        self.devices = self._parts.devices

    def _launch(self, anchors, n_valid, skip_i, maxdiff_i, l_anchors, l_valid,
                l_skip, l_maxdiff, targets, queries, t_len, q_len):
        from ..ops.affine_batch import affine_batch

        S_g, P_g = chain_scores_batch(
            anchors, n_valid, skip_i, maxdiff_i, kmersize=15, maxdiff=50,
            maxgap=1000, skipcost=40.0, variant="global")
        S_l, P_l = chain_scores_batch(
            l_anchors, l_valid, l_skip, l_maxdiff, kmersize=9, maxdiff=30,
            maxgap=99, skipcost=30.0, variant="fine")
        best = affine_batch(targets, queries, t_len, q_len,
                            W=self.fill_band, zdrop=-1, glob=True)[1]
        return S_g, P_g, S_l, P_l, best, S_g.max(dim=1).values

    def __call__(self, anchors, n_valid, skip_i, maxdiff_i, l_anchors,
                 l_valid, l_skip, l_maxdiff, targets, queries, t_len, q_len):
        B = anchors.shape[0]
        if B % len(self.devices):
            raise ValueError(f"a batch of {B} does not split over "
                             f"{len(self.devices)} devices")
        *outs, chain_best = self._parts.run(
            self._launch,
            (anchors, n_valid, skip_i, maxdiff_i, l_anchors, l_valid, l_skip,
             l_maxdiff, np.asarray(targets, np.uint8),
             np.asarray(queries, np.uint8), np.asarray(t_len, np.int32),
             np.asarray(q_len, np.int32)))
        return (*outs, int((chain_best > 60.0).sum()))


_GROUP_UP = False


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: int = 1,
    process_id: int = 0,
) -> bool:
    """Multi-host bring-up; a no-op (False) without a coordinator.

    Otherwise joins a gloo process group at ``tcp://<coordinator>`` (the
    host:port of process 0, which serves the rendezvous) as rank
    ``process_id`` of ``num_processes``, then passes a barrier, so the
    group is known to work and not merely connected (the reference's
    ``jax.distributed.initialize`` and ``sync_global_devices``).  gloo and
    not nccl: the reads are independent, so the run needs no device
    collective, and nccl refuses two ranks on one card.  A peer missing
    for DIST_TIMEOUT_S raises instead of hanging.  The group is torn down
    by ``shutdown_distributed`` or at exit."""
    global _GROUP_UP
    if coordinator is None:
        return False
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    _GROUP_UP = True
    atexit.register(shutdown_distributed)
    dist.barrier()
    return True


def shutdown_distributed() -> None:
    """Tear down the process group ``initialize_distributed`` made, if
    any (idempotent)."""
    global _GROUP_UP
    if not _GROUP_UP:
        return
    import torch.distributed as dist

    _GROUP_UP = False
    if dist.is_initialized():
        dist.destroy_process_group()
