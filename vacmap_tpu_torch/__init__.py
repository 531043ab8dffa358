"""vacmap-tpu on PyTorch and CUDA: the mapping paths of ``vacmap_tpu``
(read modes through the batched executor or the fork pool with a device
fill service, and ``-mode asm`` with the streaming chain) with
hand-written Hopper (sm_90a) kernels for the chain DPs and the base-level
fills.

A package of its own: it keeps its own copy of the host layers (config,
index, io, the native C++ library, seeding, backtrack, harvest,
refinement, SAM) under the reference's file names, and imports neither
``vacmap_tpu`` nor ``jax``.  ``vacmap_tpu`` stays the reference that the
tests hold it against.
"""

from .device import DeviceKernelError, resolve_device

__all__ = ["DeviceKernelError", "resolve_device"]
