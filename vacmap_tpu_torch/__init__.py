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

Importing the package, or any of its host modules, does not import
torch: only the processes that launch a kernel load it, as the
reference's load jax.  ``resolve_device`` (from ``device.py``, which
imports torch) is resolved at first use.
"""

from .errors import DeviceKernelError

__all__ = ["DeviceKernelError", "resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
