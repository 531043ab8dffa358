"""vacmap-tpu on PyTorch and CUDA: the batched mode-H mapping path with
hand-written Hopper (sm_90a) kernels for the chain DP and the two
base-level fill kernels.

The host layers (index, seeding, backtrack, harvest, refinement, SAM)
are imported from ``vacmap_tpu``, which stays the reference; this
package replaces only the modules that ran on the accelerator.  It
never imports ``jax``.
"""

from .device import DeviceKernelError, resolve_device

__all__ = ["DeviceKernelError", "resolve_device"]
