"""Device selection and the error every kernel wrapper raises."""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch


class DeviceKernelError(RuntimeError):
    """A kernel of this package failed to build, to launch or to run, or a
    device call around it failed.  Never caught by the mapping pipeline:
    a device fault stops the run instead of degrading to the host path."""


def resolve_device(name: str = "cuda") -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) or ``"cpu"`` -> torch.device.  Raises
    when CUDA is asked for and no card is visible.

    Safe before a fork: ``torch.cuda.device_count()`` asks NVML first and
    then does not set CUDA up in this process, so a forked child (the
    fill service) can still do so."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if torch.cuda.device_count() < 1:
            raise DeviceKernelError(
                f"device {name!r} requested but torch sees no CUDA card")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {name!r} (cuda or cpu)")


_count_lock = threading.Lock()


def count_launch(wrapper, shape=None) -> None:
    """Add one to ``wrapper.launches`` (and, given the launch's shape, to
    its entry in ``wrapper.shapes``).  Kernel wrappers call this right
    where they launch their kernel, and nowhere else."""
    with _count_lock:
        wrapper.launches += 1
        if shape is not None:
            wrapper.shapes[shape] = wrapper.shapes.get(shape, 0) + 1


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise DeviceKernelError unless ``t`` is a contiguous ``dtype``
    tensor of ``shape`` on ``device`` (the kernels take raw pointers)."""
    if t.device != device:
        raise DeviceKernelError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise DeviceKernelError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise DeviceKernelError(
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise DeviceKernelError(f"{name} is not contiguous")


@contextmanager
def device_call(what: str):
    """Re-raise any failure inside the block (a transfer, an allocation,
    a launch) as DeviceKernelError, so that callers which drop a read on
    a host error still stop on a device error."""
    try:
        yield
    except DeviceKernelError:
        raise
    except Exception as err:
        raise DeviceKernelError(f"{what} failed: {err}") from err


def cuda_stream(device: torch.device) -> int:
    """Raw handle of torch's current stream on ``device`` (for ctypes)."""
    return torch.cuda.current_stream(device).cuda_stream
