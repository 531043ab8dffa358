"""Device selection and the kernel wrappers' helpers.  The error they
raise is ``errors.DeviceKernelError``, re-exported here."""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from .errors import DeviceKernelError


def resolve_device(name: str = "cuda") -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) or ``"cpu"`` -> torch.device.  Raises
    when CUDA is asked for and no card is visible, or card N is not.

    Safe before a fork: ``torch.cuda.device_count()`` asks NVML first and
    then does not set CUDA up in this process, so a forked child (the
    fill service) can still do so."""
    dev = torch.device(name)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if n < 1:
            raise DeviceKernelError(
                f"device {name!r} requested but torch sees no CUDA card")
        if dev.index is not None and dev.index >= n:
            raise DeviceKernelError(
                f"device {name!r} requested but torch sees {n} CUDA "
                f"card{'s' if n > 1 else ''}")
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


@contextmanager
def launch_stream(device: torch.device):
    """Make ``device`` the current CUDA device for the block and yield the
    raw handle of torch's current stream on it, for a ctypes launch: the
    kernels launch into the current device's context, and their host
    code reads it (``cudaFuncSetAttribute``, ``cudaGetDevice``)."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream
