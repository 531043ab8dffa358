"""Build and load the CUDA kernels of this package.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a
plain C interface, ``build/vacmap_tpu_torch/libvacmap_kernels.so`` under
the checkout root, loaded with ctypes.  The build runs at first use and
is reused while a hash of the sources and flags is unchanged.  A missing
``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .device import DeviceKernelError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "vacmap_tpu_torch"
LIB_NAME = "libvacmap_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction and no fast math: the chain DP's f32 scores must
    # round like the reference's separate multiply and add
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures (csrc/*.cu, extern "C"): every pointer and the stream are
# c_void_p so ctypes passes full 64-bit values
_SIGNATURES = {
    "chain_dp_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                        _F, _P],
    "fill_full_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    "fill_banded_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise DeviceKernelError("nvcc not found (CUDA toolkit required to build "
                            "the vacmap_tpu_torch kernels)")


def build() -> Path:
    """Compile the kernels unless an up-to-date library exists; returns
    its path.  The compiler's ``-Xptxas -v`` report goes to nvcc.log
    beside the library."""
    digest = _digest()
    so = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if so.exists() and stamp.exists() and stamp.read_text() == digest:
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    r = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + r.stdout + r.stderr)
    if r.returncode != 0:
        raise DeviceKernelError(
            f"nvcc failed (rc {r.returncode}):\n{r.stderr[-4000:]}")
    os.replace(tmp, so)
    stamp.write_text(digest)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
