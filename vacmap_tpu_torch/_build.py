"""Build and load the CUDA kernels of this package.

``nvcc`` compiles every ``csrc/*.cu`` (one compiler process per source,
all started together) and links the objects into one shared library with
a plain C interface, ``build/vacmap_tpu_torch/libvacmap_kernels.so``
under the checkout root, loaded with ctypes.  The host C++ library
(``native/``) builds into the same directory.  The build runs at first use
and is reused while a hash of the sources and flags is unchanged.  A
missing ``nvcc`` or a failed build raises: there is no fallback.
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
    "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
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
                        _F, _I, _P],
    "chain_dp_warm_launch": [_P] * 10 + [_I, _I, _I, _I, _I, _F, _I, _F, _P],
    "chain_dp_warm_scratch_bytes": [_I, _I],
    "fill_full_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    "fill_banded_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P],
    "fill_scan_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P],
    "myers_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
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
    tag = f"{os.getpid()}.tmp"
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    units = [p for p in _sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{p.stem}.{tag}.o" for p in units]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
            for p, o in zip(units, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    results = [(c, p.communicate()[0], p.returncode)
               for c, p in zip(cmds, procs)]
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    if all(rc == 0 for _, _, rc in results):
        r = subprocess.run(link, capture_output=True, text=True)
        results.append((link, r.stdout + r.stderr, r.returncode))
    (BUILD_DIR / "nvcc.log").write_text("".join(
        " ".join(c) + "\n" + out for c, out, _ in results))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(c, out, rc) for c, out, rc in results if rc != 0]
    if failed:
        c, out, rc = failed[0]
        raise DeviceKernelError(
            f"nvcc failed (rc {rc}) on {c[-1]}:\n{out[-4000:]}")
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
                fn.restype = (ctypes.c_longlong if name.endswith("_bytes")
                              else ctypes.c_int)
            _lib = lib
        return _lib
