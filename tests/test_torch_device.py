"""vacmap_tpu_torch never imports jax, and never hides a missing card or a
missing compiler behind the plain versions."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vacmap_tpu_torch import DeviceKernelError, resolve_device
from vacmap_tpu_torch.ops import affine_fill, chain
from vacmap_tpu_torch.parallel.device_service import TorchAggregatingChainBackend

REPO = Path(__file__).resolve().parent.parent


def _port_modules():
    pkg = REPO / "vacmap_tpu_torch"
    mods = []
    for f in sorted(pkg.rglob("*.py")):
        parts = f.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__main__":
            continue  # runs its command line on import
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def _run(code):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax nor the JAX
    package."""
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'vacmap_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_port_imports_with_jax_blocked():
    """Every module of the port imports with ``jax`` and ``vacmap_tpu``
    both unimportable (the card's machine has no jax, and the port is a
    package of its own): the worker loop, the writer and the fill client
    are the port's."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vacmap_tpu'] = None\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from vacmap_tpu_torch.cli import _worker, _worker_loop, _writer\n"
        "from vacmap_tpu_torch.parallel.fill_service import FillClient\n"
        "assert FillClient.__mro__[1] is object\n"
        "print('ok')\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_resolve_device_checks_the_card_index(monkeypatch):
    """``cuda:N`` names one of the visible cards or raises; ``cuda`` needs
    one card at least."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_device("cuda") == torch.device("cuda")
    assert resolve_device("cuda:1") == torch.device("cuda:1")
    with pytest.raises(DeviceKernelError, match="sees 2 CUDA cards"):
        resolve_device("cuda:2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(DeviceKernelError, match="sees 1 CUDA card"):
        resolve_device("cuda:1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for name in ("cuda", "cuda:0"):
        with pytest.raises(DeviceKernelError, match="no CUDA card"):
            resolve_device(name)


def test_resolve_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(DeviceKernelError):
        resolve_device("cuda")


def test_wrappers_raise_off_cpu_instead_of_plain_version():
    """A tensor that is not on the CPU never reaches the plain version."""
    meta = dict(device="meta")
    with pytest.raises(DeviceKernelError):
        chain.chain_scores_batch(
            torch.empty((1, 128, 4), dtype=torch.int32, **meta),
            torch.empty((1,), dtype=torch.int32, **meta),
            torch.empty((1, 128), **meta),
            torch.empty((1, 128), dtype=torch.int32, **meta))
    with pytest.raises(DeviceKernelError):
        chain.chain_scores_batch_warm(
            torch.empty((1, 128, 4), dtype=torch.int32, **meta),
            torch.empty((1,), dtype=torch.int32, **meta),
            torch.empty((1, 128), **meta),
            torch.empty((1, 128), dtype=torch.int32, **meta),
            torch.empty((1, 128), **meta),
            torch.empty((1, 128), dtype=torch.int32, **meta),
            torch.empty((1,), dtype=torch.int32, **meta))
    with pytest.raises(DeviceKernelError):
        affine_fill.fill_rowruns(
            torch.empty((1, 256), dtype=torch.uint8, **meta),
            torch.empty((1, 256), dtype=torch.uint8, **meta),
            torch.empty((1, 2), dtype=torch.int32, **meta))
    with pytest.raises(DeviceKernelError):
        affine_fill.fill_rowruns_banded(
            torch.empty((1, 256), dtype=torch.uint8, **meta),
            torch.empty((1, 384), dtype=torch.uint8, **meta),
            torch.empty((1, 2), dtype=torch.int32, **meta))
    with pytest.raises(DeviceKernelError):
        affine_fill.fill_traceback(
            torch.empty((1, 256), dtype=torch.uint8, **meta),
            torch.empty((1, 256), dtype=torch.uint8, **meta),
            torch.empty((1,), dtype=torch.int32, **meta),
            torch.empty((1,), dtype=torch.int32, **meta))


def test_cuda_backends_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    pair = (np.array([0, 1, 2, 3] * 10, np.uint8),
            np.array([0, 1, 2, 3] * 10, np.uint8))
    with pytest.raises(DeviceKernelError):
        affine_fill.TorchFillAligner(device="cuda").align_batch([pair], eqx=True)
    A = np.zeros((5, 4), np.int64)
    A[:, 0] = np.arange(5) * 30
    A[:, 1] = 1000 + np.arange(5) * 30
    A[:, 2] = 1
    A[:, 3] = 15
    be = TorchAggregatingChainBackend("cuda", max_wait_ms=0.0)
    with pytest.raises(DeviceKernelError):
        be(A, "fine", 9, 40.0, 30, 99)


def test_build_raises_without_nvcc():
    from vacmap_tpu_torch import _build

    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is present")
    so = _build.BUILD_DIR / _build.LIB_NAME
    if so.exists():
        pytest.skip("a built library is present")
    with pytest.raises(DeviceKernelError, match="nvcc"):
        _build.build()


@pytest.mark.parametrize("path", [
    "pipeline.executor:TorchBatchExecutor",
    "parallel.device_service:TorchAggregatingChainBackend",
    "ops.chain:TorchChainBackend",
    "ops.chain:TorchStreamChainBackend",
    "ops.myers:TorchMyersAligner",
    "ops.affine_fill:TorchFillAligner",
    "ops.affine_batch:BatchAligner",
])
def test_constructors_have_no_default_device(path):
    """A caller that forgets the device must hear of it: no constructor of
    the port falls back to the CPU (or to any device) on its own."""
    import importlib
    import inspect

    mod, name = path.split(":")
    cls = getattr(importlib.import_module(f"vacmap_tpu_torch.{mod}"), name)
    param = inspect.signature(cls.__init__).parameters["device"]
    assert param.default is inspect.Parameter.empty
    args = (None,) if name == "TorchBatchExecutor" else ()
    with pytest.raises(TypeError, match="device"):
        cls(*args)
