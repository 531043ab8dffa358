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


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import vacmap_tpu_torch, vacmap_tpu_torch.cli, vacmap_tpu_torch._build\n"
        "import vacmap_tpu_torch.pipeline.executor, vacmap_tpu_torch.ops.chain\n"
        "import vacmap_tpu_torch.ops.affine_fill\n"
        "import vacmap_tpu_torch.parallel.device_service\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


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
        affine_fill.fill_rowruns(
            torch.empty((1, 256), dtype=torch.uint8, **meta),
            torch.empty((1, 256), dtype=torch.uint8, **meta),
            torch.empty((1, 2), dtype=torch.int32, **meta))
    with pytest.raises(DeviceKernelError):
        affine_fill.fill_rowruns_banded(
            torch.empty((1, 256), dtype=torch.uint8, **meta),
            torch.empty((1, 384), dtype=torch.uint8, **meta),
            torch.empty((1, 2), dtype=torch.int32, **meta))


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
