"""Which processes of the port import torch.  Only the processes that
launch a kernel load it (the executor, asm with --backend jax, the fill
service's own process), as the JAX package loads jax: the host path, the
asm host path, vacsim-tpu-torch and the index builder run with torch
unimportable and write what they write with it importable; in the fork
pool only the service process imports it.  Also: one DeviceKernelError
class, and the port's packaging file, which installs it without jax."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from chip_smoke import TORCH_RECORDER
from tests.conftest import random_dna

REPO = Path(__file__).resolve().parent.parent
BLOCK = "import sys\nsys.modules['torch'] = None\n"


def _python(code, cwd, torch_log=None, timeout=240):
    """``python -c code`` from ``cwd`` with the checkout importable; with
    ``torch_log``, every process of the run that imports torch appends
    its pid and name there (TORCH_RECORDER, inherited by forked
    children)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    if torch_log is not None:
        env["VACMAP_TORCH_LOG"] = str(torch_log)
        code = TORCH_RECORDER + code
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _cli(argv):
    return ("from vacmap_tpu_torch.cli import main\n"
            f"raise SystemExit(main({argv!r}))\n")


def _torch_loads(log):
    """[(pid, process name)] of the processes that imported torch."""
    if not log.exists():
        return []
    return [tuple(ln.split(" ", 1)) for ln in log.read_text().splitlines()]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    import numpy as np

    rng = np.random.default_rng(99)
    d = tmp_path_factory.mktemp("startup")
    genome = random_dna(rng, 60_000)
    (d / "ref.fa").write_text(f">t1\n{genome}\n")
    (d / "reads.fa").write_text("".join(
        f">r{i}\n{genome[st:st + 4000]}\n"
        for i, st in enumerate((1000, 20_000, 41_000))))
    (d / "params.txt").write_text("Specified{DEL:400:500;number=2}\n"
                                  "Specified{INV:300:600;number=1}\n")
    return d


def _outputs(d, tag, in_order=True):
    """{name: bytes} of the files a run wrote under ``d/tag``; without
    ``in_order`` (a fork pool's writer takes the workers' batches as they
    come), a SAM's records are sorted after its header."""
    root = d / tag
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            data = p.read_bytes()
            if not in_order and p.suffix == ".sam":
                lines = data.splitlines(keepends=True)
                head = [ln for ln in lines if ln.startswith(b"@")]
                data = b"".join(head + sorted(lines[len(head):]))
            out[str(p.relative_to(root))] = data
    return out


def _map_argv(d, out, *extra):
    return ["-ref", str(d / "ref.fa"), "-read", str(d / "reads.fa"),
            "--nowriteindex", "--force", "-o", str(out), *extra]


HOST_RUNS = {
    "host_t1": ("cli", ["-mode", "H", "--device-fills", "off", "-t", "1"]),
    "host_t2": ("cli", ["-mode", "H", "--backend", "numpy",
                        "--device-fills", "off", "-t", "2"]),
    "asm_host": ("cli", ["-mode", "asm"]),
    "vacsim": ("sim", []),
    "index": ("index", []),
}


def _host_code(d, kind, extra, tag):
    out = d / tag
    out.mkdir()
    if kind == "cli":
        return _cli(_map_argv(d, out / "out.sam", *extra))
    if kind == "sim":
        argv = ["-parameterfilepath", str(d / "params.txt"),
                "-inputgenomepath", str(d / "ref.fa"),
                "-altedgenomepath", str(out / "alt.fa"),
                "-outputvcfpath", str(out / "truth.vcf"),
                "-heterozygous_ratio", "0.5", "-seed", "7"]
        return ("from vacmap_tpu_torch.sim.vacsim import main\n"
                f"raise SystemExit(main({argv!r}))\n")
    return ("import runpy, sys\n"
            f"sys.argv = ['index', {str(d / 'ref.fa')!r}, "
            f"{str(out / 'ref.vmi')!r}]\n"
            "runpy.run_module('vacmap_tpu_torch.index', run_name='__main__')\n")


@pytest.mark.parametrize("name", list(HOST_RUNS))
def test_host_processes_run_without_torch(tiny, name):
    """With torch unimportable, each host deployment exits 0 and writes
    byte for byte what the same argv writes with torch importable (a run
    in which no process imported it either)."""
    kind, extra = HOST_RUNS[name]
    blocked = _python(BLOCK + _host_code(tiny, kind, extra, f"{name}_b"),
                      tiny)
    assert blocked.returncode == 0, blocked.stderr[-3000:]
    log = tiny / f"{name}_torch.log"
    free = _python(_host_code(tiny, kind, extra, f"{name}_f"), tiny,
                   torch_log=log)
    assert free.returncode == 0, free.stderr[-3000:]
    assert _torch_loads(log) == []
    in_order = "-t" not in extra or extra[extra.index("-t") + 1] == "1"
    got = _outputs(tiny, f"{name}_b", in_order)
    want = _outputs(tiny, f"{name}_f", in_order)
    assert got and got == want
    if kind == "cli":
        recs = [ln for ln in got["out.sam"].decode().splitlines()
                if not ln.startswith("@")]
        assert {ln.split("\t")[0] for ln in recs} == {"r0", "r1", "r2"}


@pytest.mark.parametrize("fills", ["on", "auto"])
def test_fork_pool_loads_torch_only_in_the_service(tiny, fills):
    """The fork pool's parent and its two mapping workers never import
    torch; the fill service's process does (under ``on`` the parent waits
    for it, so it must have; under ``auto`` a run may end before the
    service gets that far), and the records are the host path's."""
    out = tiny / f"pool_{fills}.sam"
    log = tiny / f"pool_{fills}_torch.log"
    r = _python(_cli(_map_argv(tiny, out, "-mode", "H", "-t", "2",
                               "--device", "cpu", "--device-fills", fills)),
                tiny, torch_log=log)
    assert r.returncode == 0, r.stderr[-3000:]
    loads = _torch_loads(log)
    assert [name for _, name in loads] == (
        ["fill-service"] if fills == "on" else ["fill-service"] * len(loads))
    assert len(loads) <= 1
    host = tiny / "pool_host.sam"
    h = _python(_cli(_map_argv(tiny, host, "-mode", "H", "-t", "1",
                               "--device-fills", "off")), tiny)
    assert h.returncode == 0, h.stderr[-3000:]

    def records(p):
        return sorted(ln for ln in p.read_text().splitlines()
                      if not ln.startswith("@"))

    assert records(out) == records(host)


def test_fork_pool_without_a_card_fails_in_the_service(tiny):
    """``--device cuda`` with no card: the parent no longer resolves the
    device, the service finds no card in its own process, and the run
    still exits non-zero naming the cause under ``auto`` (it does not
    finish on host fills), however soon the mapping ends."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = tiny / "pool_nocard.sam"
    r = _python(_cli(_map_argv(tiny, out, "-mode", "H", "-t", "2",
                               "--device", "cuda", "--device-fills", "auto")),
                tiny)
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr, r.stderr[-3000:]
    assert "DeviceKernelError" in r.stderr


def test_the_service_checks_for_its_card_without_torch(tiny):
    """The fill service's first step, ``_card_missing``, asks the CUDA
    driver and needs no torch: "cpu" needs no card, and on a machine
    without one "cuda" is refused at once."""
    import torch

    r = _python(BLOCK + "from vacmap_tpu_torch.parallel.fill_service "
                "import _card_missing\n"
                "print(_card_missing('cpu'))\n"
                "print(_card_missing('cuda'))\n", tiny)
    assert r.returncode == 0, r.stderr[-3000:]
    cpu, cuda = r.stdout.splitlines()
    assert cpu == "None"
    if not torch.cuda.is_available():
        assert "no CUDA card" in cuda


def test_one_device_kernel_error_class():
    import vacmap_tpu_torch
    from vacmap_tpu_torch import device, errors

    assert (vacmap_tpu_torch.DeviceKernelError is device.DeviceKernelError
            is errors.DeviceKernelError)
    assert vacmap_tpu_torch.resolve_device is device.resolve_device
    with pytest.raises(AttributeError):
        vacmap_tpu_torch.no_such_name  # noqa: B018


def test_every_ctypes_launch_is_bound_to_its_card():
    """Each ``lib.<kernel>_launch(...)`` of the wrappers runs inside
    ``with launch_stream(dev)``, which makes the tensors' card the
    current device (the launch's context, and the device the kernels'
    host code reads)."""
    n = 0
    for f in ("chain.py", "affine_fill.py", "myers.py"):
        tree = ast.parse((REPO / "vacmap_tpu_torch" / "ops" / f).read_text())
        bound = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.With) and any(
                    isinstance(i.context_expr, ast.Call)
                    and getattr(i.context_expr.func, "id", "") == "launch_stream"
                    for i in node.items):
                bound.update(id(c) for c in ast.walk(node))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and getattr(node.func.value, "id", "") == "lib"
                    and node.func.attr.endswith("_launch")):
                n += 1
                assert id(node) in bound, f"{f}:{node.lineno}"
    assert n == 6


def test_setup_torch_installs_the_port_without_jax(monkeypatch):
    """setup_torch.py's metadata, read without building or downloading:
    only the port's packages (with its CUDA and C++ sources), numpy and
    torch as requirements, and both console scripts."""
    from setuptools import find_packages

    import setuptools  # noqa: F401  (puts its distutils in place)
    from distutils.core import run_setup

    monkeypatch.chdir(REPO)
    dist = run_setup(str(REPO / "setup_torch.py"), stop_after="init")
    assert dist.get_name() == "vacmap-tpu-torch"
    pkgs = set(dist.packages)
    assert pkgs == set(find_packages(
        str(REPO), include=["vacmap_tpu_torch", "vacmap_tpu_torch.*"]))
    assert all(p.split(".")[0] == "vacmap_tpu_torch" for p in pkgs)
    reqs = [r.split(">")[0].split("=")[0].strip()
            for r in dist.install_requires]
    assert sorted(reqs) == ["numpy", "torch"]
    assert not any("jax" in r for r in dist.install_requires)
    assert not dist.extras_require
    scripts = sorted(dist.entry_points["console_scripts"])
    assert scripts == ["vacmap-tpu-torch = vacmap_tpu_torch.cli:main",
                       "vacsim-tpu-torch = vacmap_tpu_torch.sim.vacsim:main"]
    data = dist.package_data["vacmap_tpu_torch"]
    assert {"csrc/*.cu", "csrc/*.cuh", "native/*.cpp"} <= set(data)


def test_read_only_install_builds_under_the_cache(tmp_path):
    """A copy of the package where nothing may be written (no write bit,
    which binds root too) builds its host library under
    ${XDG_CACHE_HOME}/vacmap_tpu_torch/<hash of its sources> and loads
    it from there; this checkout keeps build/ beside the package."""
    import shutil

    site = tmp_path / "site"
    shutil.copytree(REPO / "vacmap_tpu_torch", site / "vacmap_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    paths = [site] + list(site.rglob("*"))
    for p in paths:
        p.chmod(0o555 if p.is_dir() else 0o444)
    env = dict(os.environ, XDG_CACHE_HOME=str(tmp_path / "cache"),
               PYTHONPATH=str(site), PYTHONDONTWRITEBYTECODE="1")
    env.pop("VACMAP_TPU_NATIVE_SO", None)
    code = ("import sys\nsys.modules['torch'] = None\n"
            "from vacmap_tpu_torch import _build, native\n"
            "assert native.available()\n"
            "print(_build.BUILD_DIR)\nprint(native._SO)\n")
    try:
        r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=240)
    finally:
        for p in paths:
            p.chmod(0o755 if p.is_dir() else 0o644)
    assert r.returncode == 0, r.stderr[-3000:]
    build_dir, so = (Path(x) for x in r.stdout.split())
    assert build_dir.parent == tmp_path / "cache" / "vacmap_tpu_torch"
    assert len(build_dir.name) == 16 and so.parent == build_dir
    assert so.exists()
    assert not (site / "build").exists()
    from vacmap_tpu_torch import _build

    assert _build.BUILD_DIR == REPO / "build" / "vacmap_tpu_torch"
