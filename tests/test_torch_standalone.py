"""vacmap_tpu_torch stands alone: no file of the port, nor the scripts
that drive it, imports ``vacmap_tpu``, ``jax`` or ``examples/``; its command line runs
with both unimportable; its native host library builds under ``build/``
and never touches the JAX package's."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "vacmap_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "profile_port.py", REPO / "probe_fill.py",
    REPO / "probe_myers.py"]
FORBIDDEN = ("vacmap_tpu", "jax", "jaxlib", "examples", "myers_pallas_device")


def _imports(path):
    """(line, module) of every import statement of one file, relative
    imports left out (they stay inside the port)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_import_of_the_jax_package(path):
    bad = [(line, mod) for line, mod in _imports(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)}: {bad}"
    # nor by name at run time (importlib, __import__, python -m)
    text = path.read_text()
    for needle in ('import_module("vacmap_tpu"', "import_module('vacmap_tpu'",
                   '"vacmap_tpu.cli"', "'vacmap_tpu.cli'", "import vacmap_tpu\n",
                   "import vacmap_tpu."):
        assert needle not in text, (path.relative_to(REPO), needle)


PORT_DIRS = sorted({p.parent for p in (REPO / "vacmap_tpu_torch").rglob("*.py")})


@pytest.mark.parametrize(
    "path", PORT_DIRS, ids=[str(p.relative_to(REPO)) for p in PORT_DIRS])
def test_every_port_directory_is_an_installed_package(path):
    """setup.py's find_packages returns every directory of the port that
    holds Python code, so an installed port imports what a checkout does."""
    from setuptools import find_packages

    found = find_packages(str(REPO), include=["vacmap_tpu_torch",
                                              "vacmap_tpu_torch.*"])
    assert ".".join(path.relative_to(REPO).parts) in found


def _blocked(code, cwd, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    pre = ("import sys\n"
           "sys.modules['vacmap_tpu'] = None\n"
           "sys.modules['jax'] = None\n")
    return subprocess.run([sys.executable, "-c", pre + code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    import numpy as np

    from tests.conftest import random_dna

    rng = np.random.default_rng(99)
    d = tmp_path_factory.mktemp("standalone")
    genome = random_dna(rng, 60_000)
    (d / "ref.fa").write_text(f">t1\n{genome}\n")
    (d / "reads.fa").write_text("".join(
        f">r{i}\n{genome[st:st + 4000]}\n"
        for i, st in enumerate((1000, 20_000, 41_000))))
    return d


@pytest.mark.parametrize("extra", [
    ["-mode", "H", "--backend", "jax"],
    ["-mode", "H", "-t", "2", "--device-fills", "on"],
    ["-mode", "H", "--backend", "numpy", "--device-fills", "off", "-t", "1"],
    ["-mode", "asm", "--backend", "jax"],
], ids=["executor", "fork_pool", "host", "asm"])
def test_cli_runs_with_the_jax_package_blocked(tiny, extra):
    out = tiny / f"out_{extra[1]}_{len(extra)}.sam"
    argv = ["-ref", str(tiny / "ref.fa"), "-read", str(tiny / "reads.fa"),
            "--nowriteindex", "--device", "cpu", "--force", "-o", str(out),
            *extra]
    r = _blocked("from vacmap_tpu_torch.cli import main\n"
                 f"raise SystemExit(main({argv!r}))\n", tiny)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = [l for l in out.read_text().splitlines() if not l.startswith("@")]
    assert {l.split("\t")[0] for l in recs} == {"r0", "r1", "r2"}
    assert all(l.split("\t")[2] == "t1" for l in recs)


def test_native_library_builds_under_build():
    """The port compiles its own copy of the C++ source into the ignored
    build directory, beside the kernels, and loads that one."""
    r = _blocked(
        "from vacmap_tpu_torch import native, _build\n"
        "assert native.available()\n"
        "print(native._SO)\n"
        "print(native._SRC)\n"
        "print(_build.BUILD_DIR)\n", REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    so, src, build_dir = (Path(x) for x in r.stdout.split())
    assert so.parent == build_dir == REPO / "build" / "vacmap_tpu_torch"
    assert so.exists()
    assert src == REPO / "vacmap_tpu_torch" / "native" / "vacmap_native.cpp"
    assert (REPO / "vacmap_tpu") not in so.parents
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
