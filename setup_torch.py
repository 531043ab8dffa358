"""Packaging of the PyTorch and CUDA port alone, without jax and without
the JAX package (``setup.py`` installs both packages and requires jax).

    python setup_torch.py bdist_wheel
    pip install --no-deps dist/vacmap_tpu_torch-*.whl

installs ``vacmap_tpu_torch`` (with its CUDA and C++ sources, which it
builds at first use) and the ``vacmap-tpu-torch`` and
``vacsim-tpu-torch`` commands.  It needs numpy and torch; a deployment
that launches no kernel (the host path, asm on the host, the simulator)
never imports torch.
"""

from setuptools import find_packages, setup

setup(
    name="vacmap-tpu-torch",
    version="0.1.0",
    description="vacmap-tpu on PyTorch and CUDA: long-read aligner for "
                "structural variation discovery",
    packages=find_packages(include=["vacmap_tpu_torch", "vacmap_tpu_torch.*"]),
    package_data={"vacmap_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                      "native/*.cpp"]},
    python_requires=">=3.10",
    install_requires=["numpy", "torch"],
    entry_points={
        "console_scripts": [
            "vacmap-tpu-torch = vacmap_tpu_torch.cli:main",
            "vacsim-tpu-torch = vacmap_tpu_torch.sim.vacsim:main",
        ]
    },
)
