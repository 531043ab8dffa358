from setuptools import setup, find_packages

setup(
    name="vacmap-tpu",
    version="0.1.0",
    description="TPU-native long-read aligner for structural variation discovery",
    packages=find_packages(include=["vacmap_tpu", "vacmap_tpu.*",
                                    "vacmap_tpu_torch", "vacmap_tpu_torch.*"]),
    package_data={"vacmap_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    extras_require={"torch": ["torch"]},
    entry_points={
        "console_scripts": [
            "vacmap-tpu = vacmap_tpu.cli:main",
            "vacsim-tpu = vacmap_tpu.sim.vacsim:main",
            "vacmap-tpu-torch = vacmap_tpu_torch.cli:main",
        ]
    },
)
