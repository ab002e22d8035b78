"""Install: pip install -e .  (also builds the native C++ extension if a
compiler is available; the package falls back to the numpy builder without
it)."""

from setuptools import find_packages, setup

setup(
    name="lime-tpu",
    version="0.1.0",
    description="TPU-native alignment-free metagenomic read classification",
    packages=find_packages(exclude=("tests",)),
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    entry_points={
        "console_scripts": [
            "lime-tpu = lime_tpu.cli:main",
            "lime-tpu-torch = lime_tpu_torch.cli:main",
        ],
    },
)
