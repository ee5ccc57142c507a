import re

from setuptools import find_packages, setup

with open("README.md", encoding="utf-8") as f:
    long_description = f.read()

with open("pytorch_nmf_tpu/__init__.py", encoding="utf-8") as f:
    version = re.search(r'__version__ = "([^"]+)"', f.read()).group(1)

setup(
    name="pytorch_nmf_tpu",
    version=version,
    description=(
        "TPU-native non-negative matrix factorization: NMF/NMFD/NMF2D/NMF3D "
        "and PLCA/SIPLCA families with multiplicative-update and EM solvers, "
        "built on JAX/XLA/Pallas with first-class mesh sharding."
    ),
    long_description=long_description,
    long_description_content_type="text/markdown",
    packages=find_packages(exclude=("tests", "docs", "examples")),
    # pytorch_nmf_tpu_torch (the PyTorch/CUDA port) builds its kernels
    # from these sources with nvcc at first use
    package_data={
        "pytorch_nmf_tpu.native": ["*.cpp"],
        "pytorch_nmf_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "numpy",
    ],
    extras_require={
        "test": ["pytest"],
        "progress": ["tqdm"],
    },
    classifiers=[
        "Development Status :: 4 - Beta",
        "Intended Audience :: Science/Research",
        "License :: OSI Approved :: MIT License",
        "Programming Language :: Python :: 3",
        "Topic :: Scientific/Engineering :: Mathematics",
    ],
)
