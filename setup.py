"""Package metadata for mmt_tpu and its PyTorch/CUDA port mmt_tpu_torch."""

from setuptools import find_packages, setup

setup(
    name="mmt_tpu",
    version="0.1.0",
    description=("TPU-native multi-modal transformer framework for "
                 "video-text retrieval, with a PyTorch/CUDA port"),
    packages=find_packages(include=["mmt_tpu", "mmt_tpu.*",
                                    "mmt_tpu_torch", "mmt_tpu_torch.*"]),
    package_data={"mmt_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                     "native/*.cc"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "h5py"],
    extras_require={"test": ["pytest", "scipy", "torch", "transformers"],
                    "torch": ["torch", "numpy", "scipy"]},
)
