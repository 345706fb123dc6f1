import pathlib

import setuptools

setuptools.setup(
    name="rave_tpu",
    version=pathlib.Path("rave_tpu/version.py").read_text().split('"')[1],
    description="TPU-native realtime neural audio codec framework",
    long_description=pathlib.Path("README.md").read_text(),
    long_description_content_type="text/markdown",
    packages=setuptools.find_packages(
        include=["rave_tpu", "rave_tpu.*", "rave_tpu_torch", "rave_tpu_torch.*"]
    ),
    package_data={"rave_tpu_torch": ["csrc/*.cu"]},
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "einops",
        "numpy",
        "scipy",
        "pyyaml",
    ],
    entry_points={"console_scripts": ["rave-tpu = rave_tpu.cli:main"]},
    python_requires=">=3.10",
)
