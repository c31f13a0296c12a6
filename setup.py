"""Packaging for theanet_tpu (reference setup.py equivalent; deps are JAX
instead of numpy+Theano)."""

from setuptools import find_packages, setup

setup(
    name="theanet_tpu",
    version="0.1.0",
    description=(
        "JAX/XLA image-classification training framework "
        "with the capability surface of rakeshvar/theanet"
    ),
    packages=find_packages(include=["theanet_tpu", "theanet_tpu.*"]),
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    entry_points={
        "console_scripts": [
            "theanet-train = theanet_tpu.train:main",
        ]
    },
)
