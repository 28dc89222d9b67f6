"""apex_tpu packaging.

Mirrors the reference's two-tier install (setup.py feature flags,
SURVEY.md §1): a plain install is pure-Python-functional; the native runtime
(`apex_tpu/csrc`) is built lazily at first use with g++ (no build-time
extension needed), or ahead of time via ``python setup.py build_native``.
"""

import os
import subprocess

from setuptools import Command, find_packages, setup


class BuildNative(Command):
    description = "build the C++ runtime (.so) ahead of time"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        from apex_tpu import native
        native._load()
        print("native runtime available:", native.available)


setup(
    name="apex_tpu",
    version="0.1.0",
    description="TPU-native mixed-precision & distributed training framework "
                "(the capabilities of NVIDIA Apex, rebuilt on jax/XLA/Pallas)",
    packages=find_packages(include=["apex_tpu", "apex_tpu.*",
                                    "apex_tpu_torch", "apex_tpu_torch.*"]),
    package_data={"apex_tpu": ["csrc/*.cpp"],
                  "apex_tpu_torch": ["csrc/*.cu", "csrc/*.cpp"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "numpy"],
    cmdclass={"build_native": BuildNative},
)
