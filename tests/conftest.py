"""Test configuration: JAX on a virtual 8-device CPU platform by default.

Multi-chip sharding is exercised on a simulated mesh
(xla_force_host_platform_device_count=8).  Tests that need an NVIDIA GPU
carry the ``gpu`` marker and take the ``gpu_device`` fixture, which skips
them when JAX finds no GPU; run them on a machine with a card with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax
import pytest

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture()
def gpu_device():
    """The first GPU, or skip: decided when the test runs, never at import."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu on a machine with a card)")
    return gpus[0]
