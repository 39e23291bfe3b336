"""Test configuration: CPU with an 8-device virtual mesh and x64.

Sharding-invariance and multi-device tests run on a fake mesh via
xla_force_host_platform_device_count, per the build plan (SURVEY.md §4).
The platform is forced to CPU unless JAX_PLATFORMS names another one: the
GPU-marked tests (tests/test_gpu.py) run on the card with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py`, in f32.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is an NVIDIA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu "
            "python -m pytest -m gpu tests/test_gpu.py"
        )
