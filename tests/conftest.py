"""Test configuration: the CPU backend with 8 virtual devices, so the
multi-device sharding and partition tests run without a GPU.

Tests marked `gpu` need a CUDA card; the `gpu_backend` fixture skips them
elsewhere (decided when the test runs, never at import or collection)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(42)


@pytest.fixture
def gpu_backend():
    """Skip unless JAX runs on a GPU (the suite pins the CPU; run the
    `gpu` tests on a card with `python chip_smoke.py`, which makes the
    same checks)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU backend")
