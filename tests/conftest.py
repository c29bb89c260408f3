"""Test configuration.

The tests run on JAX's CPU backend (unless JAX_PLATFORMS names another
platform) with 8 virtual CPU devices, so the sharding tests have a device
mesh and Pallas kernels run in interpret mode.

Tests marked `gpu` need an NVIDIA card: they take the `gpu_device` fixture,
which skips them when JAX has no GPU.  On a machine with a card run them
with `JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`;
`python chip_smoke.py` covers the same ground.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (JAX finds none)")
