"""Test configuration: run JAX on CPU with 8 virtual devices.

The tests pin JAX to the CPU (even on a machine with a GPU) before any
backend is initialized, and give XLA's CPU backend 8 virtual devices so the
multi-device sharding paths run on a virtual mesh (SURVEY.md section 4).

Tests marked ``gpu`` need the card and skip elsewhere; on a machine with a
GPU run them with ``RII_TEST_GPU=1 python -m pytest -m gpu tests/``, which
leaves JAX on its default platform.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("RII_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with RII_TEST_GPU=1 on the card)")
    return jax.devices()[0]
