"""Test configuration: force CPU with 8 virtual devices + float64 support.

Multi-device behavior is tested without a GPU cluster by overriding the
host platform device count (SURVEY.md section 4 item 6).

Tests that need a GPU carry the `gpu` marker and skip elsewhere; the
`gpu_only` fixture decides at run time, never at import.  They run on a
card with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`; every other
setting of JAX_PLATFORMS keeps the suite on the CPU.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS") != "cuda":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture
def gpu_only():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda "
                    "-m gpu on the card)")


@pytest.fixture(scope="session")
def devices():
    devs = jax.devices()
    assert len(devs) >= 8, f"expected >= 8 virtual CPU devices, got {len(devs)}"
    return devs
