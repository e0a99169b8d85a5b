"""Test configuration: CPU backend, 8 virtual devices, x64 golden precision.

Multi-device sharding tests follow SURVEY.md §4's recommendation: fake-device
CPU meshes via xla_force_host_platform_device_count, so halo-exchange and
shard_map logic is testable without an accelerator.

The platform is switched through jax.config before any backend is
initialized, so the suite runs on the CPU even where a GPU is present and
JAX_PLATFORMS is unset.  Tests that need the card carry the ``on_chip``
marker and skip through the ``on_chip`` fixture below.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# golden tests need x64 (complex128 references) and virtual devices
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def on_chip():
    """Skip unless a GPU backend is reachable.  This suite pins JAX to
    the CPU, so on-chip tests run through ``python chip_smoke.py`` on
    the card; the check happens here, at run time, never at import."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py on the card)")
    return gpus[0]
