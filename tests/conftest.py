"""Test harness config: force CPU with 8 virtual devices (SURVEY.md §5).

The suite runs on the CPU: the XLA flag for 8 virtual CPU devices must be
set before backends initialize, and the platform is pinned to cpu both in
the environment and through jax.config. Kernels run in the Pallas
interpreter here.

Checks that need the compiled kernel on a GPU carry the ``gpu`` marker and
take the ``gpu_device`` fixture, which skips them here; on the card they
run as phases of ``python chip_smoke.py``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs the compiled kernel on a GPU (skips on the CPU; "
        "chip_smoke.py runs these checks on the card)",
    )


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when the suite runs without one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")
    return dev
