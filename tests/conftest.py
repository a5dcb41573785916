"""Test harness bootstrap.

The suite runs on the CPU with 8 virtual devices, so the multi-device
sharding logic is exercised without a card (SURVEY.md §4). Both settings
are made here, before any test module imports JAX; ``JAX_PLATFORMS``
is only a default, so ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/`` runs the tests marked ``gpu`` on a card.
"""

import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cpu_devices():
    import jax

    devs = jax.devices("cpu")
    assert len(devs) >= 8, f"expected 8 virtual CPU devices, got {devs}"
    return devs


@pytest.fixture(scope="session")
def gpu():
    """The first device, when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
