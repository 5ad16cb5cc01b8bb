"""Test configuration.

The suite runs on the CPU, on an 8-device virtual mesh so sharding tests
run anywhere.  Tests that need a GPU carry the `gpu` marker and take the
`gpu_device` fixture, which skips them where JAX finds no GPU;
`python -m pytest tests/ -m gpu` runs them on the accelerator JAX finds.
"""

import os
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    if config.getoption("markexpr") != "gpu":
        # Must be set before jax initializes its backends.  FORCE cpu,
        # with the env var AND jax.config.update: an installed
        # accelerator plugin must not take the platform from the suite.
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
    if not hasattr(config, "workerinput"):
        # the native cegs parser is built from cpp/, once per session and
        # before any xdist worker imports a test module: its tests and the
        # native cases of the format fixtures need the library
        r = subprocess.run(["make", "-C", os.path.join(REPO, "cpp")],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise pytest.UsageError(
                "make -C cpp failed:\n" + r.stdout + r.stderr)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev
