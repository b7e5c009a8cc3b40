"""Test configuration: run the suite on a virtual 8-device CPU mesh in f64.

``jax.config.update`` pins the CPU even where JAX would default to a GPU,
as long as no backend has been instantiated yet.  Tests run on CPU with 8
virtual devices so sharding tests work without hardware (SURVEY.md §4.5).
Tests that need the card carry the ``gpu`` marker and skip here; their
checks run as phases of ``chip_smoke.py`` on the GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none (decided at run
    time, never at import, so every worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")
    return dev
