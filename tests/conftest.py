"""Test harness configuration.

Tests run on CPU with 8 virtual XLA devices — the JAX idiom for validating
multi-device sharding without a cluster (SURVEY.md §4.3). Must run before
jax initializes its backends, hence the env mutation at import time.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# Force CPU even when a TPU plugin was pre-registered at interpreter startup
# (the driver env imports jax before conftest runs, freezing env config —
# the config update still works because backends initialize lazily).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    # Function-scoped: every test sees the same stream regardless of
    # execution order (a shared generator makes tolerances order-dependent).
    return np.random.default_rng(42)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips on a host without one")
