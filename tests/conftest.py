"""Test harness configuration.

Tests run on CPU with 8 virtual XLA devices (SURVEY §4: multi-host behaviour
is validated via ``xla_force_host_platform_device_count`` without real
devices) and float64 enabled so numeric checks have full precision headroom.

Must run before the first ``import jax`` in any test module, hence the
environment mutation at import time here.
"""

import os

# Unit tests target the CPU backend; the GPU runs through chip_smoke.py and
# bench.py.  XLA_FLAGS must be in the environment before the first backend
# initialisation (lazy, so this import-time mutation is early enough); the
# platform is also pinned through jax.config in case jax was imported before
# this file set JAX_PLATFORMS.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from slam_tpu.io import synthetic  # noqa: E402


@pytest.fixture(scope="session")
def circle():
    """Small SE(2) loop fixture: (graph, ground_truth)."""
    return synthetic.circle_se2(n=64, seed=1)


@pytest.fixture(scope="session")
def circle_outliers(circle):
    graph, gt = circle
    return graph.add_random_outliers(10, seed=7), gt


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
