"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding paths
are exercised without accelerator hardware (SURVEY.md section 4:
emulated-mesh testing).  Must run before jax is imported anywhere.

``AMG_TEST_PLATFORM`` selects another platform on purpose: the card-only
tests (``-m gpu``, tests/test_gpu.py) run with ``AMG_TEST_PLATFORM=cuda``.
"""

import os

# Force CPU regardless of the ambient JAX_PLATFORMS: the suite's numerics
# (golden residual histories) are pinned on CPU f64, and a machine-level
# JAX_PLATFORMS=cuda would silently route every test through one card.
os.environ["JAX_PLATFORMS"] = os.environ.get("AMG_TEST_PLATFORM", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# persistent XLA compile cache: the unrolled V-cycle programs are expensive
# to compile; cache them across test runs
import jax  # noqa: E402

from amg_tpu.compile_cache import enable as _enable_cache  # noqa: E402

_enable_cache()


DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="session")
def bus1138():
    import amg_tpu as amg

    return amg.read_mtx(os.path.join(DATA_DIR, "1138_bus.mtx"))


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
