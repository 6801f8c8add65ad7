"""Test config: run JAX on a virtual 9-device CPU mesh.

Sharded-code tests simulate N devices on the CPU backend via
--xla_force_host_platform_device_count (SURVEY.md §4(d)). Tests marked
``gpu`` need a card; they skip here and run on one with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    # 9 devices: ≥8 for the (gop=2, tile=4) mesh tests AND exactly 9 so the
    # n_tile=9 (one-MB-row band, hloc=1) tile-sharding case is exercised on
    # the QCIF (hmb=9) fixtures.
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=9"
    ).strip()

# the CPU backend unless JAX_PLATFORMS names another, set before any
# backend is initialized
import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))

import pathlib

import pytest

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: full conformance sweeps (run with -m slow; excluded by "
        "-m 'not slow')")
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skips on the CPU backend (run with -m gpu and "
        "JAX_PLATFORMS=cuda,cpu)")


@pytest.fixture(scope="session")
def fixtures_dir() -> pathlib.Path:
    return FIXTURES
