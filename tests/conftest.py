"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see the real
1-device CPU (the 512-device override belongs to repro.launch.dryrun ONLY)."""
import jax
import numpy as np
import pytest


@pytest.fixture(scope="session", autouse=True)
def _x64_off():
    jax.config.update("jax_enable_x64", False)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running end-to-end tests")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where none is present")
