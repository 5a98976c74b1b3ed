"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see the real
(single) CPU device; only launch/dryrun.py fakes 512 devices."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips on a machine without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
