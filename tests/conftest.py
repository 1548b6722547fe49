import os

import numpy as np
import pytest

# NOTE: no XLA_FLAGS here — smoke tests and benches must see 1 device.
# Multi-device tests spawn subprocesses that set
# --xla_force_host_platform_device_count themselves.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skipped where there is none")


@pytest.fixture
def tmp_ckpt_dir(tmp_path):
    return str(tmp_path / "ckpt")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
