"""The benchmark's tests: the ``gpu`` marker and the tiny root."""

import pytest

from portbench.tests.tiny import write_tiny_root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def tiny_root(tmp_path):
    return write_tiny_root(tmp_path)
