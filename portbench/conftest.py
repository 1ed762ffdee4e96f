"""Pytest settings of the benchmark's own tests (``python -m pytest portbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which decides at run time and skips without one.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips on a host without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own size on the H100")
    return torch.device("cuda")
