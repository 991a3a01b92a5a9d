"""The benchmark's tests: CPU rehearsals at 32x32 with the port's plain
versions, and tests marked ``card`` that need an NVIDIA card (they skip
here, decided inside the ``card`` fixture)."""

from __future__ import annotations

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs on the H100)")


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
