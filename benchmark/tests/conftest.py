"""Tests of the benchmark harness.  Tests that need a CUDA card carry the
``chip`` marker and skip here, deciding inside the ``cuda`` fixture:

    python3 -m pytest benchmark/tests -q            # CPU
    python3 -m pytest benchmark/tests -q -m chip    # on the card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on one")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
