"""The harness's own tests.  Run from the root of the checkout:

    python -m pytest portbench/tests -q

They run on the CPU through the kernels' plain versions, at tiny sizes.
Tests marked ``card`` run at the cells' own sizes and need a CUDA card;
they skip without one.
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells at a size a CPU test holds
TINY = {"tpch.q3": {"scale_factor": 0.01},
        "terasort.100b": {"records": 10_000}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
