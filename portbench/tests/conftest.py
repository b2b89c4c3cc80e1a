"""The benchmark's own tests.  Run them from the root of the checkout:

    python -m pytest portbench/tests -q -o addopts=""

The tests marked `cuda` need the card and skip here; on the card the same
command runs them.  The rest run on the CPU at small sizes.
"""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    """Skip the test where there is no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
