"""The benchmark's own tests: the harness at tiny sizes on the CPU (the
card's tests carry the `cuda` marker and skip without a card).

    python -m pytest benchmark/tests -q

No JAX here: the harness and the reference must load none of it.
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)
