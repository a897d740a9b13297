"""The benchmark's own tests: CPU tests at a tiny size, and tests marked
``cuda`` that decide inside a fixture whether a card is present."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    """One thread a test process: the tests run in several processes at
    once, and torch's own threads would contend for the same cores."""
    import torch

    torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda", 0)
