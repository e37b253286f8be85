"""Test set-up of the benchmark's own tests: the checkout's root on the
import path, the CPU at one thread, and the ``cuda`` fixture that skips a
card-only test where there is no card.

    python -m pytest port_bench/tests             # the CPU tests
    python -m pytest port_bench/tests -m gpu      # on the card
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
