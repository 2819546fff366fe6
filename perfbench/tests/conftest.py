"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` from
the repository root (the CPU tests; those marked ``cuda`` run on the card
and skip without one)."""

import os
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
