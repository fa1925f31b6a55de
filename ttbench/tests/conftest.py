"""The benchmark's own tests: ``python -m pytest -q ttbench/tests`` from
the root of the checkout (the ``cuda``-marked ones run on the card)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the CPU runs serve small shapes in real time: one thread keeps a busy
# host from stretching a step past the test's short window
torch.set_num_threads(1)


@pytest.fixture
def card():
    """The card, for the tests that need it; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
