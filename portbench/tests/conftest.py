"""Shared set-up of the benchmark's tests: the checkout and the port's
sources on the path, and the fixture that skips a card-only test here."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (CHECKOUT / "src", CHECKOUT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def cuda_card():
    """Skips unless a CUDA card is present; decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
