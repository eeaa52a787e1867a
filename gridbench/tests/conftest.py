"""Tests of the benchmark itself: ``python -m pytest gridbench/tests -q`` from
the root of the checkout. Tests that need the card take the ``card`` fixture
and carry the ``card`` marker; they skip on a machine without CUDA."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (an H100); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100); this machine has none")
