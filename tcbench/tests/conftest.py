"""Test settings of the benchmark's own tests (imports no JAX).

Tests that need a CUDA card carry the ``card`` marker and take the
``cuda_card`` fixture, which skips them where no card is present; whether
a card is present is decided inside the fixture, never at import.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA card (skips with a reason elsewhere)')


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')
