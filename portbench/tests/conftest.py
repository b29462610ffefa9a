"""Tests of the port's benchmark. Run from the repository root:

    python -m pytest portbench/tests -q

Tests marked ``card`` need a CUDA card and skip without one; on the card's
machine the same command runs them.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _card_or_skip(request):
    if request.node.get_closest_marker("card") is not None:
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")


@pytest.fixture
def small_cell():
    from small import small

    return small
