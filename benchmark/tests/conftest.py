"""Tests of the benchmark harness, on the CPU at a tiny size.

A test that needs an NVIDIA card takes the `cuda` fixture, which skips it
here: the check for a card happens inside the fixture, when the test runs,
never while a module is imported. Run them with

    python -m pytest benchmark/tests -q

from the repository's root; on the card the marked ones run too.
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)
