"""Tests of the benchmark's harness. CPU tests run anywhere; tests marked
``card`` need a CUDA card and skip without one (decided inside the
``card`` fixture, never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")
    import torch

    # the tiny cells' windows are timed: one thread a test process keeps
    # parallel test workers from starving each other's windows
    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: `python -m pytest benchmarks/tests -m card` on a GPU machine")
    return torch.device("cuda", 0)
