"""The benchmark's own tests. Tests that need the card carry the `card`
marker and take the `card` fixture, which skips them where no CUDA card
is present (decided when the test runs, never at import)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped "
                                       "without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda")
