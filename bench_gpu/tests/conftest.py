"""The benchmark's own tests: run them from the repository's root with
``python -m pytest bench_gpu/tests -q``. Tests marked ``card`` need an
NVIDIA card and skip without one (the ``card`` fixture decides)."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parents[1]), str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda:0")
