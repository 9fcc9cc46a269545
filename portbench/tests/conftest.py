"""The benchmark's own tests.  CPU tests run the harness at tiny sizes on
the port's plain versions; tests marked `cuda` run on the card and skip
without one (decided inside the `card` fixture)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")
