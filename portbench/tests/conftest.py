"""The benchmark's own tests: run them from the root of a checkout,
``python -m pytest -c /dev/null --rootdir . portbench/tests``; the tests
marked ``card`` run where a CUDA device is present and skip elsewhere."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (the H100); skips without one")


@pytest.fixture
def card():
    """The card, decided when the test runs (never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control runs in TF32, which only the card has")
    return torch.device("cuda:0")
