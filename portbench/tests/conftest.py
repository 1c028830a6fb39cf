import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one (run on the "
        "card: python3 -m pytest -q -m chip portbench/tests)")


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, at the test, never at
    import time."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny_root(tmp_path):
    from portbench.tests.tiny import make_root
    return make_root(tmp_path)
