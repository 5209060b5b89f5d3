"""The benchmark's own tests: ``python3 -m pytest -q portbench/tests`` from
the root of the checkout (``-m gpu`` on a card).  They are not part of the
repository's test suite (``tests/``)."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
