"""Shared fixtures of the benchmark's tests: the repository root on the
path, and ``card``, which skips a test marked ``gpu`` where there is no
CUDA card (decided when the test runs, never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")
