"""The benchmark's own tests: CPU tests at tiny sizes, and `cuda`-marked
tests that run on the card (they skip without one, decided in the `card`
fixture).  Run: ``python -m pytest benchmark/tests -q`` from the root of the
repository; on the card, ``python -m pytest benchmark/tests -q -m cuda``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
