"""The benchmark's own tests (``python -m pytest benchmark/tests``): the
harness and the reference on the CPU at small sizes; tests marked ``cuda``
run only on the card."""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 and the CUDA kernels exist only on the card")
