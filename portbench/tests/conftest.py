"""Fixtures of the benchmark's own tests (``python -m pytest
portbench/tests`` from the repository's root)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# tiny sizes at which a CPU run of each cell takes about a second
SMALL = {
    "omniglot-5w5s-serve-b64": {
        "config": {"hidden": 16, "classes": 20},
        "traffic": {"batch": 4, "pool": 2, "keep_every": 1,
                    "check_requests": 4}},
    "omniglot-5w5s-train-fused": {
        "config": {"hidden": 16, "classes": 20},
        "traffic": {"meta_batch": 4, "chunk": 2, "task_batches": 16}},
    "particles2d-vpg-serve-b64": {
        "traffic": {"batch": 4, "episodes": 4, "horizon": 12, "pool": 2,
                    "keep_every": 1, "check_requests": 4}},
}


@pytest.fixture
def card():
    """Skips a test of the card where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); none here")
    return torch.device("cuda")
